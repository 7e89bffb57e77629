// Helpers shared by the port's CUDA kernels: fp32 <-> storage-type
// conversion, 16-byte vector loads and stores, raw vectors held in
// registers, warp sums and row-group barriers, cp.async copies, paper
// Kernel 1's LSE merge math, the dispatch of run-time genome flags to
// template instantiations, and the split-KV walk of the two
// decode-attention kernels (namespace repro::decode).
//
// Every kernel computes in fp32 and stores in the tensor's own type
// (float or __nv_bfloat16). Dtype codes passed across the C interface:
// 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a dtype cast
}

// v rounded to T and widened back: one operation "in T" when the math is
// done in fp32 and every result is rounded, as T arithmetic does.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Calls f(std::true_type{}) or f(std::false_type{}): a run-time genome
// flag picks one of the kernel's template instantiations, so every
// combination is compiled into the one library.
template <typename F>
inline int with_bool(bool b, F&& f) {
  return b ? f(std::true_type{}) : f(std::false_type{});
}

// One 16-byte load of N = 16 / sizeof(T) elements, widened to fp32. The
// caller guarantees 16-byte alignment of p.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  static_assert(sizeof(T) * N == 16, "one 16-byte vector");
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = to_f(e[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  static_assert(sizeof(T) * N == 16, "one 16-byte vector");
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) e[k] = from_f<T>(in[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum of v over the warp, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Barrier `id` (0..15) over the first n threads that reach it (n a
// multiple of 32): a row group of a block waits for its own warps only.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// --- VEC elements of E held raw in 32-bit registers ---------------------

// A vector's raw bits: loaded in one access (16 bytes, or one element),
// widened to fp32 element by element where it is used.
template <typename E, int VEC>
struct Raw {
  static constexpr int kBytes = VEC * static_cast<int>(sizeof(E));
  static constexpr int kWords = (kBytes + 3) / 4;
  alignas(16) uint32_t w[kWords];

  __device__ __forceinline__ float operator[](int k) const {
    return to_f(reinterpret_cast<const E*>(w)[k]);
  }
};

// Load VEC elements at p: 16-byte accesses (p 16-byte aligned) when they
// fill a multiple of 16 bytes, else one element.
template <typename E, int VEC>
__device__ __forceinline__ void load_raw(const E* p, Raw<E, VEC>& r) {
  if constexpr (Raw<E, VEC>::kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < Raw<E, VEC>::kBytes / 16; ++i) {
      reinterpret_cast<uint4*>(r.w)[i] = reinterpret_cast<const uint4*>(p)[i];
    }
  } else {
    static_assert(VEC == 1, "a vector is 16 bytes or one element");
    *reinterpret_cast<E*>(r.w) = *p;
  }
}

// --- 16-byte asynchronous copies (cp.async), global -> shared ------------

// Queue a copy of 16 bytes from src, or (valid false) 16 zero bytes with
// nothing read from src; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src,
                                                   bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- paper Kernel 1's LSE merge math ---------------------------------------

// The reference point of two or more partial states: their largest score
// m, or 0 when m is -inf (every part empty), so no e^{-inf - -inf} appears.
__device__ __forceinline__ float lse_ref(float m) {
  return m == -INFINITY ? 0.f : m;
}

struct Weights {
  float a, b;
};

// Normalised weights of two partial states with scores sa and sb (log-sum-
// exp of their softmax); both 0 when their sum is 0.
template <bool RCP>
__device__ __forceinline__ Weights lse_weights(float sa, float sb) {
  const float m_safe = lse_ref(fmaxf(sa, sb));
  const float wa = expf(sa - m_safe);
  const float wb = expf(sb - m_safe);
  const float denom = wa + wb;
  if (!(denom > 0.f)) return {0.f, 0.f};
  if constexpr (RCP) {
    const float inv = __frcp_rn(denom);
    return {wa * inv, wb * inv};
  } else {
    return {wa / denom, wb / denom};
  }
}

// The merged score log(e^{sa} + e^{sb}); -inf when both are.
__device__ __forceinline__ float lse_score(float sa, float sb) {
  const float m = fmaxf(sa, sb);
  const float m_safe = lse_ref(m);
  return m + logf(expf(sa - m_safe) + expf(sb - m_safe));
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// default 48 KB. Returns the CUDA error code (0 on success).
template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// --- split-KV decode attention ----------------------------------------------
//
// The walk shared by flash_decode.cu (a contiguous cache) and
// paged_decode.cu (a paged pool); the kernel files differ only in how a
// row of a head is found (a `Rows` policy) and in what bounds the walk.
//
//   q [b, hq, d]; out [b, hq, d]; one head's K and V rows, found by
//   Rows::off(t) (elements from the head's first row); kv_len [b] int32.
//   Rows at or past kv_len score -1e30; out = acc / l, or 0 where l = 0.
//
// Grid (hkv * n_qsub, b, splits), kThreads threads. A block serves up to
// kGroup queries of one kv head (a larger group is split over n_qsub
// blocks) and a contiguous range of whole steps of `step` rows: a split.
// Each warp owns its share of every step (step / kWarps rows) and walks it
// with its own fp32 carry (m, l, acc), so no block barrier falls inside the
// walk. A warp stages its share of a step in its own ring of kStages slots
// with 16-byte cp.async copies (rows it does not load are zero-filled), so
// the copies of two steps are in flight while it scores a third; the
// CUDA-core walk takes a ring of one slot where kStages do not fit 227 KB
// (fp32 at head_dim 256), and the copy of a step then lands before it is
// scored. It scores 16 rows at once:
//   bf16 with 16-byte rows (mma_walk): both products on the tensor cores,
//     mma.sync.m16n8k16 with the query group as the M = 16 rows (zero
//     padded), q.K^T from ldmatrix'd K and p.V from ldmatrix.trans'd V,
//     p rounded to bf16 for the second product (fp32 accumulators);
//   else (fma_walk): two lanes a row, each summing half of the row's
//     16-byte units against the fp32 queries, then lanes split as (row
//     class, unit) fold p * V into registers.
// The online-softmax update between the products runs on shuffles.
//
// At the end the warps' states merge in shared memory. Under MASK_OOB the
// splits wholly past kv_len leave at once: every block counts the live
// splits from kv_len itself, so the launch shape never depends on it. With
// one live split the block writes out; otherwise each live block writes
// its state (acc, m, l) to fp32 scratch, and the last to finish -- an
// int32 counter bumped after a release fence says which -- merges them
// with Kernel 1's weights (w_i = l_i e^{m_i - M_safe}, M the largest m_i,
// M_safe = 0 when M = -inf) and resets the counter. One launch a call.
//
// (m, l) is carried, not lse = m + log l: every score -1e30 (kv_len 0
// without MASK_OOB) would round m + log l back to -1e30 and lose each
// split's row count, which sets its weight in the mean of V that the
// Pallas baseline returns there.
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;        // a SM, by the launch bounds
constexpr int kStages = 3;           // slots of a warp's ring (or 1)
constexpr int kGroup = 8;            // queries a block serves at most
constexpr int kSub = 16;             // rows a warp scores at once
constexpr float kNegInf = -1e30f;    // finite -inf of the Pallas kernels
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

struct Args {
  const void* q;
  void* out;
  const int* kv_len;
  float* part_acc;   // [b, hq, splits, d] fp32 (splits > 1)
  float* part_ml;    // [b, hq, splits, 2] fp32 (m, l)
  int* counters;     // [b, hkv * n_qsub] int32, 0 between launches
  int hq, hkv, d;
  int lds;           // row stride of a staged tile, in elements
  int step;          // rows of a step
  int rows_total;    // rows the walk spans: a multiple of a chunk or page
  int load_cap;      // rows in memory: s, or the table's rows
  int splits, steps_per_split;
  int extra_bytes;   // shared memory a Rows policy takes
  float scale;
  int stages;        // slots of a warp's ring: kStages, or 1 (ring_stages)
};

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Rows of a warp's share of a step, and the rows a slot holds: the share
// rounded up to the 16 rows a warp scores at once (zero-filled past it).
__host__ __device__ inline int share_rows(int step) {
  return (step + kWarps - 1) / kWarps;
}
__host__ __device__ inline int slot_rows(int step) {
  return (share_rows(step) + kSub - 1) / kSub * kSub;
}

// fp32 words in front of the Rows policy: the query group, then the
// warps' (m, l), their merge weights, each query's max and sum, a flag
constexpr int kHeadWords = 2 * kWarps * kGroup + kWarps * kGroup +
                           2 * kGroup + 4;

__host__ __device__ inline size_t head_bytes(int gm, int d) {
  return round16(4 * (static_cast<size_t>(gm) * d + kHeadWords));
}

// Shared memory of a block with rings of `stages` slots: the query group,
// the warps' (m, l) and merge weights in fp32, and a flag; the Rows
// policy's own bytes; then the warps' rings, which the merge of the warps'
// accumulators reuses.
__host__ __device__ inline size_t layout_bytes(int group, int d, int step,
                                               int lds, int itemsize,
                                               int extra_bytes, int stages) {
  const int gm = group < kGroup ? group : kGroup;
  const size_t ring = static_cast<size_t>(kWarps) * stages * 2 *
                      slot_rows(step) * lds * itemsize;
  const size_t merge = static_cast<size_t>(kWarps) * gm * d * 4;
  return head_bytes(gm, d) + round16(extra_bytes) +
         (ring > merge ? ring : merge);
}

// Slots of a warp's ring: kStages, except on the CUDA-core walk (`mma`
// false) at a width where kStages slots of the narrowest tile (16 rows a
// warp) do not fit 227 KB: one slot there (fp32 at head_dim 256 needs
// 399,360 bytes for three). The width alone decides, not the step, so
// every layout that fitted three slots keeps them.
__host__ __device__ inline int ring_stages(bool mma, int group, int d,
                                           int lds, int itemsize,
                                           int extra_bytes) {
  if (mma) return kStages;
  return layout_bytes(group, d, kWarps * kSub, lds, itemsize, extra_bytes,
                      kStages) <= kMaxSmem
             ? kStages
             : 1;
}

// Shared memory of a block, its rings sized by ring_stages. The wrapper
// plans with its own copy (flash_decode.py: tile_layout) and passes its
// figure; the launchers refuse one that differs from this.
__host__ __device__ inline size_t smem_bytes(bool mma, int group, int d,
                                             int step, int lds, int itemsize,
                                             int extra_bytes) {
  return layout_bytes(group, d, step, lds, itemsize, extra_bytes,
                      ring_stages(mma, group, d, lds, itemsize, extra_bytes));
}

// Whether a (dtype, vector width) runs the tensor-core walk.
template <typename T, int VEC>
constexpr bool kMmaWalk = std::is_same<T, __nv_bfloat16>::value && VEC == 8;

// The DMAX instantiation that takes head_dim d: 128 for a narrow bf16
// head on the tensor cores, else 256.
template <typename T, int VEC, typename F>
inline int with_dmax(int d, F&& f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC == 8) {
    if (d <= 128) return f(std::integral_constant<int, 128>{});
  }
  return f(std::integral_constant<int, 256>{});
}

// An acquire-release fence at GPU scope (lighter than __threadfence()'s
// sequentially consistent one).
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

template <bool RCP>
__device__ __forceinline__ float finish(float acc, float l) {
  if (!(l > 0.f)) return 0.f;
  if constexpr (RCP) {
    return acc * __frcp_rn(l);
  } else {
    return acc / l;
  }
}

struct Coords {
  int h, qsub, b, split, group, g0, n;  // n: queries of this block
};

__device__ __forceinline__ Coords coords(const Args& a) {
  Coords c;
  c.group = a.hq / a.hkv;
  const int n_qsub = (c.group + kGroup - 1) / kGroup;
  c.h = blockIdx.x / n_qsub;
  c.qsub = blockIdx.x - c.h * n_qsub;
  c.b = blockIdx.y;
  c.split = blockIdx.z;
  c.g0 = c.qsub * kGroup;
  c.n = min(kGroup, c.group - c.g0);
  return c;
}

// The block's steps [first, last), as a Rows policy's load() sees them.
struct Span {
  int first, last;
};

// What both walks need of the block.
struct Walk {
  int d, G, len, present_end, load_end, st_begin, st_end;
  long long q_off;   // element offset of the block's first query
  float scale;
};

// A warp's ring of S slots and its share of each step.
template <typename T, int S>
struct Ring {
  T* base;
  int step, share, r_lo, r_n, rows, lds;
  size_t slot;       // elements of a slot: K then V, `rows` rows each

  __device__ __forceinline__ Ring(T* ring, int step_, int lds_, int warp)
      : step(step_), share(share_rows(step_)), lds(lds_) {
    rows = slot_rows(step);
    r_lo = warp * share;
    r_n = max(0, min(step, r_lo + share) - r_lo);
    slot = static_cast<size_t>(2) * rows * lds;
    base = ring + static_cast<size_t>(warp) * S * slot;
  }
  __device__ __forceinline__ T* k(int st) const {
    return base + (st % S) * slot;
  }
  __device__ __forceinline__ T* v(int st) const {
    return k(st) + static_cast<size_t>(rows) * lds;
  }
};

// Queue this lane's copies of the warp's share of step st: rows at or
// past load_end, and slot rows past the share, are zero-filled.
template <typename T, int VEC, int S, typename Rows>
__device__ __forceinline__ void stage(const Ring<T, S>& ring, const Rows& rows,
                                      int st, int load_end, int U,
                                      int lane) {
  T* ks = ring.k(st);
  T* vs = ring.v(st);
  const int t0 = st * ring.step + ring.r_lo;
  const int dr = 32 / U, dj = 32 - (32 / U) * U;
  int r = lane / U, j = lane - (lane / U) * U;
  const int n_it = (ring.rows * U - lane + 31) / 32;
#pragma unroll 4
  for (int it = 0; it < n_it; ++it) {
    const int t = t0 + r;
    const bool ok = r < ring.r_n && t < load_end;
    const long long o = ok ? rows.off(t) + j * VEC : 0;
    T* kd = ks + r * ring.lds + j * VEC;
    T* vd = vs + r * ring.lds + j * VEC;
    if constexpr (VEC > 1) {
      cp_async16_or_zero(kd, rows.k + o, ok);
      cp_async16_or_zero(vd, rows.v + o, ok);
    } else {
      *kd = ok ? rows.k[o] : from_f<T>(0.f);
      *vd = ok ? rows.v[o] : from_f<T>(0.f);
    }
    j += dj;
    r += dr;
    if (j >= U) {
      j -= U;
      ++r;
    }
  }
}

// The ring's pipeline: the copies of the block's first S - 1 steps...
template <typename T, int VEC, int S, typename Rows>
__device__ __forceinline__ void prefetch(const Walk& w,
                                         const Ring<T, S>& ring,
                                         const Rows& rows, int lane) {
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (w.st_begin + i < w.st_end) {
      stage<T, VEC>(ring, rows, w.st_begin + i, w.load_end, w.d / VEC, lane);
    }
    cp_async_commit();
  }
}

// ... then, before step st is scored, the copy of step st + S - 1 queued
// and step st's own landed for every lane of the warp.
template <typename T, int VEC, int S, typename Rows>
__device__ __forceinline__ void advance(const Walk& w, const Ring<T, S>& ring,
                                        const Rows& rows, int lane, int st) {
  if (st + S - 1 < w.st_end) {
    stage<T, VEC>(ring, rows, st + S - 1, w.load_end, w.d / VEC, lane);
  }
  cp_async_commit();
  cp_async_wait<S - 1>();  // this lane's copies of step st landed
  __syncwarp();            // ... and every lane's
}

// Row t of sub-step r0 of step st: the score it gets (scaled, -1e30 past
// kv_len, -inf outside the walk so that p = 0).
__device__ __forceinline__ float mask_score(float x, int r, int t,
                                            int r_n, const Walk& w) {
  if (r >= r_n || t >= w.present_end) return -INFINITY;
  return t < w.len ? x * w.scale : kNegInf;
}

// The fp32 path: any dtype, any head_dim; lanes on the CUDA cores; a ring
// of S slots.
template <typename T, int VEC, int S, typename Rows>
__device__ __forceinline__ void fma_walk(const Walk& w, const Rows& rows,
                                         T* ring_mem, int lds, int step,
                                         float* qs, float* mrg, float* ml) {
  constexpr int kAcc = 8;          // fp32 accumulators a lane keeps a query
  constexpr int kNV = kAcc / VEC;  // units of a V row a lane owns at most
  const int d = w.d, G = w.G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int U = d / VEC;                 // units (16 bytes, or 1 element)
  const int UL = min(U, 32);             // lanes across a V row
  const int C = 32 / UL;                 // row classes of the p.V lanes
  const int cls = lane / UL;
  const int jj = lane - cls * UL;

  float m[kGroup], l[kGroup], acc[kGroup][kAcc];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[g][e] = 0.f;
  }
  if (w.st_begin < w.st_end) {
    const Ring<T, S> ring(ring_mem, step, lds, warp);
    const int rho = lane & 15;           // the row of a 16 this lane scores
    const int uh = (U + 1) / 2;          // ... over units [j_lo, j_hi)
    const int j_lo = (lane >> 4) * uh;
    const int j_hi = min(U, j_lo + uh);
    const int n_iter = (kSub + C - 1) / C;
    prefetch<T, VEC>(w, ring, rows, lane);
    for (int st = w.st_begin; st < w.st_end; ++st) {
      advance<T, VEC>(w, ring, rows, lane, st);
      const T* ks = ring.k(st);
      const T* vs = ring.v(st);
      const int t0 = st * step + ring.r_lo;
      for (int r0 = 0; r0 < ring.r_n && t0 + r0 < w.present_end;
           r0 += kSub) {
        const int r = r0 + rho;
        float sc[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) sc[g] = 0.f;
        if (r < ring.r_n) {
          const T* kr = ks + r * lds;
          for (int j = j_lo; j < j_hi; ++j) {
            float kk[VEC];
            if constexpr (VEC > 1) {
              load_vec<T, VEC>(kr + j * VEC, kk);
            } else {
              kk[0] = to_f(kr[j]);
            }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              if (g < G) {
                const float* qg = qs + g * d + j * VEC;
                float qq[VEC];
                if constexpr (VEC % 4 == 0) {
#pragma unroll
                  for (int e = 0; e < VEC; e += 4) {
                    *reinterpret_cast<float4*>(qq + e) =
                        *reinterpret_cast<const float4*>(qg + e);
                  }
                } else {
                  qq[0] = qg[0];
                }
#pragma unroll
                for (int e = 0; e < VEC; ++e) sc[g] = fmaf(qq[e], kk[e], sc[g]);
              }
            }
          }
        }
        // the two halves of each row, then the online-softmax update
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (g < G) {
            const float x = mask_score(
                sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 16), r, t0 + r,
                ring.r_n, w);
            float mc = x;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
              mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
            const float mn = fmaxf(m[g], mc);
            const float p = expf(x - mn);
            float sum = p;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
            const float alpha = expf(m[g] - mn);
            l[g] = alpha * l[g] + sum;
            m[g] = mn;
            sc[g] = p;
#pragma unroll
            for (int e = 0; e < kAcc; ++e) acc[g][e] *= alpha;
          }
        }
        // p.V: the lanes of class cls take rows cls, cls + C, ... of the 16
        for (int i = 0; i < n_iter; ++i) {
          const int rr = cls + i * C;
          float pg[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g < G) pg[g] = __shfl_sync(0xffffffffu, sc[g], rr & 15);
          }
          if (cls < C && rr < kSub && r0 + rr < ring.r_n) {
            const T* vr = vs + (r0 + rr) * lds;
#pragma unroll
            for (int k = 0; k < kNV; ++k) {
              const int jv = jj + k * UL;
              if (jv < U) {
                float vv[VEC];
                if constexpr (VEC > 1) {
                  load_vec<T, VEC>(vr + jv * VEC, vv);
                } else {
                  vv[0] = to_f(vr[jv]);
                }
#pragma unroll
                for (int g = 0; g < kGroup; ++g) {
                  if (g < G) {
#pragma unroll
                    for (int e = 0; e < VEC; ++e) {
                      acc[g][k * VEC + e] =
                          fmaf(pg[g], vv[e], acc[g][k * VEC + e]);
                    }
                  }
                }
              }
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot before it refills
    }
    cp_async_wait<0>();
  }
  // the row classes of a warp share (m, l): class 0 adds the others'
  // accumulators (each read as it was; lanes of class 0 read in range)
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const float own = acc[g][e];
        for (int cc = 1; cc < C; ++cc) {
          acc[g][e] += __shfl_sync(0xffffffffu, own, lane + cc * UL);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the rings: mrg reuses them
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < G) {
        ml[(warp * kGroup + g) * 2] = m[g];
        ml[(warp * kGroup + g) * 2 + 1] = l[g];
      }
    }
  }
  if (cls == 0) {
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int jv = jj + k * UL;
      if (jv < U) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              mrg[(warp * G + g) * d + jv * VEC + e] = acc[g][k * VEC + e];
            }
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p,
                                        bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// d += A.B for one m16n8k16 bf16 tile; A's rows 8..15 (a1, a3) are zero
// (the query group is padded), and so are the c2, c3 they feed.
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  float d2 = 0.f, d3 = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 tensor-core path: 16-byte rows (d a multiple of 8, at most
// DMAX: 128 or 256, each its own kernel, so that the fragments of a narrow
// head fit registers).
// Lane (quad, qi) = (lane / 4, lane % 4) holds query `quad`'s scores for
// rows 2 qi, 2 qi + 1 of each 8, and its accumulators for elements
// 2 qi, 2 qi + 1 of each 8.
template <int DMAX, typename Rows>
__device__ __forceinline__ void mma_walk(const Walk& w, const Rows& rows,
                                         __nv_bfloat16* ring_mem, int lds,
                                         int step, const __nv_bfloat16* q,
                                         float* mrg, float* ml) {
  using T = __nv_bfloat16;
  constexpr int kKT = DMAX / 16;   // k-tiles of 16 at most
  constexpr int kET = DMAX / 8;    // e-tiles of 8 at most
  const int d = w.d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane >> 2, qi = lane & 3;
  const int KT = (d + 15) / 16, ET = d / 8;
  float m = kNegInf, l = 0.f;
  float o[kET][2];
#pragma unroll
  for (int et = 0; et < kET; ++et) o[et][0] = o[et][1] = 0.f;

  if (w.st_begin < w.st_end) {
    // A fragments of q (rows = queries, zero past the group), from memory
    uint32_t qa[kKT][2];
    const bool live_q = quad < w.G;
    const T* qr = q + w.q_off + static_cast<long long>(quad) * d;
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      if (kt < KT) {
        const int c = kt * 16 + qi * 2;
        qa[kt][0] = live_q ? *reinterpret_cast<const uint32_t*>(qr + c) : 0u;
        qa[kt][1] = live_q && c + 8 < d
                        ? *reinterpret_cast<const uint32_t*>(qr + c + 8)
                        : 0u;
      }
    }
    const Ring<T, kStages> ring(ring_mem, step, lds, warp);
    const int mi = lane >> 3;            // the 8x8 matrix this lane points at
    prefetch<T, 8>(w, ring, rows, lane);
    for (int st = w.st_begin; st < w.st_end; ++st) {
      advance<T, 8>(w, ring, rows, lane, st);
      const T* ks = ring.k(st);
      const T* vs = ring.v(st);
      const int t0 = st * step + ring.r_lo;
      for (int r0 = 0; r0 < ring.r_n && t0 + r0 < w.present_end;
           r0 += kSub) {
        // S^T tiles: queries x rows r0 .. r0 + 7 and r0 + 8 .. r0 + 15;
        // the K fragments of four k-tiles are loaded before their products,
        // and even and odd k-tiles sum in two chains, so the latencies
        // overlap
        float s[2][2][2] = {};
        const T* kb = ks + (r0 + (mi >> 1) * 8 + (lane & 7)) * lds;
#pragma unroll
        for (int k0 = 0; k0 < kKT; k0 += 4) {
          if (k0 < KT) {
            uint32_t b[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int kt = k0 + u;
              const bool half = kt * 16 + 8 >= d;  // d % 16 == 8: last tile
              if (kt < KT) {
                ldsm_x4(b[u], kb + kt * 16 + (half ? 0 : (mi & 1) * 8),
                        false);
                if (half) b[u][1] = b[u][3] = 0u;
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int kt = k0 + u;
              if (kt < KT) {
                float* c0 = s[0][u & 1];
                float* c1 = s[1][u & 1];
                mma_bf16(c0[0], c0[1], qa[kt][0], qa[kt][1], b[u][0],
                         b[u][1]);
                mma_bf16(c1[0], c1[1], qa[kt][0], qa[kt][1], b[u][2],
                         b[u][3]);
              }
            }
          }
        }
        float x[2][2];
        float mc = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = r0 + nt * 8 + qi * 2 + j;
            x[nt][j] = mask_score(s[nt][0][j] + s[nt][1][j], r, t0 + r,
                                  ring.r_n, w);
            mc = fmaxf(mc, x[nt][j]);
          }
        }
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        const float mn = fmaxf(m, mc);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            x[nt][j] = expf(x[nt][j] - mn);
            sum += x[nt][j];
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = expf(m - mn);
        l = alpha * l + sum;
        m = mn;
        // p.V: A = p (bf16) over the 16 rows, B = V^T tiles of 8 elements
        const uint32_t pa0 = pack_bf16(x[0][0], x[0][1]);
        const uint32_t pa2 = pack_bf16(x[1][0], x[1][1]);
        const T* vb = vs + (r0 + (mi & 1) * 8 + (lane & 7)) * lds;
#pragma unroll
        for (int e0 = 0; e0 < kET; e0 += 8) {
          if (e0 < ET) {
            uint32_t b[4][4];   // V^T fragments of four pairs of e-tiles
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int et = e0 + 2 * u;
              if (et < ET) {
                const bool pair = et + 1 < ET;
                ldsm_x4(b[u], vb + (et + (pair ? (mi >> 1) : 0)) * 8, true);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int et = e0 + 2 * u;
              if (et < ET) {
                o[et][0] *= alpha;
                o[et][1] *= alpha;
                mma_bf16(o[et][0], o[et][1], pa0, pa2, b[u][0], b[u][1]);
                if (et + 1 < ET) {
                  o[et + 1][0] *= alpha;
                  o[et + 1][1] *= alpha;
                  mma_bf16(o[et + 1][0], o[et + 1][1], pa0, pa2, b[u][2],
                           b[u][3]);
                }
              }
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot before it refills
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with the rings: mrg reuses them
  if (quad < w.G) {
    if (qi == 0) {
      ml[(warp * kGroup + quad) * 2] = m;
      ml[(warp * kGroup + quad) * 2 + 1] = l;
    }
    float* row = mrg + (warp * w.G + quad) * d + qi * 2;
#pragma unroll
    for (int et = 0; et < kET; ++et) {
      if (et < ET) {
        row[et * 8] = o[et][0];
        row[et * 8 + 1] = o[et][1];
      }
    }
  }
}

// DMAX: the widest head the instantiation takes (128 or 256); only the
// tensor-core path sizes its registers by it.
template <typename T, int VEC, int DMAX, bool MASK_OOB, bool RCP,
          typename Rows>
__device__ __forceinline__ void walk(const Args& a, const Coords& c,
                                     Rows& rows) {
  const int d = a.d;
  const int G = c.n;
  const int gm = min(kGroup, c.group);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [G, d]
  float* ml = qs + gm * d;                             // [kWarps, kGroup, 2]
  float* wf = ml + 2 * kWarps * kGroup;                // [kWarps, kGroup]
  float* gmx = wf + kWarps * kGroup;                   // [kGroup]
  float* gl = gmx + kGroup;                            // [kGroup]
  int* flag = reinterpret_cast<int*>(gl + kGroup);
  unsigned char* extra = smem + head_bytes(gm, d);
  T* ring = reinterpret_cast<T*>(extra + round16(a.extra_bytes));
  float* mrg = reinterpret_cast<float*>(ring);         // [kWarps, G, d]

  Walk w;
  w.d = d;
  w.G = G;
  w.scale = a.scale;
  w.len = max(0, min(a.kv_len[c.b], a.load_cap));
  w.present_end = MASK_OOB ? w.len : a.rows_total;
  w.load_end = MASK_OOB ? w.len : a.load_cap;
  const int n_steps = (a.rows_total + a.step - 1) / a.step;
  // the splits that hold rows of the walk (all of them without MASK_OOB);
  // the others leave at once, and split 0 stays to write a zero output
  const int live_steps =
      min(n_steps, (w.present_end + a.step - 1) / a.step);
  const int n_live = (live_steps + a.steps_per_split - 1) / a.steps_per_split;
  const int parts = max(n_live, 1);
  if (c.split >= parts) return;
  w.st_begin = c.split * a.steps_per_split;
  w.st_end = min(live_steps, w.st_begin + a.steps_per_split);
  w.q_off = (static_cast<long long>(c.b) * a.hq +
             static_cast<long long>(c.h) * c.group + c.g0) * d;
  const T* q = static_cast<const T*>(a.q);

  constexpr bool kMma = kMmaWalk<T, VEC>;
  if (w.st_begin < w.st_end) {
    rows.load(Span{w.st_begin, w.st_end}, a.step,
              reinterpret_cast<int*>(extra));
    if constexpr (!kMma) {
      for (int i = tid; i < G * d; i += kThreads) qs[i] = to_f(q[w.q_off + i]);
    }
    __syncthreads();
  }
  if constexpr (kMma) {
    mma_walk<DMAX>(w, rows, ring, a.lds, a.step, q, mrg, ml);
  } else if (a.stages == 1) {
    fma_walk<T, VEC, 1>(w, rows, ring, a.lds, a.step, qs, mrg, ml);
  } else {
    fma_walk<T, VEC, kStages>(w, rows, ring, a.lds, a.step, qs, mrg, ml);
  }
  __syncthreads();

  // the block's state: the warps' merged with Kernel 1's weights, each
  // warp's weight computed once a query
  if (tid < G) {
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      mx = fmaxf(mx, ml[(v * kGroup + tid) * 2]);
    }
    const float ms = lse_ref(mx);
    float lv = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float f = expf(ml[(v * kGroup + tid) * 2] - ms);
      wf[v * kGroup + tid] = f;
      lv += f * ml[(v * kGroup + tid) * 2 + 1];
    }
    gmx[tid] = mx;
    gl[tid] = lv;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d;
    float av = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      av += wf[v * kGroup + g] * mrg[v * G * d + i];
    }
    if (parts == 1) {
      out[w.q_off + i] = from_f<T>(finish<RCP>(av, gl[g]));
    } else {
      const long long ps = (w.q_off / d + g) * a.splits + c.split;
      a.part_acc[ps * d + (i - g * d)] = av;
      if (i - g * d == 0) {
        a.part_ml[2 * ps] = gmx[g];
        a.part_ml[2 * ps + 1] = gl[g];
      }
    }
  }
  if (parts == 1) return;

  // the last live block of this (kv head, request) merges the live splits:
  // after the block barrier one thread's fence releases the block's stores
  // before its count, and in the last block acquires the others' after it
  __syncthreads();
  const int ci = c.b * gridDim.x + blockIdx.x;
  if (tid == 0) {
    fence_gpu();
    const bool last = atomicAdd(a.counters + ci, 1) == parts - 1;
    if (last) fence_gpu();
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d;
    const long long p0 = (w.q_off / d + g) * a.splits;
    const float* pml = a.part_ml + 2 * p0;
    const float* pacc = a.part_acc + p0 * d + (i - g * d);
    // Kernel 1's weights over the splits, eight splits' loads in flight
    // at once and the reference point carried across groups of eight; an
    // empty split (l = 0) wrote no accumulator: selected away
    float ref = kNegInf, av = 0.f, lv = 0.f;
    for (int s0 = 0; s0 < parts; s0 += 8) {
      float mv[8], lw[8], xv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool in = s0 + u < parts;
        mv[u] = in ? __ldcg(pml + 2 * (s0 + u)) : kNegInf;
        lw[u] = in ? __ldcg(pml + 2 * (s0 + u) + 1) : 0.f;
        xv[u] = in ? __ldcg(pacc + static_cast<long long>(s0 + u) * d) : 0.f;
      }
      float mx = ref;
#pragma unroll
      for (int u = 0; u < 8; ++u) mx = fmaxf(mx, mv[u]);
      const float ms = lse_ref(mx);
      const float r = expf(ref - ms);
      av *= r;
      lv *= r;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float f = lw[u] > 0.f ? expf(mv[u] - ms) : 0.f;
        av += f > 0.f ? f * xv[u] : 0.f;
        lv += f * lw[u];
      }
      ref = mx;
    }
    out[w.q_off + i] = from_f<T>(finish<RCP>(av, lv));
  }
  if (tid == 0) a.counters[ci] = 0;
}

}  // namespace decode

}  // namespace repro
