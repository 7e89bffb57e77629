// Single-token GQA decode attention over a contiguous KV cache, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:
// flash_decode_attention (body _kernel with the helpers _init_carry,
// _online_softmax_step and _finalize_output).
//
//   q [b, hq, d]; k, v [b, s, hkv, d] (one layer of the [L, B, S, Hkv, d]
//   cache); kv_len [b] int32, clamped to [0, s]; out [b, hq, d].
//   The rows are walked in steps of `chunk` with an fp32 online-softmax
//   carry (acc, m, l); rows >= kv_len score -1e30; out is acc / l, or 0
//   where l = 0.
//
// What bounds it on the H100: bytes. Each K and V row of every kv head is
// read once and serves the whole query group (4 heads at h2o-danube-1.8b's
// width), ~4 * group flops per element read. At the h2o decode shape (8
// requests, a 4096-row ring, 8 kv heads of 80) the call moves 83.9 MB,
// more than the 50 MB L2: 25.0 us at 3.35 TB/s.
//
// Design: one block of 256 threads per (kv head, request), as
// csrc/paged_decode.cu, so the h2o decode shape runs 64 blocks. The block
// keeps its query group and the accumulator in fp32 shared memory. K and V
// rows are staged in their own dtype in a two-stage ring of `chunk`-row
// tiles filled with 16-byte cp.async copies: the copy of chunk c + 1 is in
// flight while chunk c is scored (one (query, row) pair a thread, 16-byte
// vector reads of K; a tile row is padded to an odd number of 16-byte units
// so those reads hit distinct banks), folded into the carry (one warp per
// query, shuffle reductions) and multiplied into the accumulator (one
// (query, element) pair a thread). Genome flags are template parameters,
// every combination instantiated:
//   MASK_OOB  visit only the chunks below kv_len and copy only rows below
//             it; else every chunk of the cache is read and masked, as the
//             Pallas baseline's grid walks every chunk;
//   RCP       out = acc * __frcp_rn(l); else out = acc / l.
// Rows the block does not copy (past s, or past kv_len under MASK_OOB) get
// V = 0 in the tile, the zero padding of the Pallas kernel, so every
// genome gives the Pallas kernel's result, kv_len = 0 included. Nothing
// is padded in device memory: s need not be a multiple of chunk, nor the
// group of 8. Any group size and any head_dim up to 256 work.
//
// Only 64 blocks run at the h2o decode shape, each walking 4096 rows in
// turn. A split-KV form (FlashDecoding: the rows of one head split across
// blocks, the partial states merged with paper Kernel 1's LSE math) would
// fill the card; it is a later step.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_vec;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;       // finite -inf, as the Pallas kernel
constexpr size_t kMaxSmem = 232448;     // 227 KB a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
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

// Bytes of fp32 state in front of the tiles: q group, acc, scores, m, l,
// alpha; rounded up to 16 so the tiles start aligned.
__host__ __device__ inline size_t state_bytes(int group, int d, int chunk) {
  const size_t floats = 2 * static_cast<size_t>(group) * d +
                        static_cast<size_t>(group) * chunk + 3 * group;
  return (floats * sizeof(float) + 15) / 16 * 16;
}

// Queue the copy of rows [c0, c0 + chunk) into the tiles ks and vs (row
// stride lds). Rows at or past load_end are not read: their V is set to 0.
template <typename T, int VEC>
__device__ __forceinline__ void stage_chunk(const T* kb, const T* vb, T* ks,
                                            T* vs, int c0, int chunk,
                                            int load_end, int d, int lds,
                                            long long row_stride) {
  const int per_row = d / VEC;
  for (int i = threadIdx.x; i < chunk * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int e = (i - r * per_row) * VEC;
    const int t = c0 + r;
    T* kd = ks + r * lds + e;
    T* vd = vs + r * lds + e;
    if (t < load_end) {
      const long long off = t * row_stride + e;
      if constexpr (VEC > 1) {
        cp_async16(kd, kb + off);
        cp_async16(vd, vb + off);
      } else {
        *kd = kb[off];
        *vd = vb[off];
      }
    } else if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      *vd = from_f<T>(0.f);
    }
  }
}

template <typename T, int VEC, bool MASK_OOB, bool RCP>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int hq, int hkv, int d, int s, int chunk, int lds,
                        float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [group, d]
  float* acc = qs + group * d;                 // [group, d]
  float* sc = acc + group * d;                 // [group, chunk] scores/probs
  float* m = sc + group * chunk;               // [group] running max
  float* l = m + group;                        // [group] running sum
  float* alpha = l + group;                    // [group] this chunk's rescale
  // two stages of [K tile, V tile], each [chunk, lds] in T
  T* tiles = reinterpret_cast<T*>(smem + state_bytes(group, d, chunk));
  const int tile = chunk * lds;

  const long long q_off = (static_cast<long long>(b) * hq +
                           static_cast<long long>(h) * group) * d;
  for (int i = tid; i < group * d; i += nt) {
    qs[i] = to_f(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += nt) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int len = max(0, min(kv_len[b], s));
  const int load_end = MASK_OOB ? len : s;
  const int n_chunks = (load_end + chunk - 1) / chunk;
  const long long row_stride = static_cast<long long>(hkv) * d;
  const long long head_off = static_cast<long long>(b) * s * row_stride +
                             static_cast<long long>(h) * d;
  const T* kb = k + head_off;
  const T* vb = v + head_off;

  if (n_chunks > 0) {
    stage_chunk<T, VEC>(kb, vb, tiles, tiles + tile, 0, chunk, load_end, d,
                        lds, row_stride);
  }
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk;
    const T* ks = tiles + (c & 1) * 2 * tile;
    const T* vs = ks + tile;
    // every reader of the other stage and of sc is done with the last chunk
    __syncthreads();
    if (c + 1 < n_chunks) {
      T* kn = tiles + ((c + 1) & 1) * 2 * tile;
      stage_chunk<T, VEC>(kb, vb, kn, kn + tile, c0 + chunk, chunk,
                          load_end, d, lds, row_stride);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of chunk c have landed
    __syncthreads();     // ... and every thread's
    // scores: one (query, row) pair per thread and step
    for (int i = tid; i < group * chunk; i += nt) {
      const int g = i / chunk;
      const int r = i - g * chunk;
      float sv = kNegInf;
      if (c0 + r < len) {
        const float* qg = qs + g * d;
        const T* kr = ks + r * lds;
        float dot[2] = {0.f, 0.f};  // two chains: more products in flight
        if constexpr (VEC > 1) {
          for (int e = 0; e < d; e += VEC) {
            float kk[VEC], qq[VEC];
            load_vec<T, VEC>(kr + e, kk);
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              *reinterpret_cast<float4*>(qq + j) =
                  *reinterpret_cast<const float4*>(qg + e + j);
            }
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              dot[j & 1] = fmaf(qq[j], kk[j], dot[j & 1]);
            }
          }
        } else {
          for (int e = 0; e < d; ++e) {
            dot[e & 1] = fmaf(qg[e], to_f(kr[e]), dot[e & 1]);
          }
        }
        sv = (dot[0] + dot[1]) * scale;
      }
      sc[i] = sv;
    }
    __syncthreads();
    // online softmax: one warp per query, lanes across the chunk's rows
    for (int g = warp; g < group; g += n_warps) {
      float* sg = sc + g * chunk;
      float m_cur = kNegInf;
      for (int r = lane; r < chunk; r += 32) m_cur = fmaxf(m_cur, sg[r]);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, warp_max(m_cur));
      float sum = 0.f;
      for (int r = lane; r < chunk; r += 32) {
        const float p = expf(sg[r] - m_new);
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        l[g] = a * l[g] + sum;
        m[g] = m_new;
        alpha[g] = a;
      }
    }
    __syncthreads();
    // rescale the carry and add this chunk's probability-weighted V rows
    for (int i = tid; i < group * d; i += nt) {
      const int g = i / d;
      const int e = i - g * d;
      const float* pg = sc + g * chunk;
      const T* ve = vs + e;
      float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains over the rows
      int r = 0;
      for (; r + 4 <= chunk; r += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[j] = fmaf(pg[r + j], to_f(ve[(r + j) * lds]), part[j]);
        }
      }
      for (; r < chunk; ++r) {
        part[0] = fmaf(pg[r], to_f(ve[r * lds]), part[0]);
      }
      acc[i] = acc[i] * alpha[g] +
               ((part[0] + part[1]) + (part[2] + part[3]));
    }
  }
  __syncthreads();
  for (int i = tid; i < group * d; i += nt) {
    const float lg = l[i / d];
    float o;
    if constexpr (RCP) {
      o = lg > 0.f ? acc[i] * __frcp_rn(lg) : 0.f;
    } else {
      o = acc[i] / (lg > 0.f ? lg : 1.f);
    }
    out[q_off + i] = from_f<T>(o);
  }
}

template <typename T, int VEC, bool MASK_OOB, bool RCP>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, int b, int hq, int hkv, int d, int s, int chunk,
           int lds, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const size_t smem = state_bytes(group, d, chunk) +
                      4 * static_cast<size_t>(chunk) * lds * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_decode_kernel<T, VEC, MASK_OOB, RCP>;
  int err = repro::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), hq, hkv, d, s,
      chunk, lds, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* out, int b, int hq, int hkv, int d, int s, int chunk,
             int lds, float scale, bool mask_oob, bool rcp,
             cudaStream_t stream) {
  return repro::with_bool(mask_oob, [&](auto mo) {
    return repro::with_bool(rcp, [&](auto r) {
      return launch<T, VEC, decltype(mo)::value, decltype(r)::value>(
          q, k, v, kv_len, out, b, hq, hkv, d, s, chunk, lds, scale, stream);
    });
  });
}

}  // namespace

// All tensors contiguous; q, k, v and out in `dtype`, kv_len int32. hq must
// be a multiple of hkv, d at most 256, 1 <= chunk <= s (the wrapper checks
// all three). `vec` is 1 or the 16-byte width of the dtype (the wrapper
// checks that it divides d and that k and v are 16-byte aligned); `lds`,
// the tile row stride in elements, is at least d, and with vec > 1 a
// multiple of it. Returns the launch's CUDA error code; a tile that does
// not fit 227 KB of shared memory is refused (cudaErrorInvalidValue).
extern "C" int repro_flash_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int b, int hq, int hkv, int d, int s, int chunk, int lds,
    float scale, int dtype, int vec, int mask_oob, int rcp, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto lens = static_cast<const int*>(kv_len);
  if (chunk < 1 || lds < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == repro::kBFloat16) {
    return vec == 8
        ? dispatch<__nv_bfloat16, 8>(q, k, v, lens, out, b, hq, hkv, d, s,
                                     chunk, lds, scale, mask_oob, rcp, st)
        : dispatch<__nv_bfloat16, 1>(q, k, v, lens, out, b, hq, hkv, d, s,
                                     chunk, lds, scale, mask_oob, rcp, st);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4
        ? dispatch<float, 4>(q, k, v, lens, out, b, hq, hkv, d, s, chunk,
                             lds, scale, mask_oob, rcp, st)
        : dispatch<float, 1>(q, k, v, lens, out, b, hq, hkv, d, s, chunk,
                             lds, scale, mask_oob, rcp, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
