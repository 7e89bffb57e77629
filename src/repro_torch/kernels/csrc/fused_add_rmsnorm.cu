// Fused residual add + RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_add_rmsnorm.py:
// fused_add_rmsnorm (the one-pass body _one_pass_kernel, and the two-pass
// baseline _pass1_kernel + _pass2_kernel).
//
//   r' = x + r;  y = r' * rsqrt(mean(r'^2) + eps) * w
//   returns y and r', both in the input dtype T; w is fp32 or T, read in
//   its own dtype and widened in registers (a bf16 value widens exactly).
//
// What bounds it on the H100: bytes. Per row it reads x and r and writes y
// and r' (4 * d elements) plus the d weights, and does ~5 flops per
// element, far below the ~295 flops/byte the card needs to be compute
// bound. At decode (8 rows of 896) the whole call moves ~60 KB, so what
// counts there is the chain of dependent steps: launch, one round trip to
// memory, the reduction, the stores.
//
// One pass (the shipped form). A block is `groups` row groups of `tpr`
// threads (whole warps) and takes block_rows consecutive rows; group g
// takes rows g, g + groups, ... of them. A thread owns the row's 16-byte
// vectors t, t + tpr, ... (NV of them at most, a compile-time count):
//   - its x, r and w vectors are loaded together, before any reduction,
//     so a row costs one round trip to memory; w stays in registers for
//     the group's later rows;
//   - r' stays in fp32 registers (each thread normalises only the entries
//     it added), and is stored at once;
//   - the sum of squares is reduced by warp shuffles, then, for a row of
//     several warps, by one exchange of per-warp partials behind one
//     barrier of the group's own warps (bar.sync g, tpr; the partials are
//     double-buffered, so no second barrier guards their reuse); a row of
//     one warp has no barrier at all;
//   - a group with another row to go queues that row's x and r with
//     16-byte cp.async copies into its own slot of shared memory before it
//     reduces the current row, so loads stay in flight across the
//     reduction; each thread later reads back only the vectors it queued
//     (no barrier). Single-element rows (a width that is not a multiple of
//     the vector, or misaligned pointers) load each row when they reach it.
// Two pass (the paper's baseline): pass 1 writes r' in T and an fp32 sum
// of squares per row; pass 2 re-reads the rounded r' and normalises (two
// launches, one more round trip of r').
// Genome flags are template parameters, every combination instantiated:
//   RSQRT   rsqrtf; else 1 / sqrtf;
//   ACCUM   the add in fp32; else rounded to T first.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_raw;
using repro::Raw;
using repro::round_to;

constexpr int kMaxGroups = 16;    // named barriers 0..15, one a row group

// 32-bit registers a thread's row data takes: r' in fp32 and w raw, NV
// vectors of each, and for single elements the two more that each one's
// own addresses cost. Above 32 a block is held to 512 threads (128
// registers a thread), else 1,024 (64). The wrapper applies the same rule
// (fused_add_rmsnorm.py: block_limit).
template <typename W, int VEC, int NV>
constexpr int data_words() {
  return NV * (VEC + Raw<W, VEC>::kWords + (VEC == 1 ? 2 : 0));
}

template <typename W, int VEC, int NV>
constexpr int max_threads() {
  return data_words<W, VEC, NV>() > 32 ? 512 : 1024;
}

template <bool RSQRT>
__device__ __forceinline__ float inv_rms(float sumsq, int d, float eps) {
  const float var = sumsq / d + eps;
  if constexpr (RSQRT) {
    return rsqrtf(var);
  } else {
    return 1.f / sqrtf(var);
  }
}

// The sum of v over the row group g of tpr threads: warp shuffles, then
// (several warps) one exchange of per-warp partials through `partial`
// (32 floats of this parity) behind the group's barrier.
__device__ __forceinline__ float group_sum(float v, float* partial, int g,
                                           int tpr) {
  v = repro::warp_sum(v);
  if (tpr == 32) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[threadIdx.x >> 5] = v;
  repro::named_barrier(g, tpr);
  return repro::warp_sum(lane < (tpr >> 5) ? partial[lane] : 0.f);
}

// s = x + r for one vector, widened to fp32 (rounded to T first unless
// ACCUM).
template <typename T, int VEC, bool ACCUM>
__device__ __forceinline__ void add_vec(const Raw<T, VEC>& xv,
                                        const Raw<T, VEC>& rv, float* s) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s[e] = ACCUM ? xv[e] + rv[e] : round_to<T>(xv[e] + rv[e]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float* v) {
  Raw<T, VEC> out;
  T* e = reinterpret_cast<T*>(out.w);
#pragma unroll
  for (int k = 0; k < VEC; ++k) e[k] = from_f<T>(v[k]);
  if constexpr (Raw<T, VEC>::kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(out.w);
  } else {
    *p = e[0];
  }
}

template <typename T, typename W, int VEC, int NV, bool RSQRT, bool ACCUM>
__global__ void __launch_bounds__(max_threads<W, VEC, NV>())
    one_pass_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const W* __restrict__ w, T* __restrict__ y,
                    T* __restrict__ res_out, int rows, int d, float eps,
                    int block_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStage = VEC > 1;     // the next row queued by cp.async
  const int tpr = blockDim.x, t = threadIdx.x, g = threadIdx.y;
  const int n_vec = d / VEC;
  const int row_end = min(rows, (blockIdx.x + 1) * block_rows);
  int row = blockIdx.x * block_rows + g;
  float* partial = reinterpret_cast<float*>(smem) + g * 64;   // 2 x 32
  uint4* stage = reinterpret_cast<uint4*>(smem + blockDim.y * 64 * 4) +
                 static_cast<size_t>(g) * 2 * NV * tpr;      // x, r slots
  if (row >= row_end) return;
  Raw<W, VEC> wv[NV];
  float s[NV][VEC];
  // x, r (and, for the group's first row, w) of row rw: one round trip
  auto load_row = [&](int rw, bool with_w) {
    const long long base = static_cast<long long>(rw) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = t + k * tpr;
      if (v < n_vec) {
        Raw<T, VEC> xv, rv;
        load_raw(x + base + v * VEC, xv);
        load_raw(res + base + v * VEC, rv);
        if (with_w) load_raw(w + v * VEC, wv[k]);
        add_vec<T, VEC, ACCUM>(xv, rv, s[k]);
      }
    }
  };
  load_row(row, true);
  for (int it = 0;; ++it) {
    const int next = row + blockDim.y;
    const bool more = next < row_end;
    if (more && kStage) {
      const long long nb = static_cast<long long>(next) * d;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = t + k * tpr;
        if (v < n_vec) {
          repro::cp_async16_or_zero(stage + k * tpr + t, x + nb + v * VEC,
                                    true);
          repro::cp_async16_or_zero(stage + (NV + k) * tpr + t,
                                    res + nb + v * VEC, true);
        }
      }
      repro::cp_async_commit();
    }
    const long long base = static_cast<long long>(row) * d;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = t + k * tpr;
      if (v < n_vec) {
        store_row<T, VEC>(res_out + base + v * VEC, s[k]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += s[k][e] * s[k][e];
      }
    }
    const float inv =
        inv_rms<RSQRT>(group_sum(ss, partial + (it & 1) * 32, g, tpr), d,
                       eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = t + k * tpr;
      if (v < n_vec) {
        float out[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = s[k][e] * inv * wv[k][e];
        store_row<T, VEC>(y + base + v * VEC, out);
      }
    }
    if (!more) break;
    row = next;
    if constexpr (kStage) {
      repro::cp_async_wait<0>();        // this thread's copies landed
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = t + k * tpr;
        if (v < n_vec) {
          Raw<T, VEC> xv, rv;
          *reinterpret_cast<uint4*>(xv.w) = stage[k * tpr + t];
          *reinterpret_cast<uint4*>(rv.w) = stage[(NV + k) * tpr + t];
          add_vec<T, VEC, ACCUM>(xv, rv, s[k]);
        }
      }
    } else {
      load_row(row, false);
    }
  }
}

// Pass 1 of the baseline: r' in T and the fp32 sum of squares of each row.
template <typename T, int VEC, bool ACCUM>
__global__ void pass1_kernel(const T* __restrict__ x,
                             const T* __restrict__ res,
                             T* __restrict__ res_out,
                             float* __restrict__ sumsq, int rows, int d,
                             int block_rows) {
  __shared__ float partials[kMaxGroups * 64];
  const int tpr = blockDim.x, g = threadIdx.y;
  const int row_end = min(rows, (blockIdx.x + 1) * block_rows);
  int it = 0;
  for (int row = blockIdx.x * block_rows + g; row < row_end;
       row += blockDim.y, ++it) {
    const long long base = static_cast<long long>(row) * d;
    float ss = 0.f;
    for (int i = threadIdx.x * VEC; i < d; i += tpr * VEC) {
      Raw<T, VEC> xv, rv;
      load_raw(x + base + i, xv);
      load_raw(res + base + i, rv);
      float s[VEC];
      add_vec<T, VEC, ACCUM>(xv, rv, s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += s[e] * s[e];
      store_row<T, VEC>(res_out + base + i, s);
    }
    const float total =
        group_sum(ss, partials + g * 64 + (it & 1) * 32, g, tpr);
    if (threadIdx.x == 0) sumsq[row] = total;
  }
}

// Pass 2 of the baseline: y from the rounded r' and the row's sum.
template <typename T, typename W, int VEC, bool RSQRT>
__global__ void pass2_kernel(const T* __restrict__ res_out,
                             const float* __restrict__ sumsq,
                             const W* __restrict__ w, T* __restrict__ y,
                             int rows, int d, float eps, int block_rows) {
  const int row_end = min(rows, (blockIdx.x + 1) * block_rows);
  for (int row = blockIdx.x * block_rows + threadIdx.y; row < row_end;
       row += blockDim.y) {
    const long long base = static_cast<long long>(row) * d;
    const float inv = inv_rms<RSQRT>(sumsq[row], d, eps);
    for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
      Raw<T, VEC> rv;
      Raw<W, VEC> wv;
      load_raw(res_out + base + i, rv);
      load_raw(w + i, wv);
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = rv[e] * inv * wv[e];
      store_row<T, VEC>(y + base + i, out);
    }
  }
}

struct Args {
  const void* x;
  const void* res;
  const void* w;
  void* y;
  void* res_out;
  float* sumsq;
  int rows, d;
  float eps;
  int tpr, groups, block_rows;
  cudaStream_t stream;
};

// Shared memory of a one-pass block: the groups' double-buffered partials,
// then (a group with more than one row, 16-byte vectors) each group's slot
// for its next row's x and r.
template <int VEC, int NV>
size_t one_pass_smem(const Args& a) {
  size_t bytes = static_cast<size_t>(a.groups) * 64 * sizeof(float);
  if (VEC > 1 && a.block_rows > a.groups) {
    bytes += static_cast<size_t>(a.groups) * 2 * NV * a.tpr * 16;
  }
  return bytes;
}

template <typename T, typename W, int VEC, int NV, bool RSQRT, bool ACCUM>
int launch_one_pass(const Args& a) {
  const int n_vec = a.d / VEC;
  if (a.tpr * a.groups > max_threads<W, VEC, NV>() ||
      static_cast<long long>(NV) * a.tpr < n_vec) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto kernel = one_pass_kernel<T, W, VEC, NV, RSQRT, ACCUM>;
  const size_t smem = one_pass_smem<VEC, NV>(a);
  int err = repro::allow_smem(kernel, smem);
  if (err) return err;
  const int grid = (a.rows + a.block_rows - 1) / a.block_rows;
  kernel<<<grid, dim3(a.tpr, a.groups), smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const W*>(a.w), static_cast<T*>(a.y),
      static_cast<T*>(a.res_out), a.rows, a.d, a.eps, a.block_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W, int VEC, bool RSQRT, bool ACCUM>
int launch_two_pass(const Args& a) {
  const dim3 block(a.tpr, a.groups);
  const int grid = (a.rows + a.block_rows - 1) / a.block_rows;
  pass1_kernel<T, VEC, ACCUM><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<T*>(a.res_out), a.sumsq, a.rows, a.d, a.block_rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pass2_kernel<T, W, VEC, RSQRT><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.res_out), static_cast<const float*>(a.sumsq),
      static_cast<const W*>(a.w), static_cast<T*>(a.y), a.rows, a.d, a.eps,
      a.block_rows);
  return static_cast<int>(cudaGetLastError());
}

// The NV instantiation for nv vectors a thread: 1, 2 or 4 of 16 bytes;
// 1, 2, 4, 8 or 16 single elements.
template <int VEC, typename F>
int with_nv(int nv, F&& f) {
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: break;
  }
  if constexpr (VEC == 1) {
    if (nv == 8) return f(std::integral_constant<int, 8>{});
    if (nv == 16) return f(std::integral_constant<int, 16>{});
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename T, typename W, int VEC>
int dispatch(const Args& a, int nv, bool two_pass, bool rsqrt, bool accum) {
  return repro::with_bool(rsqrt, [&](auto r) {
    return repro::with_bool(accum, [&](auto f) {
      constexpr bool R = decltype(r)::value, A = decltype(f)::value;
      if (two_pass) return launch_two_pass<T, W, VEC, R, A>(a);
      return with_nv<VEC>(nv, [&](auto n) {
        return launch_one_pass<T, W, VEC, decltype(n)::value, R, A>(a);
      });
    });
  });
}

template <typename T, typename W>
int dispatch_vec(const Args& a, int vec, int nv, bool two_pass, bool rsqrt,
                 bool accum) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) return dispatch<T, W, kVec>(a, nv, two_pass, rsqrt, accum);
  if (vec == 1) return dispatch<T, W, 1>(a, nv, two_pass, rsqrt, accum);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, res, y, res_out: [rows, d] contiguous in `dtype`; w: [d] in `wdtype`
// (float32, or `dtype`); sumsq: [rows] fp32 scratch (read only by the
// two-pass form). `vec` is 1 or the 16-byte width of the dtype (the
// wrapper checks the width and the pointers' alignment); `nv` the vectors
// a one-pass thread holds (nv * tpr * vec >= d). A block is tpr x groups
// threads (tpr a multiple of 32, groups at most 16) and takes block_rows
// rows. Launches one kernel, or two when two_pass is 1.
extern "C" int repro_fused_add_rmsnorm(const void* x, const void* res,
                                       const void* w, void* y, void* res_out,
                                       void* sumsq, int rows, int d,
                                       float eps, int dtype, int wdtype,
                                       int vec, int nv, int tpr, int groups,
                                       int block_rows, int two_pass,
                                       int rsqrt, int accum, void* stream) {
  if (tpr < 32 || tpr % 32 || groups < 1 || groups > kMaxGroups ||
      tpr * groups > 1024 || block_rows < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Args a{x, res, w, y, res_out, static_cast<float*>(sumsq), rows, d,
               eps, tpr, groups, block_rows,
               static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kBFloat16 && wdtype == repro::kBFloat16) {
    return dispatch_vec<__nv_bfloat16, __nv_bfloat16>(a, vec, nv, two_pass,
                                                      rsqrt, accum);
  }
  if (dtype == repro::kBFloat16 && wdtype == repro::kFloat32) {
    return dispatch_vec<__nv_bfloat16, float>(a, vec, nv, two_pass, rsqrt,
                                              accum);
  }
  if (dtype == repro::kFloat32 && wdtype == repro::kFloat32) {
    return dispatch_vec<float, float>(a, vec, nv, two_pass, rsqrt, accum);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
