// Fused residual add + RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_add_rmsnorm.py:
// fused_add_rmsnorm (the one-pass body _one_pass_kernel, and the two-pass
// baseline _pass1_kernel + _pass2_kernel).
//
//   r' = x + r;  y = r' * rsqrt(mean(r'^2) + eps) * w
//   returns y and r', both in the input dtype; w is fp32.
//
// What bounds it on the H100: bytes. Per row it reads x and r and writes y
// and r' (4 * d elements) plus the d fp32 weights, and does ~5 flops per
// element, far below the ~295 flops/byte the card needs to be compute
// bound. At decode (8 rows of 896) the whole call moves ~60 KB, so it is
// launch bound in practice.
//
// Design: a block of `groups` row groups of `tpr` threads (a multiple of
// 32) takes up to block_rows consecutive rows, `groups` at a time; with
// one row per block (the wrapper's choice while one-row blocks fit the
// card in one wave, so at every decode and prefill step of the served
// model) the whole block takes its row. Each thread reads x
// and r with 16-byte vector loads (8 bf16 or 4 fp32) when the width and
// pointers allow; the sum of squares is reduced with warp shuffles, then
// across the warps through shared memory.
// Genome flags are template parameters, every combination instantiated:
//   one pass (the shipped form): r' stays in fp32 in shared memory between
//       the reduction and the normalisation, so each byte crosses device
//       memory once;
//   two pass: pass 1 writes r' in the input dtype and an fp32 sum of
//       squares per row; pass 2 re-reads the rounded r' and normalises
//       (two launches, one more round trip of r');
//   RSQRT   rsqrtf; else 1 / sqrtf;
//   ACCUM   the add in fp32; else rounded to the input dtype first.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_vec;
using repro::round_to;
using repro::store_vec;
using repro::to_f;

// Sum of v over the row group of this thread (blockDim.x threads, a
// multiple of 32): warp shuffles, one partial per warp in `scratch`, then
// every thread adds its group's partials. Every thread of the block must
// call it (it synchronises the block).
__device__ __forceinline__ float group_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int wpg = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.y * wpg + warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < wpg; ++k) total += scratch[threadIdx.y * wpg + k];
  __syncthreads();  // scratch is reused by the next row
  return total;
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

// x + r for VEC elements at xr + i, rr + i, widened to fp32 (rounded to T
// first unless ACCUM).
template <typename T, int VEC, bool ACCUM>
__device__ __forceinline__ void add_rows(const T* xr, const T* rr, int i,
                                         float* s) {
  float rv[VEC];
  if constexpr (VEC > 1) {
    load_vec<T, VEC>(xr + i, s);
    load_vec<T, VEC>(rr + i, rv);
  } else {
    s[0] = to_f(xr[i]);
    rv[0] = to_f(rr[i]);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s[k] = ACCUM ? s[k] + rv[k] : round_to<T>(s[k] + rv[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, int i, const float* v) {
  if constexpr (VEC > 1) {
    store_vec<T, VEC>(p + i, v);
  } else {
    p[i] = from_f<T>(v[0]);
  }
}

// One row: r' = x + r into r_s (fp32, shared) and res_out, the sum of
// squares reduced over the block (GROUPED: over this thread's row group),
// then y from r_s. Threads of a row that is not `live` still take part in
// the reduction's barriers.
template <typename T, int VEC, bool RSQRT, bool ACCUM, bool GROUPED>
__device__ __forceinline__ void one_pass_row(
    const T* __restrict__ xr, const T* __restrict__ rr,
    const float* __restrict__ w, T* __restrict__ yr, T* __restrict__ ro,
    bool live, int d, float eps, float* r_s, float* scratch) {
  float ss = 0.f;
  if (live) {
    for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
      float s[VEC];
      add_rows<T, VEC, ACCUM>(xr, rr, i, s);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        r_s[i + k] = s[k];
        ss += s[k] * s[k];
      }
      store_row<T, VEC>(ro, i, s);
    }
  }
  float total;
  if constexpr (GROUPED) {
    total = group_sum(ss, scratch);
  } else {
    total = repro::block_sum(ss, scratch);
  }
  const float inv = inv_rms<RSQRT>(total, d, eps);
  if (live) {
    // each thread reads back only the r' entries it wrote itself
    for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
      float out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] = r_s[i + k] * inv * w[i + k];
      store_row<T, VEC>(yr, i, out);
    }
  }
}

// GROUPED = false: one row per block (blockIdx.x), the whole block on it.
// GROUPED = true: block_rows rows per block, blockDim.y of them at a time.
template <typename T, int VEC, bool RSQRT, bool ACCUM, bool GROUPED>
__global__ void one_pass_kernel(const T* __restrict__ x,
                                const T* __restrict__ res,
                                const float* __restrict__ w,
                                T* __restrict__ y, T* __restrict__ res_out,
                                int rows, int d, float eps, int block_rows) {
  extern __shared__ float smem[];
  if constexpr (!GROUPED) {
    const long long base = static_cast<long long>(blockIdx.x) * d;
    one_pass_row<T, VEC, RSQRT, ACCUM, false>(
        x + base, res + base, w, y + base, res_out + base, true, d, eps,
        smem, smem + d);
  } else {
    float* r_s = smem + threadIdx.y * d;     // r' of this group's row
    float* scratch = smem + blockDim.y * d;  // one partial per warp
    const int row0 = blockIdx.x * block_rows;
    const int row_end = min(rows, row0 + block_rows);
    for (int first = row0; first < row_end; first += blockDim.y) {
      const int row = first + threadIdx.y;
      const long long base = static_cast<long long>(row) * d;
      one_pass_row<T, VEC, RSQRT, ACCUM, true>(
          x + base, res + base, w, y + base, res_out + base, row < row_end,
          d, eps, r_s, scratch);
    }
  }
}

template <typename T, int VEC, bool ACCUM>
__global__ void pass1_kernel(const T* __restrict__ x,
                             const T* __restrict__ res,
                             T* __restrict__ res_out,
                             float* __restrict__ sumsq, int rows, int d,
                             int block_rows) {
  extern __shared__ float scratch[];
  const int row0 = blockIdx.x * block_rows;
  const int row_end = min(rows, row0 + block_rows);
  for (int first = row0; first < row_end; first += blockDim.y) {
    const int row = first + threadIdx.y;
    const bool live = row < row_end;
    const long long base = static_cast<long long>(row) * d;
    float ss = 0.f;
    if (live) {
      for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
        float s[VEC];
        add_rows<T, VEC, ACCUM>(x + base, res + base, i, s);
#pragma unroll
        for (int k = 0; k < VEC; ++k) ss += s[k] * s[k];
        store_row<T, VEC>(res_out + base, i, s);
      }
    }
    const float total = group_sum(ss, scratch);
    if (live && threadIdx.x == 0) sumsq[row] = total;
  }
}

template <typename T, int VEC, bool RSQRT>
__global__ void pass2_kernel(const T* __restrict__ res_out,
                             const float* __restrict__ sumsq,
                             const float* __restrict__ w, T* __restrict__ y,
                             int rows, int d, float eps, int block_rows) {
  const int row0 = blockIdx.x * block_rows;
  const int row_end = min(rows, row0 + block_rows);
  for (int row = row0 + threadIdx.y; row < row_end; row += blockDim.y) {
    const long long base = static_cast<long long>(row) * d;
    const float inv = inv_rms<RSQRT>(sumsq[row], d, eps);
    for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
      float r[VEC];
      if constexpr (VEC > 1) {
        load_vec<T, VEC>(res_out + base + i, r);
      } else {
        r[0] = to_f(res_out[base + i]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = r[k] * inv * w[i + k];
      store_row<T, VEC>(y + base, i, r);
    }
  }
}

struct Args {
  const void* x;
  const void* res;
  const float* w;
  void* y;
  void* res_out;
  float* sumsq;
  int rows, d;
  float eps;
  int tpr, groups, block_rows;
  cudaStream_t stream;
};

template <typename T, int VEC, bool TWO_PASS, bool RSQRT, bool ACCUM,
          bool GROUPED>
int launch(const Args& a) {
  const dim3 block(a.tpr, a.groups);
  const int grid = (a.rows + a.block_rows - 1) / a.block_rows;
  const size_t scratch = 32 * sizeof(float);
  auto x = static_cast<const T*>(a.x);
  auto res = static_cast<const T*>(a.res);
  auto y = static_cast<T*>(a.y);
  auto res_out = static_cast<T*>(a.res_out);
  if constexpr (!TWO_PASS) {
    const size_t smem =
        static_cast<size_t>(a.groups) * a.d * sizeof(float) + scratch;
    auto kernel = one_pass_kernel<T, VEC, RSQRT, ACCUM, GROUPED>;
    int err = repro::allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, block, smem, a.stream>>>(x, res, a.w, y, res_out, a.rows,
                                            a.d, a.eps, a.block_rows);
    return static_cast<int>(cudaGetLastError());
  } else {
    pass1_kernel<T, VEC, ACCUM><<<grid, block, scratch, a.stream>>>(
        x, res, res_out, a.sumsq, a.rows, a.d, a.block_rows);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    pass2_kernel<T, VEC, RSQRT><<<grid, block, 0, a.stream>>>(
        res_out, a.sumsq, a.w, y, a.rows, a.d, a.eps, a.block_rows);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int VEC>
int dispatch(const Args& a, bool two_pass, bool rsqrt, bool accum) {
  return repro::with_bool(two_pass, [&](auto t) {
    return repro::with_bool(rsqrt, [&](auto r) {
      return repro::with_bool(accum, [&](auto f) {
        return repro::with_bool(a.block_rows > 1, [&](auto g) {
          return launch<T, VEC, decltype(t)::value, decltype(r)::value,
                        decltype(f)::value, decltype(g)::value>(a);
        });
      });
    });
  });
}

}  // namespace

// x, res, y, res_out: [rows, d] contiguous in `dtype`; w: [d] fp32;
// sumsq: [rows] fp32 scratch (read only by the two-pass form). `vec` is 1
// or the 16-byte width of the dtype (the wrapper checks the width and the
// pointers' alignment); a block is tpr x groups threads (tpr a multiple of
// 32, at most 1024 in all) and takes block_rows rows. Launches one kernel,
// or two when two_pass is 1.
extern "C" int repro_fused_add_rmsnorm(const void* x, const void* res,
                                       const void* w, void* y, void* res_out,
                                       void* sumsq, int rows, int d,
                                       float eps, int dtype, int vec,
                                       int tpr, int groups, int block_rows,
                                       int two_pass, int rsqrt, int accum,
                                       void* stream) {
  if (tpr < 32 || tpr % 32 || groups < 1 || tpr * groups > 1024 ||
      block_rows < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Args a{x, res, static_cast<const float*>(w), y, res_out,
               static_cast<float*>(sumsq), rows, d, eps, tpr, groups,
               block_rows, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kBFloat16) {
    return vec == 8 ? dispatch<__nv_bfloat16, 8>(a, two_pass, rsqrt, accum)
                    : dispatch<__nv_bfloat16, 1>(a, two_pass, rsqrt, accum);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4 ? dispatch<float, 4>(a, two_pass, rsqrt, accum)
                    : dispatch<float, 1>(a, two_pass, rsqrt, accum);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
