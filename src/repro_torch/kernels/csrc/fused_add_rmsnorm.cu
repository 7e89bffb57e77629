// Fused residual add + RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_add_rmsnorm.py:
// fused_add_rmsnorm (the one-pass body _one_pass_kernel).
//
//   r' = x + r (fp32);  y = r' * rsqrt(mean(r'^2) + eps) * w
//   returns y and r', both in the input dtype; w is fp32.
//
// What bounds it on the H100: bytes. Per row it reads x and r and writes y
// and r' (4 * d elements) plus the d fp32 weights, and does ~5 flops per
// element, far below the ~295 flops/byte the card needs to be compute
// bound. At decode (8 rows of 896) the whole call moves ~60 KB, so it is
// launch bound in practice.
//
// Design: one block per row. Each thread reads x and r with 16-byte
// vector loads (8 bf16 or 4 fp32), keeps r' in fp32 in shared memory and
// writes r' out at once; the sum of squares is reduced with warp shuffles
// and then across warps through shared memory; the normalisation then
// reads r' back from shared memory, not from device memory. So each byte
// of the call crosses device memory once. Rows whose width or pointers do
// not allow 16-byte vectors take the scalar loop of the same kernel.
#include "common.cuh"

namespace {

using repro::block_sum;
using repro::from_f;
using repro::load_vec;
using repro::store_vec;
using repro::to_f;

template <typename T, int VEC>
__global__ void fused_add_rmsnorm_kernel(const T* __restrict__ x,
                                         const T* __restrict__ res,
                                         const float* __restrict__ w,
                                         T* __restrict__ y,
                                         T* __restrict__ res_out, int d,
                                         float eps) {
  extern __shared__ float smem[];
  float* r_s = smem;           // d floats: r' of this row
  float* scratch = smem + d;   // 32 floats: per-warp partial sums
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  const T* rr = res + base;
  T* yr = y + base;
  T* ro = res_out + base;

  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
    float xv[VEC], rv[VEC];
    if constexpr (VEC > 1) {
      load_vec<T, VEC>(xr + i, xv);
      load_vec<T, VEC>(rr + i, rv);
    } else {
      xv[0] = to_f(xr[i]);
      rv[0] = to_f(rr[i]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float s = xv[k] + rv[k];
      r_s[i + k] = s;
      ss += s * s;
      xv[k] = s;
    }
    if constexpr (VEC > 1) {
      store_vec<T, VEC>(ro + i, xv);
    } else {
      ro[i] = from_f<T>(xv[0]);
    }
  }
  const float inv = rsqrtf(block_sum(ss, scratch) / d + eps);
  // each thread reads back only the r' entries it wrote itself
  for (int i = threadIdx.x * VEC; i < d; i += blockDim.x * VEC) {
    float out[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = r_s[i + k] * inv * w[i + k];
    if constexpr (VEC > 1) {
      store_vec<T, VEC>(yr + i, out);
    } else {
      yr[i] = from_f<T>(out[0]);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* res, const float* w, void* y,
           void* res_out, int rows, int d, float eps, int threads,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(d) + 32) * sizeof(float);
  auto kernel = fused_add_rmsnorm_kernel<T, VEC>;
  int err = repro::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), w,
      static_cast<T*>(y), static_cast<T*>(res_out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, y, res_out: [rows, d] contiguous in `dtype`; w: [d] fp32.
// `vec` is 1 or the 16-byte width of the dtype (the wrapper checks the
// width and the pointers' alignment); `threads` is a multiple of 32.
extern "C" int repro_fused_add_rmsnorm(const void* x, const void* res,
                                       const void* w, void* y,
                                       void* res_out, int rows, int d,
                                       float eps, int dtype, int vec,
                                       int threads, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  if (dtype == repro::kBFloat16) {
    return vec == 8 ? launch<__nv_bfloat16, 8>(x, res, wf, y, res_out, rows,
                                                d, eps, threads, s)
                    : launch<__nv_bfloat16, 1>(x, res, wf, y, res_out, rows,
                                                d, eps, threads, s);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4 ? launch<float, 4>(x, res, wf, y, res_out, rows, d, eps,
                                       threads, s)
                    : launch<float, 1>(x, res, wf, y, res_out, rows, d, eps,
                                       threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
