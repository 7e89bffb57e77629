// SwiGLU gate for Hopper: out = silu(x[:, :d]) * x[:, d:].
//
// Replaces the TPU kernel src/repro/kernels/silu_and_mul.py: silu_and_mul
// (body _kernel, in its fused_split form).
//
// What bounds it on the H100: bytes. It reads 2d and writes d elements
// per row and does ~5 flops and one exp per element. At decode (8 rows of
// 4864) the call moves ~230 KB in bf16 and is launch bound; at prefill
// (256 rows) it moves ~7.5 MB.
//
// Design: elementwise over [rows, 2d]. Gate and up are read in place from
// the one input buffer (no slice copies), 16 bytes at a time when d and
// the pointers allow it, else one element at a time. Math is fp32 with
// expf and a true divide, z / (1 + e^{-z}) * up, cast back on store.
// Blocks stride over rows (grid.y) and column vectors (grid.x).
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_vec;
using repro::store_vec;
using repro::to_f;

template <typename T, int VEC>
__global__ void silu_and_mul_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int rows, int d) {
  const int n_vec = d / VEC;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* gate = x + row * 2 * d;
    const T* up = gate + d;
    T* o = out + row * d;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n_vec;
         c += gridDim.x * blockDim.x) {
      const int i = c * VEC;
      float g[VEC], u[VEC];
      if constexpr (VEC > 1) {
        load_vec<T, VEC>(gate + i, g);
        load_vec<T, VEC>(up + i, u);
      } else {
        g[0] = to_f(gate[i]);
        u[0] = to_f(up[i]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) g[k] = g[k] / (1.0f + expf(-g[k])) * u[k];
      if constexpr (VEC > 1) {
        store_vec<T, VEC>(o + i, g);
      } else {
        o[i] = from_f<T>(g[0]);
      }
    }
  }
}

constexpr int kThreads = 256;

template <typename T, int VEC>
int launch(const void* x, void* out, int rows, int d, cudaStream_t stream) {
  const int n_vec = d / VEC;
  dim3 grid((n_vec + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
  silu_and_mul_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows, 2d] contiguous, out: [rows, d] contiguous, both in `dtype`.
// `vec` is 1 or the 16-byte width of the dtype (the wrapper checks that it
// divides d and that the pointers are 16-byte aligned).
extern "C" int repro_silu_and_mul(const void* x, void* out, int rows, int d,
                                  int dtype, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    return vec == 8 ? launch<__nv_bfloat16, 8>(x, out, rows, d, s)
                    : launch<__nv_bfloat16, 1>(x, out, rows, d, s);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4 ? launch<float, 4>(x, out, rows, d, s)
                    : launch<float, 1>(x, out, rows, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
