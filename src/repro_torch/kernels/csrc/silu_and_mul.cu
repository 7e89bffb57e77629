// SwiGLU gate for Hopper: out = silu(gate) * up, gate = x[:, :d],
// up = x[:, d:].
//
// Replaces the TPU kernel src/repro/kernels/silu_and_mul.py: silu_and_mul
// (body _kernel).
//
// What bounds it on the H100: bytes. It reads 2d and writes d elements
// per row and does ~5 flops and one exp per element. At decode (8 rows of
// 4864) the call moves ~230 KB in bf16 and is launch bound; at prefill
// (256 rows) it moves ~7.5 MB.
//
// Design: elementwise. A block of `threads` threads walks its rows (up to
// block_rows; one while the grid fits the card in one wave) and,
// in each, its thread's 16-byte vectors of columns (8 bf16 or 4 fp32) when
// d and the pointers allow, else single elements. Gate and up are read
// through their own pointers and a row stride: in place from the one
// [rows, 2d] buffer (stride 2d, the shipped form), or from the two copies
// the wrapper made (stride d, the baseline's materialised split).
// Genome flags are template parameters, every combination instantiated:
//   FP32  math in fp32, one rounding on store; else every operation is
//         rounded to the storage type, as bf16 arithmetic does;
//   RCP   z * __frcp_rn(1 + e^{-z}) * up; else z / (1 + e^{-z}) * up;
//   EXP2  e^{-z} as exp2f(-z * log2 e); else expf(-z).
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_vec;
using repro::store_vec;
using repro::to_f;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, bool FP32, bool RCP, bool EXP2>
__device__ __forceinline__ float silu_mul(float g, float u) {
  auto r = [](float v) { return FP32 ? v : repro::round_to<T>(v); };
  const float e = EXP2 ? r(exp2f(r(-g * kLog2e))) : r(expf(-g));
  const float den = r(1.f + e);
  if constexpr (RCP) {
    return r(r(g * r(__frcp_rn(den))) * u);
  } else {
    return r(r(g / den) * u);
  }
}

template <typename T, int VEC, bool FP32, bool RCP, bool EXP2>
__global__ void silu_and_mul_kernel(const T* __restrict__ gate,
                                    const T* __restrict__ up,
                                    T* __restrict__ out, int rows, int d,
                                    long long in_stride, int block_rows) {
  const int n_vec = d / VEC;
  const int row0 = blockIdx.y * block_rows;
  const int row_end = min(rows, row0 + block_rows);
  for (long long row = row0; row < row_end; ++row) {
    const T* g_row = gate + row * in_stride;
    const T* u_row = up + row * in_stride;
    T* o = out + row * d;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n_vec;
         c += gridDim.x * blockDim.x) {
      const int i = c * VEC;
      float g[VEC], u[VEC];
      if constexpr (VEC > 1) {
        load_vec<T, VEC>(g_row + i, g);
        load_vec<T, VEC>(u_row + i, u);
      } else {
        g[0] = to_f(g_row[i]);
        u[0] = to_f(u_row[i]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        g[k] = silu_mul<T, FP32, RCP, EXP2>(g[k], u[k]);
      }
      if constexpr (VEC > 1) {
        store_vec<T, VEC>(o + i, g);
      } else {
        o[i] = from_f<T>(g[0]);
      }
    }
  }
}

template <typename T, int VEC>
int dispatch(const void* gate, const void* up, void* out, int rows, int d,
             long long in_stride, int threads, int block_rows, bool fp32,
             bool rcp, bool exp2, cudaStream_t stream) {
  const int n_vec = d / VEC;
  const dim3 grid((n_vec + threads - 1) / threads,
                  (rows + block_rows - 1) / block_rows);
  return repro::with_bool(fp32, [&](auto f) {
    return repro::with_bool(rcp, [&](auto r) {
      return repro::with_bool(exp2, [&](auto e) {
        silu_and_mul_kernel<T, VEC, decltype(f)::value, decltype(r)::value,
                            decltype(e)::value><<<grid, threads, 0, stream>>>(
            static_cast<const T*>(gate), static_cast<const T*>(up),
            static_cast<T*>(out), rows, d, in_stride, block_rows);
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
}

}  // namespace

// gate, up: rows of d elements `in_stride` apart (2d in place, d for
// copies); out: [rows, d] contiguous; all in `dtype`. `vec` is 1 or the
// 16-byte width of the dtype (the wrapper checks that it divides d and
// that the pointers are 16-byte aligned). A block is `threads` threads
// (at most 1024) and takes block_rows rows (at most 65,535 row blocks).
extern "C" int repro_silu_and_mul(const void* gate, const void* up,
                                  void* out, int rows, int d,
                                  long long in_stride, int dtype, int vec,
                                  int threads, int block_rows, int fp32,
                                  int rcp, int exp2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (threads < 1 || threads > 1024 || block_rows < 1 ||
      (rows + block_rows - 1) / block_rows > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (dtype == repro::kBFloat16) {
    return vec == 8
        ? dispatch<__nv_bfloat16, 8>(gate, up, out, rows, d, in_stride,
                                     threads, block_rows, fp32, rcp, exp2, s)
        : dispatch<__nv_bfloat16, 1>(gate, up, out, rows, d, in_stride,
                                     threads, block_rows, fp32, rcp, exp2, s);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4
        ? dispatch<float, 4>(gate, up, out, rows, d, in_stride, threads,
                             block_rows, fp32, rcp, exp2, s)
        : dispatch<float, 1>(gate, up, out, rows, d, in_stride, threads,
                             block_rows, fp32, rcp, exp2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
