// Helpers shared by the port's CUDA kernels: fp32 <-> storage-type
// conversion, 16-byte vector loads and stores, warp- and block-wide
// reductions, and the dispatch of run-time genome flags to template
// instantiations.
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block: warp shuffles, then one partial per warp in
// `scratch` (>= 32 floats of shared memory), then warp 0. blockDim.x must
// be a multiple of 32. Every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
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

}  // namespace repro
