// LSE merge of two partial attention states for Hopper (paper Kernel 1):
//
//   V = (e^{Sa} Va + e^{Sb} Vb) / (e^{Sa} + e^{Sb}),  S = log(e^{Sa} + e^{Sb})
//
// Replaces the TPU kernel src/repro/kernels/merge_attn_states.py:
// merge_attn_states_lse (bodies _kernel and _s_out_kernel).
//
// The weights are formed as the JAX package forms them: m = max(Sa, Sb),
// m_safe = 0 when m = -inf, w = e^{S - m_safe}, and both weights 0 when
// their sum is 0. So a row whose two sides are empty gives V = 0 and
// S = -inf exactly, and no NaN can appear.
//
// What bounds it on the H100: bytes. A call reads Va, Vb and writes V
// (3 * rows * d elements) plus 12 bytes of scores per row; hoisted, it does
// ~3 fp32 instructions per element. At [768, 32, 256] bf16 that is 37.7 MB,
// 11.3 us at 3.35 TB/s. Recomputing the weights for every element (the
// paper's baseline) adds two expf and two divides per element, ~4
// special-function instructions, which is about as much time again.
//
// Design: rows are seq * heads. One warp takes a row; its lanes stride over
// the row in 16-byte vectors (8 bf16 or 4 fp32) when d and the pointers
// allow, else one element at a time. A block has block_rows warps and
// covers block_rows rows (warps loop if the grid is short). Genome flags
// are template parameters, every combination instantiated:
//   HOIST   weights once per row, kept in registers; else recomputed for
//           every element (an empty volatile asm on the scores keeps nvcc
//           from hoisting the recomputation itself);
//   RCP     __frcp_rn(denom) and two multiplies; else two IEEE divides;
//   FUSE_S  S written by lane 0 of each row's warp; else by a second
//           kernel from this file (two launches).
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_vec;
using repro::lse_score;
using repro::lse_weights;
using repro::store_vec;
using repro::to_f;
using repro::Weights;

template <typename T, int VEC, bool HOIST, bool RCP, bool FUSE_S>
__global__ void merge_kernel(const T* __restrict__ va,
                             const float* __restrict__ sa,
                             const T* __restrict__ vb,
                             const float* __restrict__ sb,
                             T* __restrict__ vo, float* __restrict__ so,
                             int rows, int d, int block_rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_vec = d / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * block_rows;
  for (long long row = static_cast<long long>(blockIdx.x) * block_rows + warp;
       row < rows; row += stride) {
    const float a_s = sa[row];
    const float b_s = sb[row];
    const long long base = row * d;
    Weights w{0.f, 0.f};
    if constexpr (HOIST) w = lse_weights<RCP>(a_s, b_s);
    for (int c = lane; c < n_vec; c += 32) {
      const long long i = base + static_cast<long long>(c) * VEC;
      float x[VEC], y[VEC];
      if constexpr (VEC > 1) {
        load_vec<T, VEC>(va + i, x);
        load_vec<T, VEC>(vb + i, y);
      } else {
        x[0] = to_f(va[i]);
        y[0] = to_f(vb[i]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if constexpr (!HOIST) {
          float p = a_s, q = b_s;
          asm volatile("" : "+f"(p), "+f"(q));
          w = lse_weights<RCP>(p, q);
        }
        x[k] = w.a * x[k] + w.b * y[k];
      }
      if constexpr (VEC > 1) {
        store_vec<T, VEC>(vo + i, x);
      } else {
        vo[i] = from_f<T>(x[0]);
      }
    }
    if constexpr (FUSE_S) {
      if (lane == 0) so[row] = lse_score(a_s, b_s);
    }
  }
}

__global__ void merge_s_out_kernel(const float* __restrict__ sa,
                                   const float* __restrict__ sb,
                                   float* __restrict__ so, int rows) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    so[i] = lse_score(sa[i], sb[i]);
  }
}

constexpr int kScoreThreads = 256;

template <typename T, int VEC, bool HOIST, bool RCP, bool FUSE_S>
int launch(const void* va, const float* sa, const void* vb, const float* sb,
           void* vo, float* so, int rows, int d, int block_rows,
           cudaStream_t stream) {
  const int grid = (rows + block_rows - 1) / block_rows;
  merge_kernel<T, VEC, HOIST, RCP, FUSE_S><<<grid, 32 * block_rows, 0,
                                             stream>>>(
      static_cast<const T*>(va), sa, static_cast<const T*>(vb), sb,
      static_cast<T*>(vo), so, rows, d, block_rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err || FUSE_S) return err;
  merge_s_out_kernel<<<(rows + kScoreThreads - 1) / kScoreThreads,
                       kScoreThreads, 0, stream>>>(sa, sb, so, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch(const void* va, const float* sa, const void* vb, const float* sb,
             void* vo, float* so, int rows, int d, int block_rows,
             bool hoist, bool rcp, bool fuse_s, cudaStream_t stream) {
  return repro::with_bool(hoist, [&](auto h) {
    return repro::with_bool(rcp, [&](auto r) {
      return repro::with_bool(fuse_s, [&](auto f) {
        return launch<T, VEC, decltype(h)::value, decltype(r)::value,
                      decltype(f)::value>(va, sa, vb, sb, vo, so, rows, d,
                                          block_rows, stream);
      });
    });
  });
}

}  // namespace

// va, vb, vo: [rows, d] contiguous in `dtype`; sa, sb, so: [rows] fp32.
// `vec` is 1 or the 16-byte width of the dtype (the wrapper checks that it
// divides d and that the pointers are 16-byte aligned); 32 * block_rows
// <= 1024. Launches one kernel, or two when fuse_s is 0.
extern "C" int repro_merge_attn_states(const void* va, const void* sa,
                                       const void* vb, const void* sb,
                                       void* vo, void* so, int rows, int d,
                                       int dtype, int vec, int block_rows,
                                       int hoist, int rcp, int fuse_s,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(sa);
  auto fb = static_cast<const float*>(sb);
  auto fo = static_cast<float*>(so);
  if (block_rows < 1 || 32 * block_rows > 1024) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (dtype == repro::kBFloat16) {
    return vec == 8
        ? dispatch<__nv_bfloat16, 8>(va, fa, vb, fb, vo, fo, rows, d,
                                     block_rows, hoist, rcp, fuse_s, s)
        : dispatch<__nv_bfloat16, 1>(va, fa, vb, fb, vo, fo, rows, d,
                                     block_rows, hoist, rcp, fuse_s, s);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4
        ? dispatch<float, 4>(va, fa, vb, fb, vo, fo, rows, d, block_rows,
                             hoist, rcp, fuse_s, s)
        : dispatch<float, 1>(va, fa, vb, fb, vo, fo, rows, d, block_rows,
                             hoist, rcp, fuse_s, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
