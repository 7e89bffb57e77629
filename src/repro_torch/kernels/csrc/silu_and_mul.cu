// SwiGLU gate for Hopper: out = silu(gate) * up, gate = x[:, :d],
// up = x[:, d:].
//
// Replaces the TPU kernel src/repro/kernels/silu_and_mul.py: silu_and_mul
// (body _kernel).
//
// What bounds it on the H100: bytes. It reads 2d and writes d elements
// per row and does ~5 flops and one exp per element. At decode (8 rows of
// 4864) the call moves ~230 KB in bf16 and what counts is the chain of
// launch, one round trip and the stores; at prefill (4,096 rows of 6912)
// it moves 170 MB, and what counts is keeping enough loads in flight.
//
// Design: elementwise. A thread owns one 16-byte vector column (8 bf16 or
// 4 fp32; one element when d or the pointers do not allow it) and walks
// steps of BR consecutive rows: it sends out the gate and up loads of all BR
// rows before any arithmetic (2 * BR loads in flight), then computes and
// stores them. Consecutive threads take consecutive columns, so a warp
// reads whole rows. The grid is (column blocks, step blocks); the wrapper
// sizes the step blocks (silu_and_mul.py: launch_shape) to what the card's
// thread limits hold beside the column blocks, at most one a step, and
// each walks steps a grid apart, so a prefill call runs in one wave; no
// thread divides to find its place. Gate and up are read
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
using repro::load_raw;
using repro::Raw;

constexpr float kLog2e = 1.4426950408889634f;

// Threads a block may have: the raw loads of a step take 2 * BR * (16 /
// 4) registers a thread (BR * 8), held to 64 registers at 1,024 threads,
// 128 at 512, 255 at 256. The wrapper applies the same rule
// (silu_and_mul.py: block_limit).
template <int VEC, int BR>
constexpr int max_threads() {
  return VEC == 1 || BR <= 4 ? 1024 : BR == 8 ? 512 : 256;
}

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

template <typename T, int VEC, int BR, bool FP32, bool RCP, bool EXP2>
__global__ void __launch_bounds__(max_threads<VEC, BR>())
    silu_and_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                        T* __restrict__ out, int rows, int d,
                        long long in_stride) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int steps = (rows + BR - 1) / BR;
  if (col >= d) return;
  for (int step = blockIdx.y; step < steps; step += gridDim.y) {
    const int row0 = step * BR;
    Raw<T, VEC> g[BR], u[BR];
#pragma unroll
    for (int k = 0; k < BR; ++k) {
      if (row0 + k < rows) {
        const long long off =
            static_cast<long long>(row0 + k) * in_stride + col;
        load_raw(gate + off, g[k]);
        load_raw(up + off, u[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < BR; ++k) {
      if (row0 + k < rows) {
        Raw<T, VEC> o;
        T* e = reinterpret_cast<T*>(o.w);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          e[j] = from_f<T>(silu_mul<T, FP32, RCP, EXP2>(g[k][j], u[k][j]));
        }
        T* dst = out + static_cast<long long>(row0 + k) * d + col;
        if constexpr (VEC > 1) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(o.w);
        } else {
          *dst = e[0];
        }
      }
    }
  }
}

struct Args {
  const void* gate;
  const void* up;
  void* out;
  int rows, d;
  long long in_stride;
  int threads, step_blocks;
  cudaStream_t stream;
};

template <typename T, int VEC, int BR, bool FP32, bool RCP, bool EXP2>
int launch(const Args& a) {
  if (a.threads > max_threads<VEC, BR>()) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int col_blocks = (a.d / VEC + a.threads - 1) / a.threads;
  silu_and_mul_kernel<T, VEC, BR, FP32, RCP, EXP2>
      <<<dim3(col_blocks, a.step_blocks), a.threads, 0, a.stream>>>(
          static_cast<const T*>(a.gate), static_cast<const T*>(a.up),
          static_cast<T*>(a.out), a.rows, a.d, a.in_stride);
  return static_cast<int>(cudaGetLastError());
}

// The BR instantiation: 1, 2, 4, 8 or 16 rows a step.
template <typename F>
int with_br(int br, F&& f) {
  switch (br) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return static_cast<int>(cudaErrorInvalidConfiguration);
  }
}

template <typename T, int VEC>
int dispatch(const Args& a, int br, bool fp32, bool rcp, bool exp2) {
  return with_br(br, [&](auto b) {
    return repro::with_bool(fp32, [&](auto f) {
      return repro::with_bool(rcp, [&](auto r) {
        return repro::with_bool(exp2, [&](auto e) {
          return launch<T, VEC, decltype(b)::value, decltype(f)::value,
                        decltype(r)::value, decltype(e)::value>(a);
        });
      });
    });
  });
}

}  // namespace

// gate, up: rows of d elements `in_stride` apart (2d in place, d for
// copies); out: [rows, d] contiguous; all in `dtype`. `vec` is 1 or the
// 16-byte width of the dtype (the wrapper checks that it divides d and
// that the pointers are 16-byte aligned). A block is `threads` threads, a
// thread's step `block_rows` rows (1, 2, 4, 8 or 16); the grid is the
// column blocks by `step_blocks` (any count from 1 is correct: the steps
// are walked a grid apart).
extern "C" int repro_silu_and_mul(const void* gate, const void* up,
                                  void* out, int rows, int d,
                                  long long in_stride, int dtype, int vec,
                                  int threads, int block_rows,
                                  int step_blocks, int fp32, int rcp,
                                  int exp2, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || step_blocks < 1 ||
      step_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Args a{gate, up, out, rows, d, in_stride, threads, step_blocks,
               static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kBFloat16) {
    return vec == 8
        ? dispatch<__nv_bfloat16, 8>(a, block_rows, fp32, rcp, exp2)
        : dispatch<__nv_bfloat16, 1>(a, block_rows, fp32, rcp, exp2);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4 ? dispatch<float, 4>(a, block_rows, fp32, rcp, exp2)
                    : dispatch<float, 1>(a, block_rows, fp32, rcp, exp2);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
