// Single-token GQA decode attention over a contiguous KV cache, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:
// flash_decode_attention (body _kernel with the helpers _init_carry,
// _online_softmax_step and _finalize_output).
//
//   q [b, hq, d]; k, v [b, s, hkv, d] (one layer of the [L, B, S, Hkv, d]
//   cache); kv_len [b] int32, clamped to [0, s]; out [b, hq, d].
//   The Pallas grid walks the cache in steps of `chunk` rows (s padded
//   with zero rows to a multiple of it) with an fp32 online-softmax carry
//   (acc, m, l); rows >= kv_len score -1e30; out is acc / l, or 0 where
//   l = 0.
//
// What bounds it on the H100: bytes. Each K and V row of every kv head is
// read once and serves the whole query group (4 heads at h2o-danube-1.8b's
// width), ~4 * group flops per element read. At the h2o decode shape (8
// requests, a 4096-row ring, 8 kv heads of 80) the call moves 83.9 MB,
// more than the 50 MB L2: 25.0 us at 3.35 TB/s.
//
// Design: the split-KV walk of common.cuh (repro::decode::walk). A step is
// one `chunk`; a block takes `steps_per_split` of them, so at the h2o
// decode shape 64 (kv head, request) pairs become a few hundred blocks in
// one wave instead of 64 blocks that each walk 4096 rows. Genome flags are
// template parameters, every combination instantiated:
//   MASK_OOB  visit only the chunks below kv_len and copy only rows below
//             it; else every chunk of the cache is read and masked, as the
//             Pallas baseline's grid walks every chunk;
//   RCP       out = acc * __frcp_rn(l); else out = acc / l.
// Rows the kernel does not copy (past s, or past kv_len under MASK_OOB)
// are zero in the staged tile, the zero padding of the Pallas kernel, so
// every genome gives the Pallas kernel's result, kv_len = 0 included.
// Nothing is padded in device memory: s need not be a multiple of chunk.
// Any group size and any head_dim up to 256 work.
#include "common.cuh"

namespace {

namespace dec = repro::decode;

// Rows of one (request, kv head) in the contiguous cache.
template <typename T>
struct DenseRows {
  const T* k;
  const T* v;
  long long row_stride;  // hkv * d

  __device__ __forceinline__ long long off(int t) const {
    return t * row_stride;
  }
  __device__ __forceinline__ void load(dec::Span, int, int*) {}
};

template <typename T, int VEC, int DMAX, bool MASK_OOB, bool RCP>
__global__ void __launch_bounds__(dec::kThreads, dec::kMinBlocks)
    flash_decode_kernel(dec::Args a, const T* __restrict__ k,
                        const T* __restrict__ v, int s) {
  const dec::Coords c = dec::coords(a);
  const long long rs = static_cast<long long>(a.hkv) * a.d;
  const long long off = static_cast<long long>(c.b) * s * rs +
                        static_cast<long long>(c.h) * a.d;
  DenseRows<T> rows{k + off, v + off, rs};
  dec::walk<T, VEC, DMAX, MASK_OOB, RCP>(a, c, rows);
}

// Launches the wrapper's plan: `smem` must be the block's layout.
template <typename T, int VEC, int DMAX, bool MASK_OOB, bool RCP>
int launch(dec::Args a, const void* k, const void* v, int b, int s,
           size_t smem, cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  constexpr bool mma = dec::kMmaWalk<T, VEC>;
  if (smem != dec::smem_bytes(mma, group, a.d, a.step, a.lds, sizeof(T),
                              0) ||
      smem > dec::kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.stages = dec::ring_stages(mma, group, a.d, a.lds, sizeof(T), 0);
  auto kernel = flash_decode_kernel<T, VEC, DMAX, MASK_OOB, RCP>;
  int err = repro::allow_smem(kernel, smem);
  if (err) return err;
  const int n_qsub = (group + dec::kGroup - 1) / dec::kGroup;
  dim3 grid(a.hkv * n_qsub, b, a.splits);
  kernel<<<grid, dec::kThreads, smem, stream>>>(
      a, static_cast<const T*>(k), static_cast<const T*>(v), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch(const dec::Args& a, const void* k, const void* v, int b, int s,
             size_t smem, bool mask_oob, bool rcp, cudaStream_t stream) {
  return dec::with_dmax<T, VEC>(a.d, [&](auto dm) {
    return repro::with_bool(mask_oob, [&](auto mo) {
      return repro::with_bool(rcp, [&](auto r) {
        return launch<T, VEC, decltype(dm)::value, decltype(mo)::value,
                      decltype(r)::value>(a, k, v, b, s, smem, stream);
      });
    });
  });
}

}  // namespace

// All tensors contiguous; q, k, v and out in `dtype`, kv_len int32. hq must
// be a multiple of hkv, d at most 256, 1 <= chunk <= s (the wrapper checks
// all three). `vec` is 1 or the 16-byte width of the dtype (the wrapper
// checks that it divides d and that k and v are 16-byte aligned); `lds`,
// the tile row stride in elements, is at least d, and with vec > 1 a
// multiple of it. The chunks split into `splits` ranges of
// `steps_per_split`, every range non-empty; with splits > 1, part_acc
// ([b, hq, splits, d] fp32), part_ml ([b, hq, splits, 2] fp32) and
// counters ([b, hkv * ceil(group / 8)] int32, all 0) are device buffers.
// `smem` is the wrapper's figure for a block's shared memory
// (flash_decode.py: tile_layout); it is launched as given, and refused
// (cudaErrorInvalidValue) unless it is the layout the kernel uses and fits
// 227 KB. Returns the launch's CUDA error code.
extern "C" int repro_flash_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* part_acc, void* part_ml, void* counters, int b, int hq,
    int hkv, int d, int s, int chunk, int lds, int splits,
    int steps_per_split, int smem, float scale, int dtype, int vec,
    int mask_oob, int rcp, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int n_chunks = chunk > 0 ? (s + chunk - 1) / chunk : 0;
  if (chunk < 1 || lds < d || splits < 1 || steps_per_split < 1 ||
      static_cast<long long>(splits) * steps_per_split < n_chunks ||
      static_cast<long long>(splits - 1) * steps_per_split >= n_chunks ||
      (splits > 1 && (!part_acc || !part_ml || !counters)) || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dec::Args a{q, out, static_cast<const int*>(kv_len),
              static_cast<float*>(part_acc), static_cast<float*>(part_ml),
              static_cast<int*>(counters), hq, hkv, d, lds, chunk,
              n_chunks * chunk, s, splits, steps_per_split, 0, scale};
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == repro::kBFloat16) {
    return vec == 8
        ? dispatch<__nv_bfloat16, 8>(a, k, v, b, s, sm, mask_oob, rcp, st)
        : dispatch<__nv_bfloat16, 1>(a, k, v, b, s, sm, mask_oob, rcp, st);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4
        ? dispatch<float, 4>(a, k, v, b, s, sm, mask_oob, rcp, st)
        : dispatch<float, 1>(a, k, v, b, s, sm, mask_oob, rcp, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
