// Paged single-token GQA decode attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:
// paged_flash_decode_attention (body _paged_kernel with the helpers
// _init_carry, _online_softmax_step and _finalize_output).
//
//   q [b, hq, d]; k_pages, v_pages [P, page, hkv, d];
//   page_table [b, n_pt] int32; kv_len [b] int32; out [b, hq, d].
//   Logical row t of request b lives at row t % page of physical page
//   page_table[b, t / page]. The Pallas grid walks the table's logical
//   pages with an fp32 online-softmax carry; rows >= kv_len score -1e30;
//   out is acc / l, or 0 where l = 0.
//
// What bounds it on the H100: bytes. Each valid K and V row is read once
// (2 * d elements for every kv head) and used by the whole query group
// (7 heads at qwen2-0.5b's width), ~4 * group flops per element read. At
// decode (8 requests of a few hundred rows) the call moves ~0.4 MB: well
// under one launch's floor, so what counts is how many dependent memory
// round trips a block makes and how many SMs share the rows.
//
// Design: the split-KV walk of common.cuh (repro::decode::walk) with a
// step of `step` logical rows (64: 16 for each of the 4 warps), whatever
// the page size. A block loads its own slice of the page-table row into
// shared memory (the TPU's scalar prefetch becomes a plain load), and each
// warp gathers its rows through it with 16-byte cp.async copies into its
// three-slot ring. A table entry outside the pool reads the trap page 0,
// for memory safety only. Genome flags are template parameters, every
// combination instantiated:
//   MASK_OOB  visit and read only the rows below kv_len: nothing past it is
//             read (pages of other requests, the trap page);
//   else      read every row of the table and mask, as _paged_kernel walks
//             every logical page; with kv_len = 0 the result is then the
//             Pallas baseline's mean of V over the table's rows;
//   RCP       out = acc * __frcp_rn(l); else out = acc / l.
// Any group size, any page size and any head_dim up to 256 work.
#include "common.cuh"

namespace {

namespace dec = repro::decode;

// Rows of one (request, kv head) found through the page table.
template <typename T>
struct PagedRows {
  const T* k;             // the pools, offset to this kv head
  const T* v;
  const int* table;       // this request's row of the page table
  const int* slice;       // its pages [first, ...) in shared memory
  int first;
  int page, shift;        // shift = log2(page), or -1
  int n_pt, num_pages;
  long long row_stride;   // hkv * d

  __device__ __forceinline__ long long off(int t) const {
    const int pg = shift >= 0 ? t >> shift : t / page;
    return (static_cast<long long>(slice[pg - first]) * page + t - pg * page) *
           row_stride;
  }

  // The table entries of the block's steps, out-of-pool ones at page 0.
  __device__ __forceinline__ void load(dec::Span sp, int step, int* smem) {
    const long long lo = static_cast<long long>(sp.first) * step;
    const long long hi = static_cast<long long>(sp.last) * step;
    first = static_cast<int>(lo / page);
    const long long end = (hi + page - 1) / page;
    const int last = static_cast<int>(end < n_pt ? end : n_pt);
    for (int i = threadIdx.x; i < last - first; i += blockDim.x) {
      const int p = table[first + i];
      smem[i] = p < 0 || p >= num_pages ? 0 : p;
    }
    slice = smem;
  }
};

template <typename T, int VEC, int DMAX, bool MASK_OOB, bool RCP>
__global__ void __launch_bounds__(dec::kThreads, dec::kMinBlocks)
    paged_decode_kernel(dec::Args a, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ page_table, int page,
                        int shift, int n_pt, int num_pages) {
  const dec::Coords c = dec::coords(a);
  const long long hd = static_cast<long long>(c.h) * a.d;
  PagedRows<T> rows{k_pages + hd, v_pages + hd,
                    page_table + static_cast<long long>(c.b) * n_pt,
                    nullptr, 0, page, shift, n_pt, num_pages,
                    static_cast<long long>(a.hkv) * a.d};
  dec::walk<T, VEC, DMAX, MASK_OOB, RCP>(a, c, rows);
}

// Table entries a block loads at most: the pages its steps touch.
int slice_len(int step, int steps_per_split, int page, int n_pt) {
  const long long rows = static_cast<long long>(step) * steps_per_split;
  const long long n = (rows + page - 1) / page + 1;
  return static_cast<int>(n < n_pt ? n : n_pt);
}

// Launches the wrapper's plan: `a.extra_bytes` must hold the block's table
// slice and `smem` must be the block's layout.
template <typename T, int VEC, int DMAX, bool MASK_OOB, bool RCP>
int launch(dec::Args a, const void* k, const void* v, const int* table,
           int b, int page, int n_pt, int num_pages, size_t smem,
           cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  constexpr bool mma = dec::kMmaWalk<T, VEC>;
  if (a.extra_bytes < 4 * slice_len(a.step, a.steps_per_split, page, n_pt) ||
      smem != dec::smem_bytes(mma, group, a.d, a.step, a.lds, sizeof(T),
                              a.extra_bytes) ||
      smem > dec::kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.stages = dec::ring_stages(mma, group, a.d, a.lds, sizeof(T),
                              a.extra_bytes);
  auto kernel = paged_decode_kernel<T, VEC, DMAX, MASK_OOB, RCP>;
  int err = repro::allow_smem(kernel, smem);
  if (err) return err;
  int shift = -1;
  if ((page & (page - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < page) ++shift;
  }
  const int n_qsub = (group + dec::kGroup - 1) / dec::kGroup;
  dim3 grid(a.hkv * n_qsub, b, a.splits);
  kernel<<<grid, dec::kThreads, smem, stream>>>(
      a, static_cast<const T*>(k), static_cast<const T*>(v), table, page,
      shift, n_pt, num_pages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch(const dec::Args& a, const void* k, const void* v,
             const int* table, int b, int page, int n_pt, int num_pages,
             size_t smem, bool mask_oob, bool rcp, cudaStream_t stream) {
  return dec::with_dmax<T, VEC>(a.d, [&](auto dm) {
    return repro::with_bool(mask_oob, [&](auto mo) {
      return repro::with_bool(rcp, [&](auto r) {
        return launch<T, VEC, decltype(dm)::value, decltype(mo)::value,
                      decltype(r)::value>(a, k, v, table, b, page, n_pt,
                                          num_pages, smem, stream);
      });
    });
  });
}

}  // namespace

// All tensors contiguous; q, pools and out in `dtype`, page_table and
// kv_len int32. hq must be a multiple of hkv and d at most 256 (the
// wrapper checks both). `vec` is 1 or the 16-byte width of the dtype (the
// wrapper checks that it divides d and that the pools are aligned); `lds`
// as for repro_flash_decode_attention. The table's n_pt * page rows walk
// in steps of `step` rows, split into `splits` non-empty ranges of
// `steps_per_split`; with splits > 1, part_acc, part_ml and counters are
// the device buffers of repro_flash_decode_attention. `extra_bytes` (the
// table slice) and `smem` are the wrapper's figures (flash_decode.py:
// paged_launch_plan), launched as given and refused unless the slice holds
// a block's pages and `smem` is the kernel's layout within 227 KB.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, void* part_acc,
    void* part_ml, void* counters, int b, int hq, int hkv, int d, int page,
    int n_pt, int num_pages, int step, int lds, int splits,
    int steps_per_split, int extra_bytes, int smem, float scale, int dtype,
    int vec, int mask_oob, int rcp, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const int*>(page_table);
  const long long rows = static_cast<long long>(n_pt) * page;
  const long long n_steps = step > 0 ? (rows + step - 1) / step : 0;
  if (page < 1 || n_pt < 1 || step < 1 || lds < d || splits < 1 ||
      steps_per_split < 1 || rows > (1LL << 30) ||
      static_cast<long long>(splits) * steps_per_split < n_steps ||
      static_cast<long long>(splits - 1) * steps_per_split >= n_steps ||
      (splits > 1 && (!part_acc || !part_ml || !counters)) ||
      extra_bytes < 0 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_i = static_cast<int>(rows);
  dec::Args a{q, out, static_cast<const int*>(kv_len),
              static_cast<float*>(part_acc), static_cast<float*>(part_ml),
              static_cast<int*>(counters), hq, hkv, d, lds, step, rows_i,
              rows_i, splits, steps_per_split, extra_bytes, scale};
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == repro::kBFloat16) {
    return vec == 8 ? dispatch<__nv_bfloat16, 8>(a, k_pages, v_pages, pt, b,
                                                 page, n_pt, num_pages, sm,
                                                 mask_oob, rcp, st)
                    : dispatch<__nv_bfloat16, 1>(a, k_pages, v_pages, pt, b,
                                                 page, n_pt, num_pages, sm,
                                                 mask_oob, rcp, st);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4 ? dispatch<float, 4>(a, k_pages, v_pages, pt, b, page,
                                         n_pt, num_pages, sm, mask_oob, rcp,
                                         st)
                    : dispatch<float, 1>(a, k_pages, v_pages, pt, b, page,
                                         n_pt, num_pages, sm, mask_oob, rcp,
                                         st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
