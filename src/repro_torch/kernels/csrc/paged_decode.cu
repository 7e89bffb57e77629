// Paged single-token GQA decode attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:
// paged_flash_decode_attention (body _paged_kernel with the helpers
// _init_carry, _online_softmax_step and _finalize_output).
//
//   q [b, hq, d]; k_pages, v_pages [P, page, hkv, d];
//   page_table [b, n_pt] int32; kv_len [b] int32; out [b, hq, d].
//   Logical row t of request b lives at row t % page of physical page
//   page_table[b, t / page]. Rows >= kv_len are masked; out is 0 where no
//   row is valid.
//
// What bounds it on the H100: bytes. Each valid K and V row is read once
// (2 * d elements for every kv head) and used by the whole query group
// (7 heads at qwen2-0.5b's width), ~4 * group flops per element read. At
// decode (8 requests of a few hundred rows) the call moves ~2 MB, and
// with one block per (request, kv head) only 16 blocks run, so it is
// latency and launch bound.
//
// Design: one block per (kv head, request). The block loads its own
// kv_len and its own page-table row (the TPU's scalar prefetch becomes a
// plain load) and keeps the query group in shared memory in fp32. A loop
// inside the block walks the logical rows in chunks of kChunk (64): it
// gathers the chunk's K and V rows through the page table into shared
// memory with 16-byte loads, scores them against every query of the group
// (one (query, row) pair per thread), updates the fp32 online-softmax
// carry (m, l) with one warp per query and shuffle reductions, and folds
// the chunk's probability-weighted V rows into the fp32 accumulator. Chunks
// at or past kv_len are never visited and rows past kv_len inside the last
// chunk are never read, so table entries there (the trap page, or pages of
// other requests) are never touched. Any group size and any head_dim up to
// 256 work; nothing is padded.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_vec;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int kChunk = 64;         // logical rows per step of the loop
constexpr int kThreads = 128;      // 4 warps
constexpr float kNegInf = -1e30f;  // finite -inf: exp() stays defined

template <typename T, int VEC>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ kv_len, T* out,
                                    int hq, int hkv, int d, int page,
                                    int n_pt, int num_pages, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int ld = d + 1;  // padded K row: scores read ks at stride ld

  extern __shared__ float sm[];
  float* qs = sm;                         // [group, d]
  float* acc = qs + group * d;            // [group, d]
  float* ks = acc + group * d;            // [kChunk, d + 1]
  float* vs = ks + kChunk * ld;           // [kChunk, d]
  float* sc = vs + kChunk * d;            // [group, kChunk] scores / probs
  float* m = sc + group * kChunk;         // [group] running max
  float* l = m + group;                   // [group] running sum
  float* alpha = l + group;               // [group] this chunk's rescale

  const long long q_off = (static_cast<long long>(b) * hq +
                           static_cast<long long>(h) * group) * d;
  for (int i = tid; i < group * d; i += nt) {
    qs[i] = to_f(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += nt) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int len = min(kv_len[b], n_pt * page);
  const int* row_table = page_table + static_cast<long long>(b) * n_pt;
  const long long row_stride = static_cast<long long>(hkv) * d;

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    __syncthreads();  // the last chunk's readers are done with ks/vs/sc
    // gather the chunk's K and V rows through the page table, VEC
    // elements (16 bytes) at a time; rows at or past len are not read
    for (int i = tid * VEC; i < kChunk * d; i += nt * VEC) {
      const int r = i / d;
      const int e = i - r * d;
      const int t = c0 + r;
      float kv[VEC], vv[VEC];
      if (t < len) {
        long long phys = row_table[t / page];
        // memory safety only: a table entry out of the pool reads the trap
        if (phys < 0 || phys >= num_pages) phys = 0;
        const long long off = (phys * page + t % page) * row_stride +
                              static_cast<long long>(h) * d + e;
        if constexpr (VEC > 1) {
          load_vec<T, VEC>(k_pages + off, kv);
          load_vec<T, VEC>(v_pages + off, vv);
        } else {
          kv[0] = to_f(k_pages[off]);
          vv[0] = to_f(v_pages[off]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[r * ld + e + j] = kv[j];
        vs[i + j] = vv[j];
      }
    }
    __syncthreads();
    // scores: one (query, row) pair per thread and step
    for (int i = tid; i < group * kChunk; i += nt) {
      const int g = i / kChunk;
      const int r = i - g * kChunk;
      float s = kNegInf;
      if (c0 + r < len) {
        const float* qg = qs + g * d;
        const float* kr = ks + r * ld;
        float dot = 0.f;
        for (int e = 0; e < d; ++e) dot = fmaf(qg[e], kr[e], dot);
        s = dot * scale;
      }
      sc[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per query, lanes across the chunk's rows
    for (int g = warp; g < group; g += n_warps) {
      float* sg = sc + g * kChunk;
      float m_cur = kNegInf;
      for (int r = lane; r < kChunk; r += 32) m_cur = fmaxf(m_cur, sg[r]);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, warp_max(m_cur));
      float sum = 0.f;
      for (int r = lane; r < kChunk; r += 32) {
        const float p = expf(sg[r] - m_new);
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        l[g] = a * l[g] + sum;
        m[g] = m_new;
        alpha[g] = a;
      }
    }
    __syncthreads();
    // rescale the carry and add this chunk's probability-weighted V rows
    for (int i = tid; i < group * d; i += nt) {
      const int g = i / d;
      const int e = i - g * d;
      const float* pg = sc + g * kChunk;
      float s = 0.f;
      for (int r = 0; r < kChunk; ++r) s = fmaf(pg[r], vs[r * d + e], s);
      acc[i] = acc[i] * alpha[g] + s;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * d; i += nt) {
    const float lg = l[i / d];
    out[q_off + i] = from_f<T>(lg > 0.f ? acc[i] / lg : 0.f);
  }
}

template <typename T, int VEC>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_table, const int* kv_len, void* out, int b,
           int hq, int hkv, int d, int page, int n_pt, int num_pages,
           float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(group) * d +
                       kChunk * static_cast<size_t>(2 * d + 1) +
                       static_cast<size_t>(group) * kChunk + 3 * group);
  auto kernel = paged_decode_kernel<T, VEC>;
  int err = repro::allow_smem(kernel, smem);
  if (err) return err;
  dim3 grid(hkv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, kv_len,
      static_cast<T*>(out), hq, hkv, d, page, n_pt, num_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous; q, pools and out in `dtype`, page_table and
// kv_len int32. hq must be a multiple of hkv and d at most 256 (the
// wrapper checks both). `vec` is 1 or the 16-byte width of the dtype (the
// wrapper checks that it divides d and that the pools are aligned).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, int b, int hq,
    int hkv, int d, int page, int n_pt, int num_pages, float scale,
    int dtype, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const int*>(page_table);
  auto lens = static_cast<const int*>(kv_len);
  if (dtype == repro::kBFloat16) {
    return vec == 8
               ? launch<__nv_bfloat16, 8>(q, k_pages, v_pages, pt, lens, out,
                                          b, hq, hkv, d, page, n_pt,
                                          num_pages, scale, s)
               : launch<__nv_bfloat16, 1>(q, k_pages, v_pages, pt, lens, out,
                                          b, hq, hkv, d, page, n_pt,
                                          num_pages, scale, s);
  }
  if (dtype == repro::kFloat32) {
    return vec == 4
               ? launch<float, 4>(q, k_pages, v_pages, pt, lens, out, b, hq,
                                  hkv, d, page, n_pt, num_pages, scale, s)
               : launch<float, 1>(q, k_pages, v_pages, pt, lens, out, b, hq,
                                  hkv, d, page, n_pt, num_pages, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
