// Causal, optionally windowed, GQA attention over a whole prompt (the
// prefill's self-attention), for Hopper.
//
// Replaces no TPU kernel. The JAX package computes this attention in jnp
// (src/repro/models/layers.py: flash_attention, _flash_fwd_scan), outside
// any Pallas kernel, and the port's plain version of it
// (kernels/prefill_attention.py: walk) steps over 512-row KV chunks in
// fp32: some 25 launches a chunk, the full S x S scores where causality
// needs half, and every chunk under a sliding window. On the H100 that walk
// was most of a serving admission's device time (fp32 GEMMs and
// element-wise passes over the score tensor, and the host's launch gaps
// between them); this kernel was added to take its place on the serving
// path: causal calls without grad in bf16 (models/layers.py:
// flash_attention).
//
//   q [b, s, hq, d], k, v [b, s, hkv, d] in bf16, each with its own batch,
//   row and head strides (the head dim contiguous); window w (0: none).
//   Query i sees key j where j <= i and, with a window, i - j < w.
//   out [b, s, hq, d] in bf16, contiguous: the layout out_proj reads.
//   Scores are q.k in fp32 times d^-0.5; the running max and sum and the
//   rescaling are fp32; p is rounded to bf16 for p.V (fp32 accumulators),
//   as in the decode kernels; out = acc / l, cast to bf16.
//
// What bounds it on the H100: operations. Each visible (query, key) pair
// costs 4 d flops on the tensor cores, and the bytes (q, k, v and out
// once) are a few tens of MB: at yi-34b's 2,048-row prefill (56/8 heads
// of 128) a layer is 6.0e10 flops, 61 us at 989 TFLOP/s, against 67 MB,
// 20 us at 3.35 TB/s.
//
// Design (FlashAttention-2's shape, on mma.sync): a block of four warps
// takes 64 queries of one head of one request, each warp 16 of them. The
// block stages its q tile in shared memory once; a warp then keeps its
// rows' A fragments in registers (at d = 256 they stay in shared memory
// and are read a k-tile at a time, to leave registers for the 16 x 256
// accumulator). K and V tiles of kBN rows (64; 32 at d = 256) stream
// through a two-slot ring of 16-byte cp.async copies, so the next tile's
// copy overlaps this tile's products. Both products run on the tensor
// cores (mma.sync.m16n8k16, bf16 in, fp32 accumulators): S = q K^T from
// ldmatrix'd K, O += p V from ldmatrix.trans'd V. The softmax takes exp2f
// with log2(e) folded into the scale. A block visits only the KV tiles its
// queries can see -- none above the diagonal, none wholly outside the
// window -- and masks only the tiles that straddle the diagonal or the
// window's edge. The grid puts the head fastest and walks query tiles from
// the last, so the blocks with the longest causal rows start first and
// the last wave holds the shortest. Rows past s are zero-filled on load
// and never stored, so s need not be a multiple of a tile; any group size
// works. Head widths: the instantiations of repro_prefill_attention.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;   // queries of a block
constexpr int kPad = 8;            // elements past d in a staged row
constexpr float kLog2e = 1.4426950408889634f;

// KV rows of a tile: 64, or 32 at d = 256, where the accumulators take
// half the registers.
template <int D>
constexpr int kBN = D > 128 ? 32 : 64;
// Whether a warp keeps its q fragments in registers.
template <int D>
constexpr bool kQInRegs = D <= 128;
// Row stride of a staged tile: 16 bytes past the row, so that the eight
// rows one ldmatrix reads fall in distinct banks.
template <int D>
constexpr int kLds = D + kPad;

// Shared memory of a block: the q tile and two slots of K and V.
template <int D>
constexpr size_t kSmem =
    static_cast<size_t>(kBM + 2 * 2 * kBN<D>) * kLds<D> * sizeof(bf16);

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  long long q_sb, q_ss, q_sh;  // batch, row and head strides, in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int s, hq, group, window;
  float scale_log2;            // d^-0.5 * log2(e)
};

// c += a.b for one m16n8k16 bf16 tile, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Queue the block's copies of ROWS rows of one head, from row r0 of src
// (rows `stride` elements apart) into a staged tile; rows at or past s are
// zero-filled and nothing is read for them.
template <int D, int ROWS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long stride, int r0, int s) {
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  constexpr int kIters = (ROWS * kPieces + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < ROWS * kPieces) {
      const int r = i / kPieces;
      const int c = i - r * kPieces;
      const bool ok = r0 + r < s;
      const bf16* from = ok ? src + (r0 + r) * stride + c * 8 : src;
      repro::cp_async16_or_zero(dst + r * kLds<D> + c * 8, from, ok);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) prefill_attn_kernel(Params p) {
  constexpr int BN = kBN<D>;
  constexpr int LDS = kLds<D>;
  constexpr int KT = D / 16;  // k-tiles of q.K^T
  constexpr int NT = BN / 8;  // 8-key tiles of S
  constexpr int OT = D / 8;   // 8-element tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBM * LDS;  // two slots of BN rows
  bf16* vs = ks + 2 * BN * LDS;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int b = blockIdx.z;
  const int s = p.s;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + (h / p.group) * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + (h / p.group) * p.v_sh;

  // the keys the block's queries see lie in tiles [t_first, t_last]
  const int q_last = min(q0 + kBM, s) - 1;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_first = lo / BN;
  const int t_last = q_last / BN;

  stage<D, kBM>(qs, qg, p.q_ss, q0, s);
  stage<D, BN>(ks, kg, p.k_ss, t_first * BN, s);
  stage<D, BN>(vs, vg, p.v_ss, t_first * BN, s);
  repro::cp_async_commit();

  // this lane's rows: r_a and r_a + 8 of the warp's 16; its columns of an
  // 8-wide tile: 2 (lane % 4) and the next
  const int r_a = q0 + warp * 16 + (lane >> 2);
  const int r_b = r_a + 8;
  const int col = (lane & 3) * 2;
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 domain
  float l_a = 0.f, l_b = 0.f;              // this lane's share of the sum
  uint32_t qf[kQInRegs<D> ? KT : 1][4];
  // ldmatrix addresses: q rows of the warp (x4: rows 0-15, columns 0-7 and
  // 8-15 of a k-tile); K rows (keys 0-7 and 8-15 of a 16, each at columns
  // 0-7 and 8-15); V rows for the transposed load (keys 0-15, columns 0-7
  // and 8-15 of a 16)
  const bf16* q_lane = qs + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * LDS + ((lane >> 3) & 1) * 8;
  const int v_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (lane >> 4) * 8;

  for (int t = t_first; t <= t_last; ++t) {
    const int slot = (t - t_first) & 1;
    if (t < t_last) {
      stage<D, BN>(ks + (slot ^ 1) * BN * LDS, kg, p.k_ss, (t + 1) * BN, s);
      stage<D, BN>(vs + (slot ^ 1) * BN * LDS, vg, p.v_ss, (t + 1) * BN, s);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // this thread's copies of tile t landed
    __syncthreads();            // ... and every thread's
    if constexpr (kQInRegs<D>) {
      if (t == t_first) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          repro::decode::ldsm_x4(qf[kt], q_lane + kt * 16, false);
        }
      }
    }
    const bf16* kt_s = ks + slot * BN * LDS + k_off;
    const bf16* vt_s = vs + slot * BN * LDS + v_off;

    // S = q K^T over the tile's BN keys
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      if constexpr (kQInRegs<D>) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kt][e];
      } else {
        repro::decode::ldsm_x4(a, q_lane + kt * 16, false);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        repro::decode::ldsm_x4(bk, kt_s + np * 16 * LDS + kt * 16, false);
        mma16816(sc[2 * np], a, bk[0], bk[1]);
        mma16816(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // the keys a query may not see, on the tiles that straddle the
    // diagonal or the window's edge
    const int k0 = t * BN;
    const bool diag = k0 + BN - 1 > q0;
    const bool edge = p.window > 0 && k0 < q_last - p.window + 1;
    if (diag || edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r_a : r_b;
          const int key = k0 + j * 8 + col + (e & 1);
          if (key > r || (p.window > 0 && r - key >= p.window)) {
            sc[j][e] = -INFINITY;
          }
        }
      }
    }

    // the online softmax in the log2 domain; a row whose keys so far are
    // all masked keeps m = -inf and takes 0 as its reference, so p = 0
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a * p.scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * p.scale_log2);
    const float ref_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float ref_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - ref_a);
    const float alpha_b = exp2f(m_b - ref_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = exp2f(fmaf(sc[j][0], p.scale_log2, -ref_a));
      sc[j][1] = exp2f(fmaf(sc[j][1], p.scale_log2, -ref_a));
      sc[j][2] = exp2f(fmaf(sc[j][2], p.scale_log2, -ref_b));
      sc[j][3] = exp2f(fmaf(sc[j][3], p.scale_log2, -ref_b));
      sum_a += sc[j][0] + sc[j][1];
      sum_b += sc[j][2] + sc[j][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }

    // O += p V: p's accumulators of two 8-key tiles are the A fragment of
    // one 16-key k-tile
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {
          repro::decode::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          repro::decode::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          repro::decode::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          repro::decode::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        repro::decode::ldsm_x4(bv, vt_s + kk * 16 * LDS + dp * 16, true);
        mma16816(o[2 * dp], a, bv[0], bv[1]);
        mma16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with the slot before it refills
  }
  repro::cp_async_wait<0>();

  // out = acc / l, staged in the warp's own q rows, then stored 16 bytes a
  // lane
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  bf16* ow = qs + warp * 16 * LDS;
  const int rr = lane >> 2;
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(ow + rr * LDS + j * 8 + col) =
        __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(ow + (rr + 8) * LDS + j * 8 + col) =
        __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
  }
  __syncwarp();
  constexpr int kPieces = D / 8;
#pragma unroll
  for (int it = 0; it < kPieces / 2; ++it) {  // 16 rows x kPieces, 32 lanes
    const int i = lane + it * 32;
    const int r = i / kPieces;
    const int c = i - r * kPieces;
    const int row = q0 + warp * 16 + r;
    if (row < s) {
      const long long at = ((static_cast<long long>(b) * s + row) * p.hq + h) *
                               D + c * 8;
      *reinterpret_cast<uint4*>(p.out + at) =
          *reinterpret_cast<const uint4*>(ow + r * LDS + c * 8);
    }
  }
}

template <int D>
int launch(const Params& p, int b, cudaStream_t stream) {
  auto kernel = prefill_attn_kernel<D>;
  int err = repro::allow_smem(kernel, kSmem<D>);
  if (err) return err;
  dim3 grid(p.hq, (p.s + kBM - 1) / kBM, b);
  kernel<<<grid, kThreads, kSmem<D>, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and out bf16; out contiguous [b, s, hq, d]; q, k and v with the
// given strides in elements (the head dim contiguous; the wrapper checks
// that every stride is a multiple of 8 and every pointer 16-byte aligned).
// hq a multiple of hkv; d one of 32, 64, 80, 128, 256; window 0 for
// none, else the rows a query sees. Returns the launch's CUDA error code.
extern "C" int repro_prefill_attention(
    const void* q, const void* k, const void* v, void* out, int b, int s,
    int hq, int hkv, int d, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int window, float scale, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || (s + kBM - 1) / kBM > 65535 ||
      hkv < 1 || hq < hkv || hq % hkv || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(out),
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 s, hq, hq / hkv, window, scale * kLog2e};
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(p, b, st);
    case 64: return launch<64>(p, b, st);
    case 80: return launch<80>(p, b, st);
    case 128: return launch<128>(p, b, st);
    case 256: return launch<256>(p, b, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
