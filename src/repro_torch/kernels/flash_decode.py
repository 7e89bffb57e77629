"""Single-token GQA decode attention, over a contiguous KV cache and over
a paged KV pool: the Hopper kernels and their wrappers.

``flash_decode_attention`` (kernel ``csrc/flash_decode.cu``) replaces the
TPU kernel ``repro/kernels/flash_decode.py::flash_decode_attention``
(body ``_kernel``). It walks the cache in ``chunk``-row steps with an fp32
online-softmax carry and is bound by bytes: every K and V row is read
once. It has a genome, ``FlashDecodeVariant``, and a registered space,
``flash_decode``. ``mask_oob`` visits only the chunks below ``kv_len``
(the baseline reads and masks every chunk of the cache); ``use_reciprocal``
normalises with ``__frcp_rn`` and a multiply instead of a divide;
``chunk`` is the rows of one step. The kernel stages two ``chunk``-row
tiles of K and V in shared memory, so a large ``chunk`` at a wide head in
fp32 does not fit a block's 227 KB: ``cost`` raises ``Infeasible`` and the
wrapper refuses it.

``paged_flash_decode_attention`` (kernel ``csrc/paged_decode.cu``)
replaces ``paged_flash_decode_attention`` of the same JAX module; it has
no genome yet.

A CPU tensor takes the plain version (``plain`` for the genome,
``ref.paged_flash_decode_attention`` for the paged form); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import SMEM_PER_BLOCK
from repro_torch.kernels import _build, ref
from repro_torch.kernels.registry import (KernelSpace, Knob, TestCase,
                                          register_kernel_space)

F32 = torch.float32
MAX_HEAD_DIM = 256
THREADS = 256              # one block per (kv head, request)
NEG_INF = -1e30            # finite -inf of the Pallas kernel


@dataclasses.dataclass(frozen=True)
class FlashDecodeVariant:
    """Genome of flash_decode_attention (the space the agents search)."""
    name: str = "baseline"
    chunk: int = 64
    use_reciprocal: bool = False
    mask_oob: bool = False

    def describe(self) -> str:
        """One line: name and knob values."""
        return (f"{self.name}: chunk={self.chunk} rcp={self.use_reciprocal} "
                f"mask_oob={self.mask_oob}")


# JAX's flags; chunk 64, the largest that fits every suite shape (JAX:
# 512 and 1024, sized to a TPU core's VMEM)
BASELINE = FlashDecodeVariant()
OPTIMIZED = FlashDecodeVariant(name="astra_opt", chunk=64,
                               use_reciprocal=True, mask_oob=True)


def tile_layout(chunk: int, d: int, group: int, itemsize: int,
                vec: int) -> tuple[int, int]:
    """(tile row stride in elements, shared memory bytes of a block).

    A block holds its query group, accumulator and ``chunk`` scores per
    query in fp32, then two stages of a K and a V tile of ``chunk`` rows
    in the cache's dtype. With 16-byte vectors a tile row is padded to an
    odd number of 16-byte units (so a warp reading 32 rows hits distinct
    banks), else to ``d + 1`` elements."""
    if vec > 1:
        units = d * itemsize // 16
        lds = (units | 1) * 16 // itemsize
    else:
        lds = d + 1
    state = 4 * (2 * group * d + group * chunk + 3 * group)
    return lds, -(-state // 16) * 16 + 4 * chunk * lds * itemsize


def plain(variant: FlashDecodeVariant, q, k, v, kv_len, sm_scale: float):
    """The genome's arithmetic in plain PyTorch, as the Pallas kernel
    computes it: ``chunk``-row steps (``chunk`` capped at s) of an fp32
    online softmax, rows past ``kv_len`` at -1e30, rows past s zero;
    ``mask_oob`` skips the steps at or past ``kv_len``; out is
    ``acc * (1 / l)`` or ``acc / l``, 0 where l = 0."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = max(1, min(variant.chunk, s))
    lens = kv_len.to(q.device).long().clamp(0, s)
    qf = q.reshape(b, hkv, g, d).to(F32)
    m = torch.full((b, hkv, g), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=F32, device=q.device)
    for c0 in range(0, s, chunk):
        kc = k[:, c0:c0 + chunk].to(F32)
        vc = v[:, c0:c0 + chunk].to(F32)
        if kc.shape[1] < chunk:                      # the ragged edge
            pad = (0, 0, 0, 0, 0, chunk - kc.shape[1])
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
        sc = torch.einsum("bhgd,bchd->bhgc", qf, kc) * sm_scale
        pos = c0 + torch.arange(chunk, device=q.device)
        live = (pos[None, :] < lens[:, None])[:, None, None, :]
        sc = torch.where(live, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_new = alpha * l + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum("bhgc,bchd->bhgd",
                                                        p, vc)
        if variant.mask_oob:
            step = (c0 < lens)[:, None, None]
            m, l = torch.where(step, m_new, m), torch.where(step, l_new, l)
            acc = torch.where(step[..., None], acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
    live = (l > 0)[..., None]
    if variant.use_reciprocal:
        out = acc * torch.where(live, torch.reciprocal(l[..., None]), 0.0)
    else:
        out = acc / torch.where(live, l[..., None], 1.0)
    return out.reshape(b, hq, d).to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           kv_len: torch.Tensor | None = None,
                           sm_scale: float | None = None,
                           variant: FlashDecodeVariant = OPTIMIZED,
                           return_lse: bool = False):
    """Decode attention over a contiguous cache.

    q: ``[batch, q_heads, head_dim]``; k, v: ``[batch, seq, kv_heads,
    head_dim]``; kv_len: ``[batch]`` int32 valid lengths (default: seq;
    clamped to seq). Returns ``[batch, q_heads, head_dim]`` in q's dtype,
    and with ``return_lse`` also the ``[batch, q_heads]`` fp32
    log-sum-exp of the scores (``ref.flash_decode_lse``, as the JAX
    wrapper recomputes it), the partial state the LSE merge consumes.
    """
    b, hq, dh = q.shape
    s = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        out = plain(variant, q, k, v, kv_len, sm_scale)
    elif q.device.type == "cuda":
        out = _launch(variant, q, k, v, kv_len, sm_scale)
    else:
        raise ValueError(f"flash_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not return_lse:
        return out
    return out, ref.flash_decode_lse(q, k, kv_len=kv_len, sm_scale=sm_scale)


def _launch(variant, q, k, v, kv_len, sm_scale):
    b, hq, dh = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != dh:
        raise ValueError(f"caches {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    s, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q_heads {hq} is not a multiple of kv_heads {hkv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q and the caches must share one dtype")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError("kv_len must be int32 [batch]")
    tensors = (q, k, v, kv_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_attention needs contiguous inputs")
    if variant.chunk < 1:
        raise ValueError(f"chunk {variant.chunk} < 1")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out.zero_()
    chunk = min(variant.chunk, s)
    vec = _build.vector_width(dh, k, v)
    lds, smem = tile_layout(chunk, dh, hq // hkv, q.element_size(), vec)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"chunk {chunk} at head_dim {dh} in {q.dtype} "
                         f"needs {smem} bytes of shared memory a block; "
                         f"the card has {SMEM_PER_BLOCK}")
    lib = _build.library()
    code = lib.repro_flash_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, hq, hkv, dh, s, chunk, lds, float(sm_scale),
        _build.dtype_code(q), vec, int(variant.mask_oob),
        int(variant.use_reciprocal), _build.stream_ptr(q.device))
    _build.check(lib, code, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def launch_key(variant: FlashDecodeVariant, *, batch: int, q_heads: int,
               kv_heads: int, head_dim: int, seq: int, dtype,
               mean_kv_len: float | None = None):
    """What the wrapper launches for this genome on one test: the chunk
    (capped at the cache's rows) and the template flags."""
    return min(variant.chunk, seq), variant.mask_oob, variant.use_reciprocal


def cost(variant: FlashDecodeVariant, *, batch: int, q_heads: int,
         kv_heads: int, head_dim: int, seq: int, dtype,
         mean_kv_len: float | None = None):
    """Analytic H100 cost of decode attention over a ``[b, s, hkv, d]``
    cache. Under ``mask_oob`` the bytes and the work scale with the share
    of chunks below the mean ``kv_len`` (the JAX model's estimate)."""
    from repro_torch.core import costmodel as cm

    item = dtype.itemsize
    group = q_heads // kv_heads
    chunk = min(variant.chunk, seq)
    n_chunks = math.ceil(seq / chunk)
    vec = cm.vector_elems(head_dim, item)
    _, smem = tile_layout(chunk, head_dim, group, item, vec)
    frac = 1.0
    if variant.mask_oob and mean_kv_len is not None:
        frac = min(1.0, (mean_kv_len / chunk + 1) / n_chunks)
    blocks = batch * kv_heads
    rows = blocks * n_chunks * chunk * frac          # tile rows visited
    kv_bytes = 2 * blocks * seq * head_dim * item * frac
    # per tile row and query: the q.k and p.v products (with a widening
    # of each element read in bf16), the mask and the softmax
    mad = 2 * head_dim * (2 if item < 4 else 1)
    alu, sfu = cm.ops("mul", "cmp", "max", "add", "exp", n=rows * group)
    r_alu, r_sfu = cm.ops("exp", n=blocks * n_chunks * frac * group)
    fin = ("rcp", "mul") if variant.use_reciprocal else ("div",)
    f_alu, f_sfu = cm.ops(*fin, n=batch * q_heads * head_dim)
    c = cm.Cost(
        dram_bytes=kv_bytes + 2 * batch * q_heads * head_dim * item
        + 4 * batch,
        alu_ops=alu + rows * group * mad + r_alu + f_alu
        + blocks * n_chunks * frac * group * head_dim,   # acc rescale
        sfu_ops=sfu + r_sfu + f_sfu,
        blocks=blocks, threads=THREADS, smem_bytes=smem,
        waste_bytes=cm.sector_waste(2 * blocks * seq * frac,
                                    head_dim * item))
    c.validate()
    return c


reference = ref.flash_decode_attention


# the JAX suite: LLaMA-family decode shapes
SUITE_SHAPES = ({"batch": 8, "q_heads": 32, "kv_heads": 8, "head_dim": 128,
                 "seq": 4096},
                {"batch": 32, "q_heads": 14, "kv_heads": 2, "head_dim": 64,
                 "seq": 2048},
                {"batch": 4, "q_heads": 16, "kv_heads": 16, "head_dim": 128,
                 "seq": 8192})


def make_inputs(shape: dict, *, dtype=F32, seed: int = 0,
                device="cpu") -> TestCase:
    """q, k, v normal and ragged ``kv_len`` in [1, seq], drawn in fp32 with
    numpy and cast to ``dtype``."""
    b, hq, hkv = shape["batch"], shape["q_heads"], shape["kv_heads"]
    dh, s = shape["head_dim"], shape["seq"]
    rng = np.random.default_rng(seed)

    def put(*dims):
        return torch.from_numpy(rng.standard_normal(dims, dtype=np.float32)) \
            .to(device=device, dtype=dtype)

    q, k, v = put(b, hq, dh), put(b, s, hkv, dh), put(b, s, hkv, dh)
    kv_len = rng.integers(1, s + 1, size=b).astype(np.int32)
    info = dict(shape, dtype=dtype, mean_kv_len=float(kv_len.mean()))
    return TestCase(f"[{b},{hq}/{hkv},{dh},s{s}]",
                    (q, k, v, torch.from_numpy(kv_len).to(device)), info)


def _run(variant, q, k, v, kv_len):
    return flash_decode_attention(q, k, v, kv_len=kv_len, variant=variant)


def _oracle(q, k, v, kv_len):
    return ref.flash_decode_attention(q, k, v, kv_len=kv_len)


@register_kernel_space
def _space() -> KernelSpace:
    return KernelSpace(
        name="flash_decode",
        baseline=BASELINE,
        default=OPTIMIZED,
        run=_run,
        oracle=_oracle,
        cost=cost,
        knobs=(
            Knob("mask_oob", "bool", attacks=("memory", "compute"),
                 target=True,
                 note="visit only the chunks below kv_len (skip their "
                      "copies and their work)"),
            Knob("chunk", "pow2", 16, 256, attacks=("overhead",),
                 note="KV rows per step (two K and V tiles of it in "
                      "shared memory)"),
            Knob("use_reciprocal", "bool", attacks=("compute",), target=True),
        ),
        suite_shapes=SUITE_SHAPES,
        make_inputs=make_inputs,
        launch_key=launch_key,
    )


# --------------------------------------------------------------------------
# paged form: K/V gathered through a page table
# --------------------------------------------------------------------------

def paged_flash_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor, *,
                                 kv_len: torch.Tensor | None = None,
                                 sm_scale: float | None = None):
    """Decode attention over a paged KV pool.

    q: ``[batch, q_heads, head_dim]``; k_pages, v_pages: ``[num_pages,
    page_size, kv_heads, head_dim]``; page_table: ``[batch, pages_per_seq]``
    int32 (logical page ``j`` of request ``b`` is physical page
    ``page_table[b, j]``); kv_len: ``[batch]`` valid lengths (default: the
    whole table). Returns ``[batch, q_heads, head_dim]`` in q's dtype.
    Table entries at or past ``kv_len`` may point anywhere (the engine
    points them at its trap page): they are masked and never read.
    """
    if q.device.type == "cpu":
        return ref.paged_flash_decode_attention(
            q, k_pages, v_pages, page_table, kv_len=kv_len,
            sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_attention runs on cpu or "
                         f"cuda, not {q.device}")
    b, hq, dh = q.shape
    n_pages, page, hkv, dh_k = k_pages.shape
    n_pt = page_table.shape[1]
    if v_pages.shape != k_pages.shape or dh_k != dh:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"q_heads {hq} is not a multiple of kv_heads {hkv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("q and the pools must share one dtype")
    if page_table.shape[0] != b or page_table.dtype != torch.int32:
        raise ValueError("page_table must be int32 [batch, pages_per_seq]")
    if kv_len is None:
        kv_len = torch.full((b,), n_pt * page, dtype=torch.int32,
                            device=q.device)
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError("kv_len must be int32 [batch]")
    tensors = (q, k_pages, v_pages, page_table, kv_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode_attention needs contiguous "
                         "inputs")
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    out = torch.empty_like(q)
    if b == 0:
        return out
    vec = _build.vector_width(dh, k_pages, v_pages)
    lib = _build.library()
    code = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b, hq,
        hkv, dh, page, n_pt, n_pages, float(sm_scale), _build.dtype_code(q),
        vec, _build.stream_ptr(q.device))
    _build.check(lib, code, "paged_flash_decode_attention")
    paged_flash_decode_attention.launches += 1
    return out


paged_flash_decode_attention.launches = 0
