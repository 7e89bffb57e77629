"""Single-token GQA decode attention, over a contiguous KV cache and over
a paged KV pool: the Hopper kernels, their genomes and their wrappers.

``flash_decode_attention`` (kernel ``csrc/flash_decode.cu``) replaces the
TPU kernel ``repro/kernels/flash_decode.py::flash_decode_attention``
(body ``_kernel``); ``paged_flash_decode_attention`` (kernel
``csrc/paged_decode.cu``) replaces ``paged_flash_decode_attention`` of
the same JAX module (body ``_paged_kernel``). Both are bound by bytes
(every K and V row is read once) and share one split-KV walk
(``csrc/common.cuh``): the rows of each (kv head, request) are split into
``splits`` ranges of whole steps, one block a range, and each of a block's
four warps walks its share of every step with its own fp32
online-softmax carry through a three-slot ring of ``cp.async`` copies
(one slot on the CUDA-core walk where three do not fit: fp32 at head_dim
256). The last block of a head to finish merges the ranges with paper
Kernel 1's LSE weights, in the same launch. ``split_plan`` picks ``splits`` from the
shapes and the card alone, never from ``kv_len``, so a call never syncs
with the host and can be captured in a CUDA graph.

Each has a genome and a registered space. ``flash_decode``
(``FlashDecodeVariant``): ``mask_oob`` visits only the chunks below
``kv_len`` (the baseline reads and masks every chunk of the cache);
``use_reciprocal`` normalises with ``__frcp_rn`` and a multiply instead
of a divide; ``chunk`` is the rows of one step. A block holds three
slots of a ``chunk``-row K and V tile, so a large ``chunk`` at a wide
head does not fit 227 KB: ``cost`` raises ``Infeasible`` and the wrapper
refuses it. ``paged_flash_decode`` (``PagedFlashDecodeVariant``, JAX's
knobs): the same two flags, and ``page_size``, the pool granule the
search pages its suite in; the kernel reads the page size off the pool
and steps 64 rows at a time whatever it is.

A CPU tensor takes the genome's plain version (``plain``,
``paged_plain``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from repro_torch.device import SMEM_PER_BLOCK, resident_blocks_smem
from repro_torch.kernels import _build, ref
from repro_torch.kernels.registry import (KernelSpace, Knob, TestCase,
                                          register_kernel_space)

F32 = torch.float32
MAX_HEAD_DIM = 256
NEG_INF = -1e30            # finite -inf of the Pallas kernel
# the split-KV walk of csrc/common.cuh (repro::decode)
WARPS = 4
THREADS = 32 * WARPS
STAGES = 3                 # slots of a warp's ring (or 1: ring_stages)
GROUP = 8                  # queries a block serves at most
SUB = 16                   # rows a warp scores at once
BLOCKS_PER_SM = 2          # the kernels' launch bounds (kMinBlocks)
PAGED_STEP = 64            # rows of a step of the paged kernel


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


@dataclasses.dataclass(frozen=True)
class PagedFlashDecodeVariant:
    """Genome of paged_flash_decode_attention. ``page_size`` is the pool
    granule: the search pages its suite in ``page_size``-row pages, and
    the serving engine would allocate in them. The kernel reads the page
    size off the pool's shape."""
    name: str = "baseline"
    page_size: int = 16
    use_reciprocal: bool = False
    mask_oob: bool = False

    def describe(self) -> str:
        """One line: name and knob values."""
        return (f"{self.name}: page_size={self.page_size} "
                f"rcp={self.use_reciprocal} mask_oob={self.mask_oob}")


PAGED_BASELINE = PagedFlashDecodeVariant()
PAGED_OPTIMIZED = PagedFlashDecodeVariant(name="astra_opt", page_size=64,
                                          use_reciprocal=True, mask_oob=True)


# --------------------------------------------------------------------------
# launch geometry, shared by both kernels
# --------------------------------------------------------------------------

def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _layout_bytes(step, d, group, itemsize, lds, extra_bytes, stages):
    """``repro::decode::layout_bytes``: a block's shared memory with rings
    of ``stages`` slots."""
    gm = min(group, GROUP)
    head = _round16(4 * (gm * d + 3 * WARPS * GROUP + 2 * GROUP + 4))
    rows = -(-(-(-step // WARPS)) // SUB) * SUB      # slot_rows(step)
    ring = WARPS * stages * 2 * rows * lds * itemsize
    return head + _round16(extra_bytes) + max(ring, WARPS * gm * d * 4)


def ring_stages(d: int, group: int, itemsize: int, vec: int,
                extra_bytes: int = 0) -> int:
    """Slots of a warp's ring (``repro::decode::ring_stages``): three, but
    one on the CUDA-core walk (every dtype and width but bf16 in 16-byte
    vectors) at a width where three slots of the narrowest tile (16 rows
    a warp) do not fit a block: three of 16 fp32 rows of 256 (260 with
    padding) take 399,360 bytes, one 133,120. The width decides, not the
    step, so a genome that fitted three slots keeps them and one that did
    not fit at a narrower head still does not. The tensor-core walk keeps
    three, and a layout of it that does not fit is refused."""
    if itemsize == 2 and vec == 8:
        return STAGES
    narrowest = _layout_bytes(WARPS * SUB, d, group, itemsize,
                              _lds(d, itemsize, vec), extra_bytes, STAGES)
    return STAGES if narrowest <= SMEM_PER_BLOCK else 1


def _lds(d: int, itemsize: int, vec: int) -> int:
    """Tile row stride in elements (``tile_layout``)."""
    if vec > 1:
        units = d * itemsize // 16
        return (units | 1) * 16 // itemsize
    return d + 1


def tile_layout(step: int, d: int, group: int, itemsize: int, vec: int,
                extra_bytes: int = 0) -> tuple[int, int]:
    """(tile row stride in elements, shared memory bytes of a block). The
    wrapper plans splits with these figures and passes them to the
    launcher, which launches them as given and refuses (a raised launch
    error) any that ``repro::decode::smem_bytes`` does not reproduce.

    A block holds up to 8 queries, the warps' (m, l) and their merge
    weights in fp32, a Rows policy's ``extra_bytes`` (the paged kernel's
    table slice), then each warp's ring: ``ring_stages`` slots (three, or
    one) of its share (a quarter) of a ``step``-row K and V tile, rounded
    up to 16 rows, in the cache's dtype. With 16-byte vectors a tile row
    is padded to an odd number of 16-byte units (so the rows a
    quarter-warp or an 8x8 ``ldmatrix`` reads hit distinct banks), else to
    ``d + 1`` elements. After the walk the rings hold the warps'
    accumulators."""
    lds = _lds(d, itemsize, vec)
    stages = ring_stages(d, group, itemsize, vec, extra_bytes)
    return lds, _layout_bytes(step, d, group, itemsize, lds, extra_bytes,
                              stages)


def split_plan(n_steps: int, heads: int, smem: int) -> tuple[int, int]:
    """(splits, steps a split) for ``n_steps`` steps of each of ``heads``
    (request, kv head, query subgroup) triples: enough splits to fill the
    blocks the card holds at once (two an SM by the launch bounds, fewer
    where a block's shared memory says so), at most one a step, and every
    split non-empty. Shapes and the card only: never ``kv_len``."""
    resident = resident_blocks_smem(THREADS, smem, BLOCKS_PER_SM)
    splits = max(1, min(n_steps, resident // max(heads, 1)))
    per = -(-n_steps // splits)
    return -(-n_steps // per), per


def _slice_len(step: int, per: int, page: int, n_pt: int) -> int:
    """Table entries a paged block loads at most (``paged_decode.cu``)."""
    return min(n_pt, -(-(step * per) // page) + 1)


def _subgroups(group: int) -> int:
    return -(-group // GROUP)


_COUNTERS: dict = {}        # device -> int32 counters, 0 between launches
_RETIRED: list = []         # outgrown counters, kept: a graph may hold them


def _counters(device, n: int) -> torch.Tensor:
    """The split-KV kernels' per-device counters (at least ``n``),
    allocated zeroed once: every launch leaves them at 0.

    A buffer is never freed: a CUDA graph captured on it keeps its
    pointer, so one that is outgrown is retired, not released. The slots
    are shared by every stream of the device: the port launches its
    decode calls on one stream (the engine's and the agents'), and two
    calls that overlap on two streams would race on them."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the decode-attention counters must be "
                               "allocated by a call before graph capture")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _scratch(q: torch.Tensor, plan: dict):
    """The merge's device pointers for one launch (part_acc, part_ml,
    counters; all null with one split, where a block writes out itself)
    and the buffer to keep alive until the launch is queued."""
    splits = plan["splits"]
    if splits == 1:
        return (None, None, None), None
    b, hq, dh = q.shape
    n = b * hq * splits
    part = torch.empty(n * (dh + 2), dtype=F32, device=q.device)
    counters = _counters(q.device, b * plan["grid"][0])
    return (part.data_ptr(), part[n * dh:].data_ptr(),
            counters.data_ptr()), part


# --------------------------------------------------------------------------
# plain versions: the Pallas kernels' arithmetic in PyTorch
# --------------------------------------------------------------------------

def plain_state(variant: FlashDecodeVariant, q, k, v, kv_len,
                sm_scale: float, chunks: tuple[int, int] | None = None):
    """The Pallas carry ``(acc, m, l)`` in fp32 (``[b, hkv, group, d]``,
    ``[b, hkv, group]`` twice) after the chunks ``[lo, hi)`` (default:
    all) of ``chunk`` rows (``chunk`` capped at s), starting from
    ``m = -1e30, l = 0, acc = 0``: rows past ``kv_len`` at -1e30, rows
    past s zero, and under ``mask_oob`` the chunks at or past ``kv_len``
    skipped."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = max(1, min(variant.chunk, s))
    lo, hi = (0, -(-s // chunk)) if chunks is None else chunks
    lens = kv_len.to(q.device).long().clamp(0, s)
    qf = q.reshape(b, hkv, g, d).to(F32)
    m = torch.full((b, hkv, g), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=F32, device=q.device)
    for c0 in range(lo * chunk, hi * chunk, chunk):
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
    return acc, m, l


def merge_states(states):
    """One carry from several over disjoint rows, with paper Kernel 1's
    weights: ``M = max m_i`` (``M_safe = 0`` when ``M = -inf``), each
    part scaled by ``e^{m_i - M_safe}``; a part with ``l = 0`` holds no
    row and adds nothing. Returns ``(acc, M, L)``."""
    m = torch.stack([st[1] for st in states])
    big = m.amax(dim=0)
    safe = torch.where(torch.isneginf(big), torch.zeros_like(big), big)
    acc = torch.zeros_like(states[0][0])
    l = torch.zeros_like(big)
    for a_i, m_i, l_i in states:
        f = torch.where(l_i > 0, torch.exp(m_i - safe), 0.0)
        acc = acc + f[..., None] * a_i
        l = l + f * l_i
    return acc, big, l


def finish(use_reciprocal: bool, acc, l, dtype):
    """``acc * (1 / l)`` or ``acc / l``, 0 where ``l = 0``, as
    ``[b, hq, d]`` in ``dtype``."""
    live = (l > 0)[..., None]
    if use_reciprocal:
        out = acc * torch.where(live, torch.reciprocal(l[..., None]), 0.0)
    else:
        out = acc / torch.where(live, l[..., None], 1.0)
    b, hkv, g, d = acc.shape
    return out.reshape(b, hkv * g, d).to(dtype)


def plain(variant: FlashDecodeVariant, q, k, v, kv_len, sm_scale: float):
    """The genome's arithmetic in plain PyTorch, as the Pallas kernel
    computes it: ``chunk``-row steps (``chunk`` capped at s) of an fp32
    online softmax, rows past ``kv_len`` at -1e30, rows past s zero;
    ``mask_oob`` skips the steps at or past ``kv_len``; out is
    ``acc * (1 / l)`` or ``acc / l``, 0 where l = 0."""
    acc, _, l = plain_state(variant, q, k, v, kv_len, sm_scale)
    return finish(variant.use_reciprocal, acc, l, q.dtype)


def _gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``[b, n_pt * page, hkv, d]``: the logical cache through the table,
    an entry outside the pool reading page 0 (the kernel's rule)."""
    b, n_pt = table.shape
    _, page, hkv, dh = pages.shape
    t = table.to(pages.device).long()
    t = torch.where((t >= 0) & (t < pages.shape[0]), t, 0)
    return pages[t].reshape(b, n_pt * page, hkv, dh)


def paged_plain(variant: PagedFlashDecodeVariant, q, k_pages, v_pages,
                page_table, kv_len, sm_scale: float):
    """The paged genome's arithmetic in plain PyTorch, as ``_paged_kernel``
    computes it: one page of the pool's page size a step over every
    logical page of the table, the contiguous genome's carry over the
    gathered cache (``kv_len`` clamped to the table's rows)."""
    proxy = FlashDecodeVariant(chunk=k_pages.shape[1],
                               use_reciprocal=variant.use_reciprocal,
                               mask_oob=variant.mask_oob)
    return plain(proxy, q, _gather(k_pages, page_table),
                 _gather(v_pages, page_table), kv_len, sm_scale)


# --------------------------------------------------------------------------
# contiguous form
# --------------------------------------------------------------------------

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


def _check_common(q, hkv, dh_k, kv_len, tensors, what):
    b, hq, dh = q.shape
    if dh_k != dh:
        raise ValueError(f"{what} do not fit q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"q_heads {hq} is not a multiple of kv_heads {hkv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    if not (q.dtype == tensors[1].dtype == tensors[2].dtype):
        raise ValueError(f"q and the {what} must share one dtype")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError("kv_len must be int32 [batch]")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"decode attention over the {what} needs "
                         "contiguous inputs")


def launch_plan(variant: FlashDecodeVariant, *, batch: int, q_heads: int,
                kv_heads: int, head_dim: int, seq: int, dtype,
                vec: int | None = None) -> dict:
    """What the contiguous wrapper launches for these shapes: chunk, tile
    stride, shared memory, splits and grid."""
    item = dtype.itemsize
    if vec is None:
        vec = 16 // item if head_dim % (16 // item) == 0 else 1
    group = q_heads // kv_heads
    chunk = min(variant.chunk, seq)
    lds, smem = tile_layout(chunk, head_dim, group, item, vec)
    n_steps = -(-seq // chunk)
    heads = batch * kv_heads * _subgroups(group)
    splits, per = split_plan(n_steps, heads, smem)
    return dict(chunk=chunk, lds=lds, smem=smem, vec=vec,
                stages=ring_stages(head_dim, group, item, vec),
                splits=splits,
                steps_per_split=per,
                grid=(kv_heads * _subgroups(group), batch, splits))


def _launch(variant, q, k, v, kv_len, sm_scale):
    b, hq, dh = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b:
        raise ValueError(f"caches {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    s, hkv = k.shape[1], k.shape[2]
    _check_common(q, hkv, k.shape[3], kv_len, (q, k, v, kv_len), "caches")
    if variant.chunk < 1:
        raise ValueError(f"chunk {variant.chunk} < 1")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out.zero_()
    plan = launch_plan(variant, batch=b, q_heads=hq, kv_heads=hkv,
                       head_dim=dh, seq=s, dtype=q.dtype,
                       vec=_build.vector_width(dh, k, v))
    if plan["smem"] > SMEM_PER_BLOCK:
        raise ValueError(f"chunk {plan['chunk']} at head_dim {dh} in "
                         f"{q.dtype} needs {plan['smem']} bytes of shared "
                         f"memory a block; the card has {SMEM_PER_BLOCK}")
    merge, _keep = _scratch(q, plan)
    lib = _build.library()
    code = lib.repro_flash_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), *merge, b, hq, hkv, dh, s, plan["chunk"],
        plan["lds"], plan["splits"], plan["steps_per_split"], plan["smem"],
        float(sm_scale), _build.dtype_code(q), plan["vec"],
        int(variant.mask_oob), int(variant.use_reciprocal),
        _build.stream_ptr(q.device))
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


def _split_cost(*, batch: int, q_heads: int, kv_heads: int, head_dim: int,
                dtype, step: int, rows_total: int, rows_moved: float,
                frac: float, use_reciprocal: bool, extra_bytes: int = 0,
                table_bytes: float = 0.0):
    """Analytic H100 cost of one split-KV launch: ``rows_total`` rows a
    head in ``step``-row steps, of which the share ``frac`` is visited and
    ``rows_moved`` a head are read; the fp32 partials written and read by
    the one-launch combine when there is more than one split."""
    from repro_torch.core import costmodel as cm

    item = dtype.itemsize
    group = q_heads // kv_heads
    vec = cm.vector_elems(head_dim, item)
    _, smem = tile_layout(step, head_dim, group, item, vec, extra_bytes)
    n_steps = -(-rows_total // step)
    heads = batch * kv_heads * _subgroups(group)
    splits, _ = split_plan(n_steps, heads, smem)
    blocks = heads * splits
    rows = batch * kv_heads * n_steps * step * frac     # rows visited
    kv_bytes = 2 * batch * kv_heads * rows_moved * head_dim * item
    part_bytes = 0 if splits == 1 else \
        2 * batch * q_heads * splits * (head_dim + 2) * 4
    # per row and query: the q.k and p.v products (with a widening of each
    # element read in bf16), the mask and the softmax; per 16 rows and
    # query: the carry's rescale
    mad = 2 * head_dim * (2 if item < 4 else 1)
    alu, sfu = cm.ops("mul", "cmp", "max", "add", "exp", n=rows * group)
    r_alu, r_sfu = cm.ops("exp", n=rows / 16 * group)
    c_alu, c_sfu = cm.ops("exp", "fma", "fma",
                          n=batch * q_heads * head_dim * (splits + WARPS))
    fin = ("rcp", "mul") if use_reciprocal else ("div",)
    f_alu, f_sfu = cm.ops(*fin, n=batch * q_heads * head_dim)
    c = cm.Cost(
        dram_bytes=kv_bytes + 2 * batch * q_heads * head_dim * item
        + 4 * batch + table_bytes + part_bytes,
        alu_ops=alu + rows * group * mad + r_alu
        + rows / 16 * group * head_dim + c_alu + f_alu,
        sfu_ops=sfu + r_sfu + c_sfu + f_sfu,
        blocks=blocks, threads=THREADS, smem_bytes=smem,
        waste_bytes=cm.sector_waste(2 * batch * kv_heads * rows_moved,
                                    head_dim * item))
    c.validate()
    return c


def cost(variant: FlashDecodeVariant, *, batch: int, q_heads: int,
         kv_heads: int, head_dim: int, seq: int, dtype,
         mean_kv_len: float | None = None):
    """Analytic H100 cost of decode attention over a ``[b, s, hkv, d]``
    cache. Under ``mask_oob`` the bytes and the work scale with the share
    of chunks below the mean ``kv_len`` (the JAX model's estimate)."""
    chunk = min(variant.chunk, seq)
    n_chunks = math.ceil(seq / chunk)
    frac = 1.0
    if variant.mask_oob and mean_kv_len is not None:
        frac = min(1.0, (mean_kv_len / chunk + 1) / n_chunks)
    return _split_cost(batch=batch, q_heads=q_heads, kv_heads=kv_heads,
                       head_dim=head_dim, dtype=dtype, step=chunk,
                       rows_total=n_chunks * chunk, rows_moved=seq * frac,
                       frac=frac, use_reciprocal=variant.use_reciprocal)


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
                 note="KV rows per step (three slots of a K and V tile of "
                      "it in shared memory)"),
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
                                 sm_scale: float | None = None,
                                 variant: PagedFlashDecodeVariant
                                 = PAGED_OPTIMIZED):
    """Decode attention over a paged KV pool.

    q: ``[batch, q_heads, head_dim]``; k_pages, v_pages: ``[num_pages,
    page_size, kv_heads, head_dim]``; page_table: ``[batch, pages_per_seq]``
    int32 (logical page ``j`` of request ``b`` is physical page
    ``page_table[b, j]``); kv_len: ``[batch]`` valid lengths (default: the
    whole table). Returns ``[batch, q_heads, head_dim]`` in q's dtype.
    Table entries at or past ``kv_len`` may point anywhere in the pool
    (the engine points them at its trap page): they are masked, and under
    ``mask_oob`` never read.
    """
    b, hq, dh = q.shape
    n_pt = page_table.shape[1]
    if kv_len is None:
        kv_len = torch.full((b,), n_pt * k_pages.shape[1],
                            dtype=torch.int32, device=q.device)
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    if q.device.type == "cpu":
        return paged_plain(variant, q, k_pages, v_pages, page_table, kv_len,
                           sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_attention runs on cpu or "
                         f"cuda, not {q.device}")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    n_pages, page, hkv, dh_k = k_pages.shape
    _check_common(q, hkv, dh_k, kv_len,
                  (q, k_pages, v_pages, page_table, kv_len), "pools")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.dtype != torch.int32:
        raise ValueError("page_table must be int32 [batch, pages_per_seq]")
    out = torch.empty_like(q)
    if b == 0:
        return out
    if n_pt == 0 or page == 0:
        return out.zero_()
    plan = paged_launch_plan(batch=b, q_heads=hq, kv_heads=hkv, head_dim=dh,
                             page=page, n_pt=n_pt, dtype=q.dtype,
                             vec=_build.vector_width(dh, k_pages, v_pages))
    merge, _keep = _scratch(q, plan)
    lib = _build.library()
    code = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), *merge,
        b, hq, hkv, dh, page, n_pt, n_pages, PAGED_STEP, plan["lds"],
        plan["splits"], plan["steps_per_split"], plan["extra_bytes"],
        plan["smem"], float(sm_scale),
        _build.dtype_code(q), plan["vec"], int(variant.mask_oob),
        int(variant.use_reciprocal), _build.stream_ptr(q.device))
    _build.check(lib, code, "paged_flash_decode_attention")
    paged_flash_decode_attention.launches += 1
    return out


paged_flash_decode_attention.launches = 0


def paged_launch_plan(*, batch: int, q_heads: int, kv_heads: int,
                      head_dim: int, page: int, n_pt: int, dtype,
                      vec: int | None = None) -> dict:
    """What the paged wrapper launches for these shapes: tile stride,
    shared memory (with the table slice), splits and grid."""
    item = dtype.itemsize
    if vec is None:
        vec = 16 // item if head_dim % (16 // item) == 0 else 1
    group = q_heads // kv_heads
    n_steps = -(-(n_pt * page) // PAGED_STEP)
    heads = batch * kv_heads * _subgroups(group)
    # the slice's size depends on the split, the split on the shared
    # memory: size the slice for the longest split, then plan
    _, smem = tile_layout(PAGED_STEP, head_dim, group, item, vec,
                          4 * _slice_len(PAGED_STEP, n_steps, page, n_pt))
    splits, per = split_plan(n_steps, heads, smem)
    extra = 4 * _slice_len(PAGED_STEP, per, page, n_pt)
    lds, smem = tile_layout(PAGED_STEP, head_dim, group, item, vec, extra)
    return dict(lds=lds, smem=smem, vec=vec,
                stages=ring_stages(head_dim, group, item, vec, extra),
                splits=splits,
                steps_per_split=per, extra_bytes=extra,
                grid=(kv_heads * _subgroups(group), batch, splits))


def _paged_geometry(variant: PagedFlashDecodeVariant, seq: int):
    """(page, pages per request) that ``_paged_run`` lays a ``seq``-row
    cache out in."""
    page = min(variant.page_size, -(-seq // 8) * 8)
    return page, -(-seq // page)


def paged_launch_key(variant: PagedFlashDecodeVariant, *, batch: int,
                     q_heads: int, kv_heads: int, head_dim: int, seq: int,
                     dtype, mean_kv_len: float | None = None):
    """What the paged genome launches on one test: the page its suite is
    laid out in (capped by the cache's rows) and the template flags."""
    return (_paged_geometry(variant, seq)[0], variant.mask_oob,
            variant.use_reciprocal)


def paged_cost(variant: PagedFlashDecodeVariant, *, batch: int,
               q_heads: int, kv_heads: int, head_dim: int, seq: int, dtype,
               mean_kv_len: float | None = None):
    """Analytic H100 cost of the paged kernel on a ``seq``-row cache paged
    as ``_paged_run`` pages it: the table's rows in 64-row steps, the
    page-table reads, and under ``mask_oob`` the share of steps below the
    mean ``kv_len``."""
    page, n_pt = _paged_geometry(variant, seq)
    rows_total = n_pt * page
    n_steps = -(-rows_total // PAGED_STEP)
    frac, moved = 1.0, float(rows_total)
    if variant.mask_oob and mean_kv_len is not None:
        frac = min(1.0, (mean_kv_len / PAGED_STEP + 1) / n_steps)
        moved = min(float(rows_total), mean_kv_len)
    plan = paged_launch_plan(batch=batch, q_heads=q_heads,
                             kv_heads=kv_heads, head_dim=head_dim, page=page,
                             n_pt=n_pt, dtype=dtype)
    return _split_cost(batch=batch, q_heads=q_heads, kv_heads=kv_heads,
                       head_dim=head_dim, dtype=dtype, step=PAGED_STEP,
                       rows_total=rows_total, rows_moved=moved, frac=frac,
                       use_reciprocal=variant.use_reciprocal,
                       extra_bytes=plan["extra_bytes"],
                       table_bytes=4 * batch * n_pt)


# pools of the suite's caches, by cache and page size: a test is paged
# once, not at every timed call; an entry goes with its cache
_PAGED_MEMO: dict = {}


def _page_kv(k, v, page: int):
    """Pack a contiguous ``[b, s, hkv, d]`` cache into a shuffled physical
    pool and page table (the search's stand-in for the engine's
    allocator): s padded with zero rows to a multiple of ``page``, logical
    page ``j`` of request ``i`` at physical page ``perm[i * n_pt + j]`` of
    one fixed permutation (``default_rng(17)``, as JAX)."""
    b, s, hkv, dh = k.shape
    n_pt = -(-s // page)
    pad = (0, 0, 0, 0, 0, n_pt * page - s)
    k = torch.nn.functional.pad(k, pad).reshape(b * n_pt, page, hkv, dh)
    v = torch.nn.functional.pad(v, pad).reshape(b * n_pt, page, hkv, dh)
    perm = torch.from_numpy(np.random.default_rng(17).permutation(b * n_pt)
                            .astype(np.int32)).to(k.device)
    k_pages, v_pages = torch.zeros_like(k), torch.zeros_like(v)
    k_pages[perm.long()] = k
    v_pages[perm.long()] = v
    return k_pages, v_pages, perm.reshape(b, n_pt)


def _paged_run(variant, q, k, v, kv_len):
    page = _paged_geometry(variant, k.shape[1])[0]
    key = (id(k), id(v), page)
    hit = _PAGED_MEMO.get(key)
    if hit is None or hit[0]() is not k or hit[1]() is not v:
        hit = (weakref.ref(k), weakref.ref(v), _page_kv(k, v, page))
        _PAGED_MEMO[key] = hit
        weakref.finalize(k, _PAGED_MEMO.pop, key, None)
    k_pages, v_pages, table = hit[2]
    return paged_flash_decode_attention(q, k_pages, v_pages, table,
                                        kv_len=kv_len, variant=variant)


PAGED_SUITE_SHAPES = (
    {"batch": 2, "q_heads": 8, "kv_heads": 2, "head_dim": 64, "seq": 256},
    {"batch": 4, "q_heads": 4, "kv_heads": 4, "head_dim": 64, "seq": 512},
)


@register_kernel_space
def _paged_space() -> KernelSpace:
    return KernelSpace(
        name="paged_flash_decode",
        baseline=PAGED_BASELINE,
        default=PAGED_OPTIMIZED,
        run=_paged_run,
        oracle=_oracle,       # paging and the gather reproduce contiguous
        cost=paged_cost,
        knobs=(
            Knob("page_size", "pow2", 8, 256,
                 attacks=("overhead", "memory"),
                 note="KV pool granule the suite is paged in; the kernel "
                      "steps 64 rows whatever the page"),
            Knob("mask_oob", "bool", attacks=("memory", "compute"),
                 target=True,
                 note="visit and read only the rows below kv_len"),
            Knob("use_reciprocal", "bool", attacks=("compute",), target=True),
        ),
        suite_shapes=PAGED_SUITE_SHAPES,
        make_inputs=make_inputs,
        launch_key=paged_launch_key,
    )
