"""Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (it builds the kernel
library at first use) and skips without one. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 rtol 1e-5 / atol 1e-4 and bf16 3e-2 / 3e-2, the JAX
package's kernel tolerances; the decode attentions and the prefill
attention in bf16 1e-2 / 4e-3.
The kernels sum in another order than the plain versions and use CUDA's
expf/rsqrtf, so fp32 agrees to rounding.
Each genome's kernel is held against the same genome's plain version; a
-inf score must match exactly.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import costmodel  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_decode, fused_add_rmsnorm, merge_attn_states, ops,
    prefill_attention, ref, registry, silu_and_mul)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# the decode attentions in bf16: from their error on the card, tight
# enough to flag a step's rows missing where |out| is ~0.02 (chip_smoke)
DECODE_TOL = {**TOL, torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, tols=TOL):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               **tols[dtype])


def _randn(shape, dtype, dev, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.tensor(x, dtype=torch.float32).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 896), (8, 896), (256, 896),
                                    (17, 100), (33, 4096)])
def test_fused_add_rmsnorm_matches_plain(dev, rows, d, dtype):
    x = _randn((rows, d), dtype, dev, 0)
    r = _randn((rows, d), dtype, dev, 1)
    w = _randn((d,), torch.float32, dev, 2) * 0.1 + 1.0
    n0 = fused_add_rmsnorm.fused_add_rmsnorm.launches
    y, r_new = ops.fused_add_rmsnorm(x, r, w, 1e-6)
    torch.cuda.synchronize()
    assert fused_add_rmsnorm.fused_add_rmsnorm.launches == n0 + 1
    y_ref, r_ref = ref.fused_add_rmsnorm(x, r, w, 1e-6)
    _close(y, y_ref, dtype)
    _close(r_new, r_ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 4864), (8, 4864), (256, 4864),
                                    (17, 100), (33, 5)])
def test_silu_and_mul_matches_plain(dev, rows, d, dtype):
    x = _randn((rows, 2 * d), dtype, dev, 3, scale=3.0)
    n0 = silu_and_mul.silu_and_mul.launches
    out = ops.silu_and_mul(x)
    torch.cuda.synchronize()
    assert silu_and_mul.silu_and_mul.launches == n0 + 1
    _close(out, ref.silu_and_mul(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 8, 2048), (64, 40, 2048),
                                   (40, 24, 1024), (4, 3, 200)], ids=str)
def test_silu_and_mul_on_the_expert_tensor_matches_plain(dev, shape, dtype):
    """The MoE layer's call: the experts' ``[E, rows, 2 * expert_ff]``
    tensor in one launch (olmoe's decode and 256-token prefill, granite's
    prefill, a ragged width)."""
    x = _randn(shape, dtype, dev, 4, scale=3.0)
    n0 = silu_and_mul.silu_and_mul.launches
    out = ops.silu_and_mul(x)
    torch.cuda.synchronize()
    assert silu_and_mul.silu_and_mul.launches == n0 + 1
    assert out.shape == (*shape[:2], shape[2] // 2)
    _close(out, ref.silu_and_mul(x), dtype)


def _bool_genomes(base, *flags):
    """``base`` with every combination of the bool ``flags``."""
    return [dataclasses.replace(base, name="-".join(
                f"{f}={int(v)}" for f, v in zip(flags, vals)),
                **dict(zip(flags, vals)))
            for vals in itertools.product((False, True), repeat=len(flags))]


PAGED_GENOMES = _bool_genomes(flash_decode.PAGED_OPTIMIZED, "mask_oob",
                              "use_reciprocal")
FLASH_GENOMES = _bool_genomes(flash_decode.OPTIMIZED, "mask_oob",
                              "use_reciprocal")


def paged_case(b, hq, hkv, dh, page, n_pt, dtype, dev, seed=0, lens=None):
    """Pools, a shuffled page table whose tail past kv_len points at trap
    page 0, and ragged lengths including 1 and an exact page multiple (or
    ``lens``)."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_pt + 1
    if lens is None:
        lens = rng.integers(1, n_pt * page + 1, size=b)
        lens[0] = 1
        if b > 1:
            lens[1] = 2 * page
    lens = np.asarray(lens)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_pt), np.int32)
    for i in range(b):
        used = -(-int(lens[i]) // page)
        table[i, :used] = perm[i * n_pt:i * n_pt + used]
    q = _randn((b, hq, dh), dtype, dev, seed + 1)
    k = _randn((n_pages, page, hkv, dh), dtype, dev, seed + 2)
    v = _randn((n_pages, page, hkv, dh), dtype, dev, seed + 3)
    return (q, k, v, torch.tensor(table, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,dh", [(14, 2, 64), (32, 8, 128),
                                       (8, 8, 64), (10, 2, 128)])
def test_paged_decode_matches_plain(dev, hq, hkv, dh, dtype):
    q, k, v, table, lens = paged_case(8, hq, hkv, dh, 16, 20, dtype, dev)
    n0 = flash_decode.paged_flash_decode_attention.launches
    out = ops.paged_flash_decode_attention(q, k, v, table, kv_len=lens)
    torch.cuda.synchronize()
    assert flash_decode.paged_flash_decode_attention.launches == n0 + 1
    want = ref.paged_flash_decode_attention(q, k, v, table, kv_len=lens)
    _close(out, want, dtype, DECODE_TOL)


@pytest.mark.parametrize("genome", [g for g in PAGED_GENOMES
                                    if g.mask_oob], ids=lambda g: g.name)
def test_paged_decode_never_reads_past_kv_len(dev, genome):
    """Under ``mask_oob`` rows past kv_len are never read: NaN in every
    trap-page row and in the unused tail of each request's last page
    leaves the output finite."""
    q, k, v, table, lens = paged_case(8, 14, 2, 64, 16, 20, torch.bfloat16,
                                      dev)
    k[0] = float("nan")
    v[0] = float("nan")
    for i in range(8):
        n = int(lens[i])
        last = int(table[i, (n - 1) // 16])
        k[last, (n - 1) % 16 + 1:] = float("nan")
        v[last, (n - 1) % 16 + 1:] = float("nan")
    out = flash_decode.paged_flash_decode_attention(q, k, v, table,
                                                    kv_len=lens,
                                                    variant=genome)
    assert torch.isfinite(out.float()).all()


MERGE_GENOMES = _bool_genomes(merge_attn_states.OPTIMIZED, "hoist",
                              "use_reciprocal", "fuse_s_out")
RMS_GENOMES = _bool_genomes(fused_add_rmsnorm.OPTIMIZED, "two_pass",
                            "use_rsqrt", "accum_fp32")
SILU_GENOMES = _bool_genomes(silu_and_mul.OPTIMIZED, "compute_fp32",
                             "use_reciprocal", "fast_exp", "fused_split")


def _merge_inputs(shape, dtype, dev, seed=0):
    case = merge_attn_states.make_inputs(shape, dtype=dtype, seed=seed,
                                         device=dev)
    va, sa, vb, sb = case.args
    sa[0, :2] = float("-inf")                   # one side empty
    sa[1, 0] = sb[1, 0] = float("-inf")         # both empty
    return va, sa, vb, sb


def _close_scores(got, want):
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert not torch.isnan(got).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin].cpu(), want[fin].cpu(),
                               **TOL[torch.float32])


@pytest.mark.parametrize("shape", merge_attn_states.SUITE_SHAPES,
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genome", MERGE_GENOMES, ids=lambda g: g.name)
def test_merge_matches_plain(dev, genome, dtype, shape):
    va, sa, vb, sb = _merge_inputs(shape, dtype, dev)
    n0 = merge_attn_states.merge_attn_states_lse.launches
    v, s = merge_attn_states.merge_attn_states_lse(va, sa, vb, sb, genome)
    torch.cuda.synchronize()
    assert merge_attn_states.merge_attn_states_lse.launches == \
        n0 + (1 if genome.fuse_s_out else 2)
    v_want, s_want = merge_attn_states.plain(genome, va, sa, vb, sb)
    _close(v, v_want, dtype)
    _close_scores(s, s_want)
    assert (v[1, 0] == 0).all() and torch.isneginf(s[1, 0])


@pytest.mark.parametrize("block_rows", [8, 16, 32])
def test_merge_block_rows_and_strided_scores(dev, block_rows):
    """A ragged row count (700), every launchable block_rows, scores handed
    in as transposed views; block_rows 64 (2,048 threads) is refused."""
    va, sa, vb, sb = _merge_inputs({"seq": 100, "heads": 7,
                                    "head_dim": 128}, torch.bfloat16, dev)
    sa_t = sa.t().contiguous().t()              # same values, strided
    sb_t = sb.t().contiguous().t()
    assert not sa_t.is_contiguous()
    genome = dataclasses.replace(merge_attn_states.OPTIMIZED,
                                 block_rows=block_rows)
    v, s = merge_attn_states.merge_attn_states_lse(va, sa_t, vb, sb_t,
                                                   genome)
    v_want, s_want = merge_attn_states.plain(genome, va, sa, vb, sb)
    _close(v, v_want, torch.bfloat16)
    _close_scores(s, s_want)
    with pytest.raises(ValueError):
        merge_attn_states.merge_attn_states_lse(
            va, sa, vb, sb, dataclasses.replace(genome, block_rows=64))


def test_merge_both_sides_empty_gives_zero_and_neg_inf(dev):
    v = torch.randn(4, 3, 64, device=dev)
    s = torch.full((4, 3), float("-inf"), device=dev)
    for genome in MERGE_GENOMES:
        out, lse = merge_attn_states.merge_attn_states_lse(v, s, v, s,
                                                           genome)
        assert (out == 0).all() and torch.isneginf(lse).all()


@pytest.mark.parametrize("rows,d", [(8, 896), (33, 5120), (1024, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genome", RMS_GENOMES, ids=lambda g: g.name)
def test_fused_add_rmsnorm_genome_matches_plain(dev, genome, dtype, rows,
                                                d):
    x = _randn((rows, d), dtype, dev, 0)
    r = _randn((rows, d), dtype, dev, 1)
    w = _randn((d,), torch.float32, dev, 2) * 0.1 + 1.0
    n0 = fused_add_rmsnorm.fused_add_rmsnorm.launches
    y, r_new = fused_add_rmsnorm.fused_add_rmsnorm(x, r, w, 1e-6, genome)
    torch.cuda.synchronize()
    assert fused_add_rmsnorm.fused_add_rmsnorm.launches == \
        n0 + (2 if genome.two_pass else 1)
    y_want, r_want = fused_add_rmsnorm.plain(genome, x, r, w, 1e-6)
    _close(y, y_want, dtype)
    _close(r_new, r_want, dtype)


@pytest.mark.parametrize("rows,d", [(8, 4864), (17, 11008), (64, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genome", SILU_GENOMES, ids=lambda g: g.name)
def test_silu_and_mul_genome_matches_plain(dev, genome, dtype, rows, d):
    x = _randn((rows, 2 * d), dtype, dev, 3, scale=3.0)
    out = silu_and_mul.silu_and_mul(x, genome)
    torch.cuda.synchronize()
    _close(out, silu_and_mul.plain(genome, x), dtype)


# the serve shapes (8 decode rows and a 4,096-row prefill at each width the
# two served models give rmsnorm and silu) and each kernel's suite shapes
SERVE_WIDTHS = (896, 2560, 4864, 6912)
SERVE_SHAPES = [(rows, d) for rows in (8, 4096) for d in SERVE_WIDTHS]


def _every_genome(space):
    """Every genome of ``space``: each value of each knob."""
    values = []
    for k in space.knobs:
        if k.kind == "bool":
            values.append((False, True))
        else:
            values.append(tuple(1 << b for b in range(
                k.lo.bit_length() - 1, k.hi.bit_length())))
    names = [k.name for k in space.knobs]
    return [dataclasses.replace(space.baseline, name="g", **dict(zip(
                names, vals))) for vals in itertools.product(*values)]


def _space_shapes(module):
    return SERVE_SHAPES + [(s["batch"], s["hidden"])
                           for s in module.SUITE_SHAPES]


def _flags(space, genome):
    """The genome's bool knobs: what its plain version depends on."""
    return tuple(getattr(genome, k.name) for k in space.knobs
                 if k.kind == "bool")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", _space_shapes(fused_add_rmsnorm), ids=str)
def test_every_rmsnorm_genome_matches_plain(dev, rows, d, dtype):
    """Every genome of the space (flags x rows a block x threads a row)
    that can launch at this shape, against its plain version; the weight
    in fp32 at the serve widths (as served), in the input dtype at the
    suite's (as the suite makes it). A genome that cannot launch raises."""
    space = registry.get_space("fused_add_rmsnorm")
    x, r = _randn((rows, d), dtype, dev, 0), _randn((rows, d), dtype, dev, 1)
    wdtype = torch.float32 if d in SERVE_WIDTHS else dtype
    w = (_randn((d,), torch.float32, dev, 2) * 0.1 + 1.0).to(wdtype)
    vec = 16 // x.element_size()
    plains, ran = {}, 0
    for g in _every_genome(space):
        if fused_add_rmsnorm.why_not(g, rows, d, vec, w.element_size()):
            with pytest.raises(ValueError):
                fused_add_rmsnorm.fused_add_rmsnorm(x, r, w, 1e-6, g)
            continue
        key = _flags(space, g)
        if key not in plains:
            plains[key] = fused_add_rmsnorm.plain(g, x, r, w, 1e-6)
        got = fused_add_rmsnorm.fused_add_rmsnorm(x, r, w, 1e-6, g)
        for a, b in zip(got, plains[key]):
            torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])
        ran += 1
    assert ran >= 8 * 5           # every flag at every rows a block at least


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", _space_shapes(silu_and_mul), ids=str)
def test_every_silu_genome_matches_plain(dev, rows, d, dtype):
    """Every genome of the space (flags x rows a step x threads a block)
    that can launch, against its plain version; the others raise."""
    space = registry.get_space("silu_and_mul")
    x = _randn((rows, 2 * d), dtype, dev, 3, scale=3.0)
    vec = 16 // x.element_size()
    plains, ran = {}, 0
    for g in _every_genome(space):
        if silu_and_mul.why_not(g, vec):
            with pytest.raises(ValueError):
                silu_and_mul.silu_and_mul(x, g)
            continue
        key = _flags(space, g)
        if key not in plains:
            plains[key] = silu_and_mul.plain(g, x).float()
        torch.testing.assert_close(silu_and_mul.silu_and_mul(x, g).float(),
                                   plains[key], **TOL[dtype])
        ran += 1
    assert ran >= 16 * 5


def _kernels_launched(fn) -> int:
    """CUDA kernels the profiler sees ``fn`` launch."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower())


@pytest.mark.parametrize("genome", [fused_add_rmsnorm.OPTIMIZED,
                                    fused_add_rmsnorm.BASELINE],
                         ids=lambda g: g.name)
def test_rmsnorm_with_a_bf16_weight_launches_only_what_it_counts(dev,
                                                                 genome):
    """A bf16 weight is read as it is stored: the counter equals the
    kernels the card ran (no cast kernel), and (y, r') equal those of its
    fp32 widening bit for bit."""
    x = _randn((33, 5120), torch.bfloat16, dev, 0)
    r = _randn((33, 5120), torch.bfloat16, dev, 1)
    w = (_randn((5120,), torch.float32, dev, 2) * 0.1 + 1.0).to(
        torch.bfloat16)
    fused_add_rmsnorm.fused_add_rmsnorm(x, r, w, 1e-6, genome)   # warm
    n0 = fused_add_rmsnorm.fused_add_rmsnorm.launches
    out = []
    seen = _kernels_launched(lambda: out.append(
        fused_add_rmsnorm.fused_add_rmsnorm(x, r, w, 1e-6, genome)))
    assert seen == fused_add_rmsnorm.fused_add_rmsnorm.launches - n0
    assert seen == (2 if genome.two_pass else 1)
    y, r_new = out[0]
    y32, r32 = fused_add_rmsnorm.fused_add_rmsnorm(x, r, w.float(), 1e-6,
                                                   genome)
    assert torch.equal(y, y32) and torch.equal(r_new, r32)


CHAIN = 50


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genome", [fused_add_rmsnorm.OPTIMIZED,
                                    fused_add_rmsnorm.BASELINE,
                                    dataclasses.replace(
                                        fused_add_rmsnorm.OPTIMIZED,
                                        name="stacked", block_rows=16,
                                        row_threads=256)],
                         ids=lambda g: g.name)
def test_a_dependent_rmsnorm_chain_waits_for_its_inputs(dev, genome, dtype):
    """50 calls, each on the previous call's y and r', behind a PyTorch op
    that writes the first x and r: eagerly, and replayed from a CUDA graph
    after the source changes. Every call equals the plain version of its
    own inputs (the previous call's outputs, or the source), so a call
    that read a stale or half-written input fails. ("stacked": row groups
    that walk several rows, the next one queued by cp.async.)"""
    rows, d = 256, 2560
    src = _randn((2, rows, d), dtype, dev, 0)
    w = _randn((d,), torch.float32, dev, 2) * 0.1 + 1.0
    x, r = torch.empty_like(src[0]), torch.empty_like(src[0])

    def run():
        torch.mul(src[0], 1.0, out=x)
        torch.mul(src[1], 1.0, out=r)
        steps = [(x, r)]
        for _ in range(CHAIN):
            steps.append(fused_add_rmsnorm.fused_add_rmsnorm(
                *steps[-1], w, 1e-6, genome))
        return steps

    def check(steps):
        torch.cuda.synchronize()
        inputs = [(src[0], src[1])] + steps[1:-1]
        for (a, b), got in zip(inputs, steps[1:]):
            want = fused_add_rmsnorm.plain(genome, a, b, w, 1e-6)
            for g, e in zip(got, want):
                torch.testing.assert_close(g.float(), e.float(), **TOL[dtype])

    check(run())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                          # warm the pool
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        steps = run()
    for seed in (5, 6):
        src.copy_(_randn((2, rows, d), dtype, dev, seed))
        graph.replay()
        check(steps)


def test_launch_knobs_that_do_not_fit_raise_on_the_card(dev):
    """One warp a row cannot hold a row of 14,336 in registers, and a
    step of 16 rows holds a silu block to 256 threads: both raise before
    anything launches."""
    x = _randn((4, 14336), torch.float32, dev, 0)
    g = dataclasses.replace(fused_add_rmsnorm.OPTIMIZED, row_threads=32)
    n0 = fused_add_rmsnorm.fused_add_rmsnorm.launches
    with pytest.raises(ValueError, match="registers"):
        fused_add_rmsnorm.fused_add_rmsnorm(x, x, x[0], 1e-6, g)
    with pytest.raises(ValueError, match="float32 or"):
        fused_add_rmsnorm.fused_add_rmsnorm(x, x, x[0].half())
    assert fused_add_rmsnorm.fused_add_rmsnorm.launches == n0
    g = dataclasses.replace(silu_and_mul.OPTIMIZED, block_rows=16,
                            block_cols=512)
    with pytest.raises(ValueError, match="256"):
        silu_and_mul.silu_and_mul(x, g)


def flash_case(b, hq, hkv, dh, s, dtype, dev, seed=0, lens=None):
    """q, k, v and ragged kv_len with 0, 1 and s (or ``lens``)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(1, s + 1, size=b)
        lens[:3] = (0, 1, s)[:b]
    return (_randn((b, hq, dh), dtype, dev, seed + 1),
            _randn((b, s, hkv, dh), dtype, dev, seed + 2),
            _randn((b, s, hkv, dh), dtype, dev, seed + 3),
            torch.tensor(lens, dtype=torch.int32, device=dev))


# (b, hq, hkv, dh, s): h2o-danube's group 4 at 80, qwen2's group 7 at 64,
# a ragged 100 (one element at a time, no 16-byte vectors), group 1, and
# group 12 (two blocks of queries a kv head)
FLASH_SHAPES = [(8, 32, 8, 80, 1000), (8, 14, 2, 64, 512),
                (3, 4, 2, 100, 77), (4, 16, 16, 128, 300),
                (2, 24, 2, 64, 200)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("mask_oob,rcp",
                         list(itertools.product((False, True), repeat=2)))
def test_flash_decode_matches_plain(dev, shape, dtype, chunk, mask_oob,
                                    rcp):
    """Every bool combination at several chunks, against the same
    genome's plain version; kv_len 0, 1 and s included."""
    genome = flash_decode.FlashDecodeVariant(
        name="case", chunk=chunk, use_reciprocal=rcp, mask_oob=mask_oob)
    b, hq, hkv, dh, s = shape
    vec = costmodel.vector_elems(dh, dtype.itemsize)
    _, smem = flash_decode.tile_layout(min(chunk, s), dh, hq // hkv,
                                       dtype.itemsize, vec)
    if smem > flash_decode.SMEM_PER_BLOCK:
        pytest.skip("this chunk does not fit at this width (the cost model "
                    "screens it)")
    q, k, v, lens = flash_case(*shape, dtype, dev)
    n0 = flash_decode.flash_decode_attention.launches
    got = flash_decode.flash_decode_attention(q, k, v, kv_len=lens,
                                              variant=genome)
    torch.cuda.synchronize()
    assert flash_decode.flash_decode_attention.launches == n0 + 1
    _close(got, flash_decode.plain(genome, q, k, v, lens, dh ** -0.5),
           dtype, DECODE_TOL)
    if mask_oob:
        assert (got[0] == 0).all()                  # kv_len 0: no row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_olmoe_decode_shape(dev, dtype):
    """olmoe-1b-7b's decode attention: 8 slots, 16 query and 16 kv heads
    (group 1) of 128 on a 512-row cache, the shipped genome against its
    plain version at the decode tolerance; kv_len 0, 1 and 512
    included."""
    genome = ops.get_variant("flash_decode")
    q, k, v, lens = flash_case(8, 16, 16, 128, 512, dtype, dev, seed=7)
    got = ops.flash_decode_attention(q, k, v, kv_len=lens)
    torch.cuda.synchronize()
    _close(got, flash_decode.plain(genome, q, k, v, lens, 128 ** -0.5),
           dtype, DECODE_TOL)


def test_flash_decode_reads_misaligned_caches_and_clamps_kv_len(dev):
    """A cache that starts off a 16-byte boundary takes the element path;
    kv_len past s reads s rows."""
    b, hq, hkv, dh, s = 2, 8, 2, 64, 90
    q, k, v, _ = flash_case(b, hq, hkv, dh, s, torch.bfloat16, dev)
    n = k.numel()
    k1 = torch.empty(n + 1, dtype=k.dtype, device=dev)[1:].view(k.shape)
    v1 = torch.empty(n + 1, dtype=v.dtype, device=dev)[1:].view(v.shape)
    k1.copy_(k)
    v1.copy_(v)
    lens = torch.tensor([s + 7, 33], dtype=torch.int32, device=dev)
    got = ops.flash_decode_attention(q, k1, v1, kv_len=lens)
    want = ops.flash_decode_attention(q, k, v, kv_len=lens.clamp(max=s))
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, DECODE_TOL)
    _close(got, ref.flash_decode_attention(q, k, v, kv_len=lens),
           torch.bfloat16, DECODE_TOL)


def test_flash_decode_on_the_card_launches_or_raises(dev, monkeypatch):
    """A CUDA tensor never takes the plain version: it launches the
    kernel, or raises before any launch on what the kernel cannot take."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(flash_decode, "plain", refuse)
    q, k, v, lens = flash_case(2, 8, 2, 80, 64, torch.bfloat16, dev)
    fn = flash_decode.flash_decode_attention
    n0 = fn.launches
    fn(q, k, v, kv_len=lens)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    wide = flash_case(2, 8, 8, 128, 300, torch.float32, dev)
    bad = [
        ((q, k.transpose(1, 2), v), dict(kv_len=lens)),     # not [b,s,h,d]
        ((q, k[:, ::2], v[:, ::2]), dict(kv_len=lens)),     # strided
        ((q, k.float(), v), dict(kv_len=lens)),             # mixed dtypes
        ((q, k, v), dict(kv_len=lens.long())),              # int64 lengths
        ((q.half(), k.half(), v.half()), dict(kv_len=lens)),  # fp16
        ((q, k, v), dict(kv_len=lens,
                         variant=dataclasses.replace(
                             flash_decode.OPTIMIZED, chunk=0))),
        (wide[:3], dict(kv_len=wide[3],                     # > 227 KB
                        variant=dataclasses.replace(
                            flash_decode.OPTIMIZED, chunk=256))),
    ]
    for args, kw in bad:
        with pytest.raises((ValueError, TypeError)):
            fn(*args, **kw)
    assert fn.launches == n0 + 1


def _split_edges(plan, s, step, b):
    """kv_len at 0, 1, s and each split boundary - 1, + 0, + 1, in batches
    of ``b`` requests (the last one filled up with s)."""
    per = plan["steps_per_split"] * step
    edges = {0, 1, s}
    for sp in range(1, plan["splits"]):
        edges.update((sp * per - 1, sp * per, sp * per + 1))
    edges = sorted(e for e in edges if 0 <= e <= s)
    edges += [s] * (-len(edges) % b)
    return [edges[i:i + b] for i in range(0, len(edges), b)]


# (b, hkv, dh, s, chunk): the h2o-danube decode shape, qwen2's contiguous
# one, and caches one row past a split edge
SPLIT_SHAPES = [(8, 8, 80, 4096, 64), (8, 2, 64, 512, 64),
                (4, 2, 64, 3 * 64 + 1, 64), (2, 2, 80, 33 * 16 + 1, 16)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genome", FLASH_GENOMES, ids=lambda g: g.name)
def test_flash_decode_splits_at_every_edge(dev, shape, dtype, genome):
    """kv_len at 0, 1, s and at each split boundary +- 1; splits come from
    the shapes (none of these is one split)."""
    b, hkv, dh, s, chunk = shape
    genome = dataclasses.replace(genome, chunk=chunk)
    plan = flash_decode.launch_plan(genome, batch=b, q_heads=4 * hkv,
                                    kv_heads=hkv, head_dim=dh, seq=s,
                                    dtype=dtype)
    assert plan["splits"] > 1
    for lens in _split_edges(plan, s, min(chunk, s), b):
        q, k, v, n = flash_case(b, 4 * hkv, hkv, dh, s, dtype, dev,
                                lens=lens)
        got = flash_decode.flash_decode_attention(q, k, v, kv_len=n,
                                                  variant=genome)
        _close(got, flash_decode.plain(genome, q, k, v, n, dh ** -0.5),
               dtype, DECODE_TOL)
        if genome.mask_oob and lens[0] == 0:
            assert (got[0] == 0).all()


def test_decode_counters_reset_between_calls(dev):
    """Two calls in a row with other lengths each match the plain version,
    and every counter is back at 0 after them."""
    genome = flash_decode.OPTIMIZED
    q, k, v, n = flash_case(8, 32, 8, 80, 1000, torch.bfloat16, dev)
    for lens in (n, n.flip(0)):
        got = flash_decode.flash_decode_attention(q, k, v, kv_len=lens,
                                                  variant=genome)
        _close(got, flash_decode.plain(genome, q, k, v, lens, 80 ** -0.5),
               torch.bfloat16, DECODE_TOL)
    pq, pk, pv, table, plens = paged_case(8, 14, 2, 64, 16, 32,
                                          torch.bfloat16, dev)
    for lens in (plens, plens.flip(0)):
        got = flash_decode.paged_flash_decode_attention(pq, pk, pv, table,
                                                        kv_len=lens)
        _close(got, flash_decode.paged_plain(
            flash_decode.PAGED_OPTIMIZED, pq, pk, pv, table, lens,
            64 ** -0.5), torch.bfloat16, DECODE_TOL)
    torch.cuda.synchronize()
    assert (flash_decode._COUNTERS[q.device] == 0).all()


@pytest.mark.parametrize("paged", [False, True])
def test_decode_call_replays_in_a_cuda_graph(dev, paged):
    """A call captured in a CUDA graph and replayed with new kv_len values
    matches the plain version: no host sync, splits not from kv_len."""
    if paged:
        q, k, v, table, lens = paged_case(8, 14, 2, 64, 16, 32,
                                          torch.bfloat16, dev)
        genome = flash_decode.PAGED_OPTIMIZED

        def call():
            return flash_decode.paged_flash_decode_attention(
                q, k, v, table, kv_len=lens, variant=genome)

        def want():
            return flash_decode.paged_plain(genome, q, k, v, table, lens,
                                            64 ** -0.5)
    else:
        q, k, v, lens = flash_case(8, 32, 8, 80, 1000, torch.bfloat16, dev)
        genome = flash_decode.OPTIMIZED

        def call():
            return flash_decode.flash_decode_attention(
                q, k, v, kv_len=lens, variant=genome)

        def want():
            return flash_decode.plain(genome, q, k, v, lens, 80 ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                                  # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    limit = k.shape[1] if not paged else table.shape[1] * k.shape[1]
    rng = np.random.default_rng(5)
    for new in (rng.integers(1, limit + 1, size=8), np.zeros(8),
                np.full(8, limit)):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, want(), torch.bfloat16, DECODE_TOL)


def test_decode_checks_hold_over_rounds_and_replays(dev):
    """chip_smoke's order, ten rounds in one process: the paged calls at
    14/2 and 32/8 and the contiguous ones at h2o-danube's group, every
    genome, each called, then captured in a CUDA graph and replayed with
    new kv_len values; every output matches its plain version at every
    round, and every counter is back at 0 after."""
    cases = []
    for hq, hkv, dh in ((14, 2, 64), (32, 8, 128)):
        q, k, v, table, lens = paged_case(8, hq, hkv, dh, 16, 32,
                                          torch.bfloat16, dev)
        for g in PAGED_GENOMES:
            cases.append((lens, 512, functools.partial(
                flash_decode.paged_flash_decode_attention, q, k, v, table,
                kv_len=lens, variant=g), functools.partial(
                flash_decode.paged_plain, g, q, k, v, table, lens,
                dh ** -0.5)))
    q, k, v, lens = flash_case(8, 32, 8, 80, 1000, torch.bfloat16, dev)
    for g in FLASH_GENOMES:
        cases.append((lens, 1000, functools.partial(
            flash_decode.flash_decode_attention, q, k, v, kv_len=lens,
            variant=g), functools.partial(flash_decode.plain, g, q, k, v,
                                          lens, 80 ** -0.5)))
    rng = np.random.default_rng(9)
    for _ in range(10):
        for lens, limit, call, want in cases:
            lens.copy_(torch.tensor(rng.integers(0, limit + 1, size=8),
                                    dtype=torch.int32))
            _close(call(), want(), torch.bfloat16, DECODE_TOL)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call()
            for _ in range(3):
                lens.copy_(torch.tensor(rng.integers(0, limit + 1, size=8),
                                        dtype=torch.int32))
                graph.replay()
                torch.cuda.synchronize()
                _close(out, want(), torch.bfloat16, DECODE_TOL)
    assert (flash_decode._COUNTERS[q.device] == 0).all()


def test_outgrown_counters_stay_alive_for_captured_graphs(dev):
    """A graph captured before the counters grow still replays right
    after: the outgrown buffer is retired, not freed, so a replay never
    writes memory the allocator has handed to another tensor."""
    q, k, v, table, lens = paged_case(8, 14, 2, 64, 16, 32, torch.bfloat16,
                                      dev)
    genome = flash_decode.PAGED_OPTIMIZED
    call = functools.partial(flash_decode.paged_flash_decode_attention, q,
                             k, v, table, kv_len=lens, variant=genome)
    call()                          # the counters exist before capture
    old = flash_decode._COUNTERS[q.device]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    grown = flash_decode._counters(q.device, old.numel() + 1)
    assert grown.data_ptr() != old.data_ptr()
    assert any(r is old for r in flash_decode._RETIRED)
    fill = [torch.full((old.numel(),), 7, dtype=torch.int32, device=dev)
            for _ in range(8)]
    for new in ((1, 64, 300, 512, 17, 0, 200, 99), (512,) * 8):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, flash_decode.paged_plain(genome, q, k, v, table, lens,
                                             64 ** -0.5),
               torch.bfloat16, DECODE_TOL)
    assert all((f == 7).all() for f in fill)
    assert (old == 0).all()
    _close(call(), flash_decode.paged_plain(genome, q, k, v, table, lens,
                                            64 ** -0.5),
           torch.bfloat16, DECODE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genome", PAGED_GENOMES, ids=lambda g: g.name)
@pytest.mark.parametrize("hq,hkv,dh,page,n_pt", [
    (14, 2, 64, 16, 32), (32, 8, 128, 16, 20), (8, 2, 80, 8, 40),
    (12, 4, 64, 64, 5), (4, 1, 64, 24, 9), (24, 2, 64, 16, 12)])
def test_paged_genomes_match_paged_plain(dev, genome, dtype, hq, hkv, dh,
                                         page, n_pt):
    """Every genome against its plain version: kv_len 0, 1, the table's
    rows and each split boundary +- 1, each request's table tail on the
    trap page (the engine's layout); pow2 and other page sizes, group
    12."""
    b, rows = 8, page * n_pt
    plan = flash_decode.paged_launch_plan(batch=b, q_heads=hq, kv_heads=hkv,
                                          head_dim=dh, page=page, n_pt=n_pt,
                                          dtype=dtype)
    assert plan["splits"] > 1
    for lens in _split_edges(plan, rows, flash_decode.PAGED_STEP, b):
        q, k, v, table, n = paged_case(b, hq, hkv, dh, page, n_pt, dtype,
                                       dev, lens=lens)
        n0 = flash_decode.paged_flash_decode_attention.launches
        got = flash_decode.paged_flash_decode_attention(q, k, v, table,
                                                        kv_len=n,
                                                        variant=genome)
        torch.cuda.synchronize()
        assert flash_decode.paged_flash_decode_attention.launches == n0 + 1
        want = flash_decode.paged_plain(genome, q, k, v, table, n,
                                        dh ** -0.5)
        _close(got, want, dtype, DECODE_TOL)
        if genome.mask_oob and lens[0] == 0:
            assert (got[0] == 0).all()              # kv_len 0: no row


def test_windowed_decode_on_the_card_matches_the_cpu(dev):
    """The h2o-danube smoke config in fp32: a prompt past the window, then
    decode steps that wrap the ring, card against CPU."""
    from repro_torch import configs
    from repro_torch.models import registry as models, transformer
    cfg = dataclasses.replace(configs.smoke("h2o-danube-1.8b"),
                              dtype="float32")
    gpu = models.init_params(cfg, seed=0)
    cpu = transformer.cast_params(gpu, cfg, torch.device("cpu"))
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (1, 100)))
    outs = []
    for params, d in ((gpu, dev), (cpu, torch.device("cpu"))):
        lg, kv = models.prefill(params, cfg, toks.to(d))
        cache = models.init_cache(cfg, 2, 192, d)
        models.write_slot(cfg, cache, kv, 1)
        logits = [lg.cpu()]
        for t in range(3):
            pos = torch.tensor([t, 100 + t], dtype=torch.int32, device=d)
            tok = torch.tensor([3, 5], dtype=torch.int32, device=d)
            lg, cache = models.decode_cached(params, cfg, cache, tok, pos)
            logits.append(lg.cpu())
        outs.append(logits)
    for g, c in zip(*outs):
        _close(g, c, torch.float32)


def test_reintegration_changes_what_the_wrappers_launch(dev, monkeypatch):
    monkeypatch.setattr(ops, "_OVERRIDES", {})
    x = _randn((8, 896), torch.bfloat16, dev, 0)
    r = _randn((8, 896), torch.bfloat16, dev, 1)
    w = torch.ones(896, device=dev)
    n0 = fused_add_rmsnorm.fused_add_rmsnorm.launches
    ops.fused_add_rmsnorm(x, r, w)
    assert fused_add_rmsnorm.fused_add_rmsnorm.launches == n0 + 1
    ops.set_variants(fused_add_rmsnorm=fused_add_rmsnorm.BASELINE)
    y, _ = ops.fused_add_rmsnorm(x, r, w)
    torch.cuda.synchronize()
    assert fused_add_rmsnorm.fused_add_rmsnorm.launches == n0 + 3
    _close(y, fused_add_rmsnorm.plain(fused_add_rmsnorm.BASELINE, x, r,
                                      w)[0], torch.bfloat16)


def test_agent_loop_on_the_card(dev):
    """A short greedy search per paper kernel on reduced suites, timed with
    CUDA events: the Log has rounds + 1 entries and its best is correct."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.search import SearchOrchestrator
    orch = SearchOrchestrator(
        testing=TestingAgent(dtypes=(torch.bfloat16,)),
        profiling=ProfilingAgent(reps=5, backend="cuda"))
    for name in registry.registered_kernels():
        space = registry.get_space(name)
        space = dataclasses.replace(space,
                                    suite_shapes=space.suite_shapes[-1:])
        log = orch.search(space, rounds=2)
        assert len(log.entries) == 3 and log.best().correct
        assert all(r["latency_us"] > 0 for e in log.entries
                   for r in e.perf.per_shape)


# -- the search in sandboxed workers on the card ------------------------------

def _verdicts(cache):
    return {k: (r.passed, r.validated, r.screened, r.finish_reason,
                r.failed_test, r.max_err) for k, r in cache.items()}


def test_process_search_gives_the_thread_verdicts_on_the_card(dev):
    """A greedy search of silu_and_mul in two workers on the card: every
    genome both paths evaluated has the thread path's verdict fields (the
    timings, hence maybe the path, differ), and the workers' launches are
    counted here."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.search import EvalCache, SearchOrchestrator
    space = registry.get_space("silu_and_mul")
    space = dataclasses.replace(space, suite_shapes=space.suite_shapes[-2:])
    caches = [EvalCache(), EvalCache()]
    logs = []
    for cache, isolation in zip(caches, ("thread", "process")):
        before = ops.launch_counts()["silu_and_mul"]
        with SearchOrchestrator(testing=TestingAgent(), cache=cache,
                                profiling=ProfilingAgent(reps=5,
                                                         backend="cuda"),
                                isolation=isolation, workers=2) as orch:
            logs.append(orch.search(space, rounds=3))
        assert ops.launch_counts()["silu_and_mul"] > before
    mine, ref = _verdicts(caches[1]), _verdicts(caches[0])
    common = set(mine) & set(ref)
    assert len(common) >= 2
    assert {k: mine[k] for k in common} == {k: ref[k] for k in common}
    stages = logs[1].meta["stages"]
    assert (stages["worker_crashes"], stages["eval_timeouts"],
            stages["quarantined"]) == (0, 0, 0)
    assert logs[1].best().correct


def _pool_batch(dev, **pool_kw):
    """(pool, results, launches counted here) of a four-genome rmsnorm
    batch, evaluated by two threads through a two-worker pool on the card,
    timed with CUDA events."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.search import EvalCache, EvalWorkerPool, TieredEvaluator
    space = registry.get_space("fused_add_rmsnorm")
    space = dataclasses.replace(space, suite_shapes=space.suite_shapes[:1])
    testing = TestingAgent(dtypes=(torch.bfloat16,))
    tests = registry.suite_tests(space, testing)
    base = space.baseline
    variants = [base, dataclasses.replace(base, two_pass=False),
                dataclasses.replace(base, use_rsqrt=True),
                dataclasses.replace(base, row_threads=128)]
    ev = TieredEvaluator()
    before = ops.launch_counts()
    with EvalWorkerPool(workers=2, on_stat=ev.bump, **pool_kw) as pool:
        results = ev.evaluate_many(
            space, variants, tests, testing=testing,
            profiling=ProfilingAgent(reps=5, backend="cuda"),
            cache=EvalCache(), workers=2, isolation="process", pool=pool)
    after = ops.launch_counts()
    return pool, results, {k: after[k] - before[k] for k in after}, ev


def test_the_pool_keeps_one_task_on_the_card(dev):
    """Two threads, two workers: the workers' task spans (host monotonic
    clock, taken in the children) never overlap, and every launch they
    made is counted in this process."""
    pool, results, launched, _ = _pool_batch(dev)
    assert all(r.passed for r in results)
    spans = sorted(pool.spans, key=lambda s: s["start"])
    assert len(spans) == 4 and len({s["pid"] for s in spans}) == 2
    for a, b in zip(spans, spans[1:]):
        assert a["end"] <= b["start"], (a, b)
    total = sum(s["launches"].get("fused_add_rmsnorm", 0) for s in spans)
    assert total > 0 and launched["fused_add_rmsnorm"] == total


def test_a_crashed_genome_is_never_launched_here(dev):
    """A genome that kills its worker twice is quarantined with the cost
    model's analytic profile, though the search times on the card: this
    process launches nothing for it (its counts grow by the workers'
    launches alone)."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.reliability import Fault, SearchChaosInjector
    from repro_torch.search import EvalCache
    space = registry.get_space("fused_add_rmsnorm")
    space = dataclasses.replace(space, suite_shapes=space.suite_shapes[:1])
    tests = registry.suite_tests(space, TestingAgent(dtypes=(torch.bfloat16,)))
    victim = dataclasses.replace(space.baseline, row_threads=128)
    digest = EvalCache().key(space.name, victim, tests,
                             launch_key=space.launch_key)[1]
    chaos = SearchChaosInjector([Fault("kill_worker", digest=digest,
                                       times=2)])
    pool, results, launched, ev = _pool_batch(dev, chaos=chaos,
                                              quarantine_after=2)
    crashed = results[3]
    assert crashed.failed_infra and ev.stats.quarantined == 1
    assert crashed.profile == ProfilingAgent(
        reps=5, backend="analytic").profile(space, victim, tests)
    assert [r.passed for r in results[:3]] == [True] * 3
    total = sum(s["launches"].get("fused_add_rmsnorm", 0)
                for s in pool.spans)
    assert launched["fused_add_rmsnorm"] == total


def test_a_worker_that_raised_is_replaced_on_the_card(dev):
    """An evaluation that raises in a worker on the card retires it (its
    context may hold a sticky error): the next task runs in a new
    process."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.search import EvalWorkerPool
    space = registry.get_space("silu_and_mul")
    task = dict(kernel="no_such_kernel", suite_shapes=space.suite_shapes[:1],
                variant=space.baseline, validate=True, tests_digest="x",
                prior=None, frozen=None,
                testing=TestingAgent(dtypes=(torch.bfloat16,)),
                profiling=ProfilingAgent(reps=5, backend="cuda"),
                config=dict(screen=True, smoke=True, share_oracle=True,
                            dominate_factor=3.0))
    with EvalWorkerPool(workers=1, quarantine_after=2) as pool:
        assert not pool.submit(task, digest="bad").ok
        assert pool.submit(dict(task, kernel=space.name),
                           digest="good").ok
    erred = {s["pid"] for s in pool.spans if s["status"] == "error"}
    assert len(erred) == 2 and pool.spans[-1]["status"] == "ok"
    assert pool.spans[-1]["pid"] not in erred


# -- the captured decode step of the serving engine ---------------------------

def _smoke(arch, dtype="float32"):
    from repro_torch import configs
    from repro_torch.models import registry as models
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    return cfg, models.init_params(cfg, seed=5, device="cpu")


def _serve(params, cfg, dev, lens, max_new, **kw):
    """(streams by rid, engine) of ``lens``-long seeded prompts."""
    from repro_torch.serving import Engine, Request
    eng = Engine(params, cfg, device=dev, **kw)
    rng = np.random.default_rng(5)
    for rid, n in enumerate(lens):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                           max_new_tokens=max_new))
    eng.run()
    if eng.cm.paged:
        eng.cm.pool.check()
    return {r.rid: list(r.out_tokens) for r in eng.finished}, eng


def _want_launches(cfg, paged, steps, prefills, warmups=0):
    """What the path launches: rmsnorm (twice a call for a two-pass
    genome) 2L+1 times and silu L times a forward pass, the layout's
    decode attention L times a decode pass, the prefill attention L times
    a prefill in bf16 (an fp32 model's stays on the walk); warm-up passes
    are decode passes the device ran."""
    rms = 2 if ops.get_variant("fused_add_rmsnorm").two_pass else 1
    decode = steps + warmups
    want = {"fused_add_rmsnorm": rms * (2 * cfg.n_layers + 1)
            * (decode + prefills),
            "silu_and_mul": cfg.n_layers * (decode + prefills),
            "paged_flash_decode": 0, "flash_decode": 0,
            "merge_attn_states_lse": 0,
            "prefill_attention": cfg.n_layers * prefills
            if cfg.dtype == "bfloat16" else 0}
    want["paged_flash_decode" if paged else "flash_decode"] = \
        cfg.n_layers * decode
    return want


SERVE_CASES = [("qwen2-0.5b", dict(max_seq=256), [5, 40, 17, 60, 9], 12),
               ("h2o-danube-1.8b", dict(max_seq=192), [5, 40, 60, 100, 70],
                30),
               ("olmoe-1b-7b", dict(max_seq=128), [5, 40, 17, 60, 9], 12)]


@pytest.mark.parametrize("arch,kw,lens,max_new", SERVE_CASES,
                         ids=lambda c: c if isinstance(c, str) else None)
def test_captured_engine_streams_equal_the_cpu(dev, arch, kw, lens,
                                               max_new):
    """fp32, reduced config: the engine that replays its captured step on
    the card gives the CPU engine's streams and step count; every step is
    one replay and one readback. The h2o prompts cross its 64-row window
    and wrap the ring."""
    cfg, params = _smoke(arch)
    card, eng = _serve(params, cfg, dev, lens, max_new, slots=3, **kw)
    cpu, ceng = _serve(params, cfg, "cpu", lens, max_new, slots=3, **kw)
    st = eng.stats()
    assert card == cpu and st["steps"] == ceng.stats()["steps"]
    assert st["decode_captures"] == 1
    assert st["graph_replays"] == st["readbacks"] == st["steps"] > 0
    assert st["capture_s"] > 0 and ceng.stats()["capture_s"] == 0


@pytest.mark.parametrize("arch,kw,lens,max_new", SERVE_CASES,
                         ids=lambda c: c if isinstance(c, str) else None)
def test_launch_counts_are_exact_under_replay(dev, arch, kw, lens, max_new,
                                              monkeypatch):
    from repro_torch.serving import Engine, Request
    monkeypatch.setattr(ops, "_OVERRIDES", {})
    cfg, params = _smoke(arch, "bfloat16")
    eng = Engine(params, cfg, device=dev, slots=3, **kw)
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    for rid, n in enumerate(lens):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                           max_new_tokens=max_new))
    eng.run()
    torch.cuda.synchronize()
    st = eng.stats()
    assert st["graph_replays"] == st["steps"]
    assert ops.launch_counts() == _want_launches(cfg, eng.cm.paged,
                                                 st["steps"], len(lens))


def test_set_variants_after_capture_launches_the_new_genome(dev,
                                                            monkeypatch):
    """The graph holds the genomes installed at capture: the step after a
    ``set_variants`` captures again, and from then on the two-pass rmsnorm
    launches twice a call, as the counters show."""
    from repro_torch.serving import Engine, Request
    monkeypatch.setattr(ops, "_OVERRIDES", {})
    cfg, params = _smoke("qwen2-0.5b")
    eng = Engine(params, cfg, device=dev, slots=2, max_seq=256)
    rng = np.random.default_rng(5)
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 20),
                           max_new_tokens=12))
    for _ in range(3):
        assert eng.step()
    assert eng.stats()["decode_captures"] == 1
    ops.set_variants(fused_add_rmsnorm=fused_add_rmsnorm.BASELINE)
    ops.reset_launch_counts()
    warm0 = eng.stats()["capture_warmups"]
    assert eng.step()
    torch.cuda.synchronize()
    st = eng.stats()
    warm = st["capture_warmups"] - warm0
    assert st["decode_captures"] == 2 and warm > 0
    assert ops.launch_counts() == _want_launches(cfg, True, 1, 0, warm)
    ops.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    assert ops.launch_counts() == _want_launches(
        cfg, True, eng.stats()["steps"] - 4, 0)
    assert all(r.finish_reason == "done" and len(r.out_tokens) == 12
               for r in eng.finished)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oversubscribed_swap_equals_full_subscription_on_the_card(dev,
                                                                  dtype):
    """Swap restores the victim's bytes into the static carry and the
    pool: the streams of an oversubscribed pool (6 pages of 16 for 3
    slots of 64 rows) equal the fully subscribed pool's."""
    from repro_torch.serving import CacheConfig
    cfg, params = _smoke("qwen2-0.5b", dtype)
    lens, kw = [30, 25, 28, 21, 26], dict(slots=3, max_seq=64)
    full, _ = _serve(params, cfg, dev, lens, 20, **kw)
    over, eng = _serve(params, cfg, dev, lens, 20, preemption="swap",
                       cache_manager=CacheConfig(num_pages=6), **kw)
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["swapped_in_pages"] > 0
    assert over == full
    assert st["graph_replays"] == st["readbacks"] == st["steps"]
    # every page left is the prefix tree's, and clearing it empties the pool
    assert eng.cm.pool.pages_in_use == len(eng.cm.pool.tree_pages())
    eng.cm.clear_tree()
    assert eng.cm.pool.pages_in_use == 0


def test_capture_raises_instead_of_running_eagerly(dev, monkeypatch):
    """A step that cannot be captured fails the engine's construction:
    here the split-KV counters, which a capture may not allocate, are
    missing because the warm-up that allocates them is skipped."""
    from repro_torch.serving import Engine
    cfg, params = _smoke("qwen2-0.5b")
    monkeypatch.setattr(flash_decode, "_COUNTERS", {})
    monkeypatch.setattr(Engine, "_warm_up", lambda self: None)
    with pytest.raises(RuntimeError, match="could not be captured.*"
                       "counters must be allocated"):
        Engine(params, cfg, device=dev, slots=3, max_seq=256)


# -- sampling and the prefix cache on the card --------------------------------

def test_the_captured_draw_equals_the_eager_draw(dev):
    """``sample_tokens`` replayed from a CUDA graph, with new logits,
    seeds and stream indices copied into its inputs, gives the eager
    draw's tokens on the same inputs; its noise bits are the CPU's."""
    from repro_torch.serving import sampling
    b, vocab = 8, 151936

    def inputs(seed):
        r = np.random.default_rng(seed)
        logits = torch.tensor(r.standard_normal((b, vocab)) * 3,
                              dtype=torch.float32).to(dev, torch.bfloat16)
        return (logits, torch.tensor(r.integers(0, 2**32, b), device=dev),
                torch.tensor(r.integers(0, 64, b), dtype=torch.int32,
                             device=dev))

    temp = torch.tensor([0.0, 0.8, 1.0, 0.5, 0.8, 2.0, 0.0, 1.3],
                        device=dev)
    topk = torch.tensor([0, 50, 0, 1, 20, 0, 5, 50], dtype=torch.int32,
                        device=dev)
    topp = torch.tensor([1.0, 0.9, 0.95, 1.0, 1.0, 0.5, 0.9, 1.0],
                        device=dev)
    static = [t.clone() for t in inputs(1)]
    args = lambda xs: (xs[0], xs[1], xs[2], temp, topk, topp)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sampling.sample_tokens(*args(static))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sampling.sample_tokens(*args(static))
    for seed in range(2, 6):
        new = inputs(seed)
        for buf, x in zip(static, new):
            buf.copy_(x)
        graph.replay()
        want = sampling.sample_tokens(*args(new))
        torch.cuda.synchronize()
        assert torch.equal(out, want), seed
        greedy = (temp == 0) | (topk == 1)
        assert torch.equal(out[greedy],
                           torch.argmax(new[0], -1).to(torch.int32)[greedy])
    bits = sampling.threefry_bits(static[1], static[2], 1000)
    assert torch.equal(bits.cpu(), sampling.threefry_bits(
        static[1].cpu(), static[2].cpu(), 1000))


def _eager_on_the_card(eng):
    """Make a card engine run its step body eagerly instead of replaying
    a graph (the counterpart a captured step is held against)."""
    import types

    def no_capture():
        eng._graph = types.SimpleNamespace(replay=eng._step_body)
        eng._graph_key = eng._variant_key()
        eng._graph_delta = {}
    eng._capture = no_capture
    no_capture()
    return eng


@pytest.mark.parametrize("paged", [True, False])
def test_a_captured_mixed_batch_equals_the_eager_step(dev, paged):
    """Greedy and sampled requests in one batch: the engine replaying its
    captured steps (the argmax graph, then the draw's) gives the streams
    of the same engine stepping eagerly on the card."""
    from repro_torch.serving import CacheConfig, Engine, Request
    from repro_torch.serving import SamplingParams
    cfg, params = _smoke("qwen2-0.5b")
    lens = [5, 40, 17, 60, 9, 33]
    runs = []
    for eager in (False, True):
        eng = Engine(params, cfg, device=dev, slots=3, max_seq=256,
                     cache_manager=CacheConfig(paged=paged))
        if eager:
            _eager_on_the_card(eng)
        rng = np.random.default_rng(5)
        for rid, n in enumerate(lens):
            sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                seed=rid) if rid % 2 else None
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                               max_new_tokens=12, sampling=sp))
        eng.run()
        runs.append(({r.rid: list(r.out_tokens) for r in eng.finished},
                     eng.stats()))
    (captured, st), (eager, _) = runs
    assert captured == eager
    assert st["decode_captures"] == 2 and st["sampling_step"]
    assert st["graph_replays"] == st["readbacks"] == st["steps"]


def test_copy_on_write_then_replay_leaves_the_shared_page(dev):
    """A prompt that matches a cached one whole maps the first page shared
    and copies the last (copy-on-write); the replays that follow never
    write the shared pages, and the streams equal the run without the
    tree."""
    from repro_torch.serving import CacheConfig, Engine, Request
    cfg, params = _smoke("qwen2-0.5b")
    base = np.random.default_rng(7).integers(0, cfg.vocab, 32)
    streams = []
    for tree in (True, False):
        eng = Engine(params, cfg, device=dev, slots=2, max_seq=64,
                     cache_manager=CacheConfig(page_size=16,
                                               prefix_cache=tree))
        eng.submit(Request(rid=0, prompt=base, max_new_tokens=20))
        assert eng.step()
        if tree:
            shared = sorted(eng.cm.pool.tree_pages())
            assert len(shared) == 2
            before = {n: p[:, shared].clone() for n, p in eng.cache.items()}
        eng.submit(Request(rid=1, prompt=base.copy(), max_new_tokens=20))
        while eng.has_work() and eng.step():
            eng.check_pool()
        eng.run()
        torch.cuda.synchronize()
        st = eng.stats()
        if tree:
            assert st["cow_copies"] == 1 and st["suffix_prefills"] == 1
            for n, p in eng.cache.items():
                assert torch.equal(p[:, shared], before[n]), n
        assert st["graph_replays"] == st["steps"]
        streams.append({r.rid: list(r.out_tokens) for r in eng.finished})
    assert streams[0] == streams[1] and streams[0][0] == streams[0][1]


# -- speculative decoding and crash recovery of the captured step -------------

@pytest.mark.parametrize("drafter", ["ngram", "draft_model"])
def test_spec_replay_equals_the_eager_body(dev, drafter):
    """fp32, reduced qwen2: the captured spec step replayed on the card
    gives the CPU engine's eager spec body's streams and counters, and the
    target-only streams; one capture, one replay and one readback a
    step."""
    from repro_torch.serving import SpecConfig
    cfg, params = _smoke("qwen2-0.5b")
    spec = SpecConfig("ngram", k=4) if drafter == "ngram" else \
        SpecConfig("draft_model", k=3, draft_params=params, draft_cfg=cfg)
    lens, kw = [5, 40, 17, 60, 9], dict(slots=3, max_seq=256)
    card, eng = _serve(params, cfg, dev, lens, 12, spec=spec, **kw)
    cpu, ceng = _serve(params, cfg, "cpu", lens, 12, spec=spec, **kw)
    plain, _ = _serve(params, cfg, dev, lens, 12, **kw)
    st, cst = eng.stats(), ceng.stats()
    assert card == cpu == plain
    for key in ("steps", "draft_tokens", "accepted_tokens", "preemptions"):
        assert st[key] == cst[key], key
    assert st["decode_captures"] == 1 and "spec" in st["capture_by_step"]
    assert st["graph_replays"] == st["readbacks"] == st["steps"] > 0


def test_recovery_on_the_card_keeps_the_graph_buffers(dev):
    """A device fault on the card: the recovery zeroes the pool, carry,
    emit, table and draft cache in place (no new capture, the same
    data_ptr()s), and the streams and counters equal the CPU engine's."""
    from repro_torch.reliability import Fault
    from repro_torch.serving import SpecConfig
    cfg, params = _smoke("qwen2-0.5b")
    spec = SpecConfig("draft_model", k=3, draft_params=params, draft_cfg=cfg)
    kw = dict(slots=2, max_seq=128, spec=spec,
              chaos=[Fault("device_fault", step=4, slot=0)])
    lens = [20, 18, 25, 22]
    from repro_torch.serving import Engine
    probe = Engine(params, cfg, device=dev, **kw)
    tensors = [probe._token, probe._pos, probe._active, probe._emit,
               probe._drafts, probe._table, *probe.cache.values(),
               *probe._drafter.cache.values()]
    ptrs = [t.data_ptr() for t in tensors]
    card, eng = _serve(params, cfg, dev, lens, 10, **kw)
    cpu, ceng = _serve(params, cfg, "cpu", lens, 10, **kw)
    st, cst = eng.stats(), ceng.stats()
    assert card == cpu
    for key in ("steps", "recoveries", "failed", "accepted_tokens"):
        assert st[key] == cst[key], key
    assert st["recoveries"] == 1 and st["decode_captures"] == 1
    assert st["graph_replays"] == st["readbacks"] == st["steps"]
    # a recovery on the engine built first leaves its tensors in place
    rng = np.random.default_rng(5)
    from repro_torch.serving import Request
    for rid, n in enumerate(lens):
        probe.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                             max_new_tokens=10))
    probe.run()
    assert probe.recoveries == 1
    assert [t.data_ptr() for t in tensors] == ptrs
    assert {r.rid: list(r.out_tokens) for r in probe.finished} == card


# -- the mixture of experts ---------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_a_batched_prefill_on_the_card_matches_the_cpu(dev, arch):
    """fp32, reduced config: a prefill of three prompts at once (the
    final position's rows are a slice of the batch, copied contiguous for
    the norm kernel) gives the CPU's logits and cache."""
    from repro_torch.models import registry as models
    cfg, params = _smoke(arch)
    gpu = models.module_for(cfg).cast_params(params, cfg, dev)
    toks = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab,
                                                          (3, 40)))
    lg, kv = models.prefill(gpu, cfg, toks.to(dev), cache_len=64)
    torch.cuda.synchronize()
    want, want_kv = models.prefill(params, cfg, toks, cache_len=64)
    _close(lg, want, torch.float32)
    _close(kv["k"], want_kv["k"], torch.float32)


def test_captured_moe_step_equals_the_eager_card_step(dev):
    """fp32, reduced olmoe on 10 slots, more than its decode capacity of
    8, so that the rows of every slot, idle ones included, compete for
    the experts: the engine replaying its captured step gives the streams
    and steps of the same engine stepping eagerly on the card, and of the
    CPU engine; one capture, one replay and one readback a step, and the
    router stays fp32."""
    cfg, params = _smoke("olmoe-1b-7b")
    lens = [5, 40, 17, 60, 9, 33, 21, 12, 48, 7, 26, 15, 38, 3]
    kw = dict(slots=10, max_seq=128)
    card, eng = _serve(params, cfg, dev, lens, 12, **kw)
    from repro_torch.serving import Engine, Request
    eager = _eager_on_the_card(Engine(params, cfg, device=dev, **kw))
    rng = np.random.default_rng(5)
    for rid, n in enumerate(lens):
        eager.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                             max_new_tokens=12))
    eager.run()
    cpu, ceng = _serve(params, cfg, "cpu", lens, 12, **kw)
    st = eng.stats()
    assert card == {r.rid: list(r.out_tokens) for r in eager.finished} \
        == cpu
    assert st["steps"] == eager.stats()["steps"] == ceng.stats()["steps"]
    assert not st["paged"] and st["decode_captures"] == 1
    assert st["graph_replays"] == st["readbacks"] == st["steps"] > 0
    assert eng.params["layers"][0]["router"].dtype == torch.float32


# -- the dense qk-norm configs' and recurrentgemma's decode shapes ------------

def _replayed_equals(call, want, dtype, tols, refill):
    """``call`` eager, then captured in a CUDA graph and replayed after
    ``refill()`` changes its inputs in place: each against ``want()``."""
    _close(call(), want(), dtype, tols)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for seed in (1, 2):
        refill(seed)
        graph.replay()
        torch.cuda.synchronize()
        _close(out, want(), dtype, tols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq", [32, 56, 64])
def test_paged_decode_at_the_dense_config_shapes(dev, hq, dtype):
    """qwen3-8b (32/8), yi-34b (56/8) and chameleon-34b (64/8) heads of
    128 on 8 slots of 512 rows in 16-row pages: the installed genome
    against its plain version, eager and replayed in a graph with new
    lengths."""
    genome = ops.get_variant("paged_flash_decode")
    q, k, v, table, lens = paged_case(8, hq, 8, 128, 16, 32, dtype, dev,
                                      seed=hq)

    def refill(seed):
        lens.copy_(torch.tensor(np.random.default_rng(seed).integers(
            1, 513, size=8), dtype=torch.int32))
    _replayed_equals(
        lambda: ops.paged_flash_decode_attention(q, k, v, table,
                                                 kv_len=lens),
        lambda: flash_decode.paged_plain(genome, q, k, v, table, lens,
                                         128 ** -0.5),
        dtype, DECODE_TOL, refill)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_recurrentgemma_shape(dev, dtype):
    """recurrentgemma-2b's local attention: 8 slots, 10 query heads on one
    kv head of 256 (two query subgroups), a 2,048-row ring, eager and
    replayed in a graph. In fp32 the ring has one slot (three do not fit
    227 KB) and holds the fp32 tolerance."""
    genome = ops.get_variant("flash_decode")
    plan = flash_decode.launch_plan(genome, batch=8, q_heads=10, kv_heads=1,
                                    head_dim=256, seq=2048, dtype=dtype)
    assert plan["stages"] == (1 if dtype == torch.float32 else 3)
    assert plan["grid"][0] == 2 and plan["smem"] <= \
        flash_decode.SMEM_PER_BLOCK
    q, k, v, lens = flash_case(8, 10, 1, 256, 2048, dtype, dev, seed=9)

    def refill(seed):
        lens.copy_(torch.tensor(np.random.default_rng(seed).integers(
            0, 2049, size=8), dtype=torch.int32))
    _replayed_equals(
        lambda: ops.flash_decode_attention(q, k, v, kv_len=lens),
        lambda: flash_decode.plain(genome, q, k, v, lens, 256 ** -0.5),
        dtype, DECODE_TOL, refill)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_flash_decode_genome_that_does_not_fit_raises(dev, dtype):
    """A 128-row chunk at head_dim 256 needs more shared memory than a
    block has in either dtype (one slot of 32 fp32 rows, or three of
    bf16): it raises before anything launches, and never falls back."""
    genome = dataclasses.replace(flash_decode.OPTIMIZED, chunk=128)
    q, k, v, lens = flash_case(2, 10, 1, 256, 512, dtype, dev)
    n0 = flash_decode.flash_decode_attention.launches
    with pytest.raises(ValueError, match="shared"):
        flash_decode.flash_decode_attention(q, k, v, kv_len=lens,
                                            variant=genome)
    assert flash_decode.flash_decode_attention.launches == n0


def test_captured_hybrid_step_equals_the_eager_card_step(dev):
    """fp32, reduced recurrentgemma (window 32) with non-zero conv
    weights, prompts under and past the window: the engine replaying its
    captured step gives the streams and steps of the same engine stepping
    eagerly on the card and of the CPU engine; one capture, one replay a
    step, and the kernels' launches exact (silu once a layer a pass,
    flash_decode once an attention layer a decode pass, no rmsnorm).
    Then with every other request sampled: the draw's capture at the
    first sampled admission runs its warm-up passes while greedy requests
    are resident, and their streams stay the greedy run's."""
    from repro_torch.serving import Engine, Request, SamplingParams
    cfg, params = _smoke("recurrentgemma-2b")
    gen = torch.Generator().manual_seed(11)
    for block in [b for p in params["periods"] for b in p["rec"]] + \
            params["tail"]:
        block["conv_w"] = 0.5 * torch.randn(block["conv_w"].shape,
                                            generator=gen)
    lens = [5, 40, 17, 60, 9, 33]
    kw = dict(slots=3, max_seq=128)
    ops.reset_launch_counts()
    card, eng = _serve(params, cfg, dev, lens, 12, **kw)
    counts = ops.launch_counts()
    st = eng.stats()
    eager = _eager_on_the_card(Engine(params, cfg, device=dev, **kw))
    rng = np.random.default_rng(5)
    for rid, n in enumerate(lens):
        eager.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                             max_new_tokens=12))
    eager.run()
    cpu, ceng = _serve(params, cfg, "cpu", lens, 12, **kw)
    assert card == {r.rid: list(r.out_tokens) for r in eager.finished} \
        == cpu
    assert st["steps"] == eager.stats()["steps"] == ceng.stats()["steps"]
    assert not st["paged"] and st["decode_captures"] == 1
    assert st["graph_replays"] == st["readbacks"] == st["steps"] > 0
    passes = st["steps"] + st["capture_warmups"]
    assert counts["fused_add_rmsnorm"] == 0
    assert counts["silu_and_mul"] == cfg.n_layers * (passes + len(lens))
    assert counts["flash_decode"] == (cfg.n_layers // 3) * passes
    mixed = Engine(params, cfg, device=dev, **kw)
    rng = np.random.default_rng(5)
    for rid, n in enumerate(lens):
        sp = SamplingParams(temperature=0.8, top_k=20, seed=rid) \
            if rid in (3, 5) else None
        mixed.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n),
                             max_new_tokens=12, sampling=sp))
    mixed.run()
    got = {r.rid: list(r.out_tokens) for r in mixed.finished}
    assert mixed.stats()["decode_captures"] == 2
    assert all(got[rid] == card[rid] for rid in (0, 1, 2, 4))


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions and a train step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 896), (4096, 896)])
def test_rmsnorm_function_gradient_matches_plain_autograd(dev, rows, d,
                                                          dtype):
    """The Function's forward launches the kernel (counted once), its y
    and r' equal the plain version's, and its backward equals autograd
    through the plain version, on the card."""
    x, r, dy, dr = (_randn((rows, d), dtype, dev, s) for s in range(4))
    w = _randn((d,), torch.float32, dev, 5) * 0.1 + 1.0
    leaves = [t.requires_grad_() for t in (x, r, w)]
    n0 = fused_add_rmsnorm.fused_add_rmsnorm.launches
    y, r_new = ops.fused_add_rmsnorm(x, r, w, 1e-6)
    got = torch.autograd.grad((y, r_new), leaves, (dy, dr))
    torch.cuda.synchronize()
    assert fused_add_rmsnorm.fused_add_rmsnorm.launches == n0 + 1
    y_ref, r_ref = ref.fused_add_rmsnorm(x, r, w, 1e-6)
    want = torch.autograd.grad((y_ref, r_ref), leaves, (dy, dr))
    _close(y.detach(), y_ref.detach(), dtype)
    _close(r_new.detach(), r_ref.detach(), dtype)
    for g, w_ in zip(got, want):
        _close(g, w_, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 4864), (4096, 4864)])
def test_silu_function_gradient_matches_plain_autograd(dev, rows, d, dtype):
    x = _randn((rows, 2 * d), dtype, dev, 6, scale=3.0).requires_grad_()
    dout = _randn((rows, d), dtype, dev, 7)
    """The Function's output (the kernel's launch, counted once) equals
    the plain version's, and its backward autograd through it."""
    n0 = silu_and_mul.silu_and_mul.launches
    out = ops.silu_and_mul(x)
    got, = torch.autograd.grad(out, x, dout)
    torch.cuda.synchronize()
    assert silu_and_mul.silu_and_mul.launches == n0 + 1
    out_ref = ref.silu_and_mul(x)
    want, = torch.autograd.grad(out_ref, x, dout)
    _close(out.detach(), out_ref.detach(), dtype)
    _close(got, want, dtype)


def test_a_train_step_on_the_card_matches_the_cpu(dev):
    """Two fp32 steps of the reduced qwen2 (microbatches 2, AdamW at a rate
    of 1e-3 from the first step, the kernels' Functions on the card)
    against the same steps on the CPU: the loss and the norm of each step;
    both moments after the two within 1e-4 of each leaf's largest; each
    parameter's move in the first step within 1e-3 of the rate, leaving
    out (at most 1%) the elements whose gradient the two sides round apart
    by more than 2e-4 of its size, where Adam's first step turns a
    rounding error into up to +-lr (ROADMAP C, reference behaviour 6). The
    first step's gradient is its moment over 1 - b1; a later step's would
    come from a difference of moments, whose own rounding blurs the rule."""
    from repro_torch import configs
    from repro_torch.models import registry as models
    from repro_torch.training import tree
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (TrainConfig, init_state,
                                                 make_train_step)
    lr = 1e-3
    cfg = dataclasses.replace(configs.smoke("qwen2-0.5b"), dtype="float32")
    tcfg = TrainConfig(microbatches=2, cast_params=None,
                       adamw=AdamWConfig(lr=lr, warmup_steps=0))
    batch = models.make_batch(cfg, 4, 64, seed=1)
    p0 = tree.leaves(models.init_master_params(cfg, seed=0, device="cpu"))
    out = {}
    for where in ("cpu", dev):
        params = models.init_master_params(cfg, seed=0, device="cpu")
        params = tree.map_tree(lambda p: p.to(where), params)
        state = init_state(cfg, tcfg, params)
        step = make_train_step(cfg, tcfg)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        n0 = ops.launch_counts()
        metrics, first = [], None
        for _ in range(2):
            params, state, m = step(params, state, b)
            metrics.append(m)
            first = first or [[t.cpu().clone() for t in tree.leaves(x)]
                              for x in (params, state["opt"].m)]
        n1 = ops.launch_counts()
        out[str(where)] = (state, metrics, first,
                           {k: n1[k] - n0[k] for k in n1})
    (s_cpu, m_cpu, (p1_cpu, g_cpu), _), (s_dev, m_dev, (p1_dev, g_dev), n) = \
        out["cpu"], out["cuda"]
    for a, b in zip(m_dev, m_cpu):
        for k in ("loss", "grad_norm"):
            _close(a[k], b[k], torch.float32)
    for what in ("m", "v"):
        for a, b in zip(tree.leaves(getattr(s_dev["opt"], what)),
                        tree.leaves(getattr(s_cpu["opt"], what))):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
    keep = [(a - b).abs() <= 2e-4 * torch.maximum(a.abs(), b.abs())
            for a, b in zip(g_dev, g_cpu)]
    left, total = (sum(int((~k).sum()) for k in keep),
                   sum(k.numel() for k in keep))
    assert left <= 0.01 * total, f"{left} of {total} left out"
    for k, p, a, b in zip(keep, p0, p1_dev, p1_cpu):
        torch.testing.assert_close((a - p)[k], (b - p)[k], rtol=0,
                                   atol=1e-3 * lr)
    # 2 steps x 2 microbatches x (4 L + 1) norms and 2 L silu, L = 2
    assert n["fused_add_rmsnorm"] == 4 * 9 * (
        2 if ops.get_variant("fused_add_rmsnorm").two_pass else 1)
    assert n["silu_and_mul"] == 4 * 4


def test_reference_engine_on_the_card_matches_the_cpu(dev):
    """fp32, reduced qwen2 and olmoe: the host-driven ``ReferenceEngine``
    (eager decode on the contiguous cache, a host argmax per slot) gives
    the same streams on the card as on the CPU, and the captured engine's
    on the card."""
    from repro_torch.serving import ReferenceEngine, Request
    for arch in ("qwen2-0.5b", "olmoe-1b-7b"):
        cfg, params = _smoke(arch)
        lens = [5, 40, 17, 9, 33]
        streams = []
        for d in (dev, "cpu"):
            eng = ReferenceEngine(params, cfg, slots=3, max_seq=128, device=d)
            rng = np.random.default_rng(5)
            for rid, n in enumerate(lens):
                eng.submit(Request(rid=rid, prompt=rng.integers(
                    0, cfg.vocab, n), max_new_tokens=12))
            streams.append({r.rid: list(r.out_tokens) for r in eng.run()})
        card, _ = _serve(params, cfg, dev, lens, 12, slots=3, max_seq=128)
        assert streams[0] == streams[1] == card
        assert len(card) == len(lens)


def test_mesh_engine_at_world_one_matches_the_single_rank_engine(dev):
    """fp32, reduced qwen3-8b: the tensor-parallel engine over a (1, 1)
    mesh of one NCCL rank (heads, MLP and vocab "sharded" over one rank,
    so every hook runs its all-gather) captures its step with the
    collectives inside and gives the single-rank engine's streams, steps
    and launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (free_port, init_world,
                                         make_local_mesh)
    from repro_torch.sharding import tp
    cfg, params = _smoke("qwen3-8b")
    lens = [5, 40, 17, 60, 9, 33]
    kw = dict(slots=4, max_seq=128)
    ops.reset_launch_counts()
    single, seng = _serve(params, cfg, dev, lens, 12, **kw)
    want = ops.launch_counts()
    init_world(dev, rank=0, world_size=1, port=free_port())
    gathers = []
    real = dist.all_gather_into_tensor

    def counted(*a, **k):
        gathers.append(torch.cuda.is_current_stream_capturing())
        return real(*a, **k)
    try:
        dist.all_gather_into_tensor = counted
        mesh = make_local_mesh(1, dev)
        ops.reset_launch_counts()
        sharded, eng = _serve(params, cfg, dev, lens, 12, mesh=mesh, **kw)
        got = ops.launch_counts()
    finally:
        dist.all_gather_into_tensor = real
        dist.destroy_process_group()
    st = eng.stats()
    assert st["mesh"] == {"data": 1, "model": 1, "heads_tp": True,
                          "mlp_tp": True, "vocab_tp": True,
                          "batch_dp": False}
    assert sharded == single
    assert got == want
    assert st["steps"] == seng.stats()["steps"] == st["graph_replays"]
    assert st["decode_captures"] == 1
    # the capture recorded one decode pass's gathers: heads and MLP a
    # layer, the vocab once
    assert sum(gathers) == 2 * cfg.n_layers + 1
    assert tp.current() is None


# --------------------------------------------------------------------------
# the prefill attention (csrc/prefill_attention.cu)
# --------------------------------------------------------------------------

# (batch, seq, q heads, kv heads, head_dim, window): yi-34b, h2o-danube-1.8b
# (below, at, one past and far past its window), qwen2-0.5b,
# recurrentgemma-2b's local attention; one row, one below and one above a
# 64-row tile, a batch of two prompts, the reduced configs' width, a
# group of one (seamless-m4t-large-v2's 16/16 heads of 64) under a window
PREFILL_SHAPES = [
    (1, 512, 56, 8, 128, None), (1, 2048, 56, 8, 128, None),
    (1, 1024, 32, 8, 80, 4096), (1, 4096, 32, 8, 80, 4096),
    (1, 4097, 32, 8, 80, 4096), (1, 7168, 32, 8, 80, 4096),
    (1, 1024, 14, 2, 64, None), (1, 3000, 10, 1, 256, 2048),
    (1, 1, 14, 2, 64, None), (1, 63, 56, 8, 128, None),
    (1, 65, 32, 8, 80, 4096), (2, 300, 14, 2, 64, None),
    (1, 200, 4, 2, 32, 64), (1, 333, 16, 16, 64, 100)]


@pytest.mark.parametrize("shape", PREFILL_SHAPES, ids=str)
def test_prefill_attention_matches_the_walk(dev, shape):
    """bf16: the kernel against the fp32 walk on the same inputs (p is
    rounded to bf16 for p.V, as in the decode kernels); each call is one
    launch."""
    b, s, hq, hkv, dh, window = shape
    q = _randn((b, s, hq, dh), torch.bfloat16, dev, 0)
    k = _randn((b, s, hkv, dh), torch.bfloat16, dev, 1)
    v = _randn((b, s, hkv, dh), torch.bfloat16, dev, 2)
    n0 = prefill_attention.prefill_attention.launches
    out = ops.prefill_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert prefill_attention.prefill_attention.launches == n0 + 1
    assert out.shape == q.shape and out.is_contiguous()
    want, _ = prefill_attention.walk(q, k, v, True, window)
    _close(out, want, torch.bfloat16, DECODE_TOL)


def test_prefill_attention_reads_strided_inputs(dev):
    """q, k and v as views of one fused [S, (Hq + 2 Hkv) * dh] projection
    (row strides past the head dim) give the contiguous copies' result."""
    s, hq, hkv, dh = 300, 32, 8, 80
    fused = _randn((1, s, (hq + 2 * hkv) * dh), torch.bfloat16, dev, 4)
    q, k, v = fused.split((hq * dh, hkv * dh, hkv * dh), -1)
    q, k, v = (t.unflatten(-1, (-1, dh)) for t in (q, k, v))
    assert not q.is_contiguous()
    got = ops.prefill_attention(q, k, v, window=128)
    want = ops.prefill_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=128)
    assert torch.equal(got, want)


def test_prefill_attention_on_the_card_launches_or_raises(dev):
    q = _randn((1, 64, 4, 32), torch.float32, dev, 0)
    with pytest.raises(ValueError):
        ops.prefill_attention(q, q[:, :, :2], q[:, :, :2])
    q = _randn((1, 64, 4, 48), torch.bfloat16, dev, 0)
    with pytest.raises(ValueError):
        ops.prefill_attention(q, q[:, :, :2].contiguous(),
                              q[:, :, :2].contiguous())


@pytest.mark.parametrize("causal,grad", [(False, False), (True, True)])
def test_non_causal_and_grad_calls_launch_no_prefill_attention(dev, causal,
                                                               grad):
    from repro_torch.models import layers
    q, k, v = (_randn(shape, torch.bfloat16, dev, i).requires_grad_(grad)
               for i, shape in enumerate(((1, 100, 4, 32), (1, 100, 2, 32),
                                          (1, 100, 2, 32))))
    n0 = prefill_attention.prefill_attention.launches
    out = layers.flash_attention(q, k, v, causal=causal)
    if grad:
        out.float().sum().backward()
    torch.cuda.synchronize()
    assert prefill_attention.prefill_attention.launches == n0


def test_no_bf16_prefill_reaches_the_walk_on_the_card(dev, monkeypatch):
    """bf16, reduced h2o-danube-1.8b (prompts across its window): with the
    walk made to raise, every prefill still runs, through the kernel, L
    launches a prefill."""
    from repro_torch.models import layers

    def refuse(*a, **k):
        raise AssertionError("a bf16 prefill reached the fp32 walk")

    cfg, params = _smoke("h2o-danube-1.8b", "bfloat16")
    monkeypatch.setattr(layers, "walk", refuse)
    lens = [5, 40, 60, 100, 70]
    n0 = prefill_attention.prefill_attention.launches
    streams, eng = _serve(params, cfg, dev, lens, 8, slots=3, max_seq=192)
    assert len(streams) == len(lens)
    assert prefill_attention.prefill_attention.launches - n0 == \
        cfg.n_layers * eng.stats()["prefills"] == cfg.n_layers * len(lens)
