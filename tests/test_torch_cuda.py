"""Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (it builds the kernel
library at first use) and skips without one. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 rtol 1e-5 / atol 1e-4 and bf16 3e-2 / 3e-2, the JAX
package's kernel tolerances. The kernels sum in another order than the
plain versions and use CUDA's expf/rsqrtf, so fp32 agrees to rounding.
Each genome's kernel is held against the same genome's plain version; a
-inf score must match exactly.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode, fused_add_rmsnorm, ops, ref
from repro_torch.kernels import merge_attn_states, registry, silu_and_mul

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               **TOL[dtype])


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


def paged_case(b, hq, hkv, dh, page, n_pt, dtype, dev, seed=0):
    """Pools, a shuffled page table whose tail past kv_len points at trap
    page 0, and ragged lengths including 1 and an exact page multiple."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_pt + 1
    lens = rng.integers(1, n_pt * page + 1, size=b)
    lens[0] = 1
    if b > 1:
        lens[1] = 2 * page
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
    _close(out, want, dtype)


def test_paged_decode_never_reads_past_kv_len(dev):
    """Rows past kv_len are never read: NaN in every trap-page row and in
    the unused tail of each request's last page leaves the output
    finite."""
    q, k, v, table, lens = paged_case(8, 14, 2, 64, 16, 20, torch.bfloat16,
                                      dev)
    k[0] = float("nan")
    v[0] = float("nan")
    for i in range(8):
        n = int(lens[i])
        last = int(table[i, (n - 1) // 16])
        k[last, (n - 1) % 16 + 1:] = float("nan")
        v[last, (n - 1) % 16 + 1:] = float("nan")
    out = ops.paged_flash_decode_attention(q, k, v, table, kv_len=lens)
    assert torch.isfinite(out.float()).all()



def _bool_genomes(base, *flags):
    """``base`` with every combination of the bool ``flags``."""
    return [dataclasses.replace(base, name="-".join(
                f"{f}={int(v)}" for f, v in zip(flags, vals)),
                **dict(zip(flags, vals)))
            for vals in itertools.product((False, True), repeat=len(flags))]


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
