"""Kernel contracts of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go to the JAX oracle in
``repro.kernels.ref`` and to its port in ``repro_torch.kernels.ref``; the
ported kernels' wrappers (which take their genome's plain version for CPU
tensors) are also held against the JAX Pallas kernels run in interpret
mode, genome by genome. Tolerances are the JAX package's
(``core/agents.py``): fp32 rtol 1e-5 / atol 1e-4, bf16 3e-2 / 3e-2; a
``-inf`` score must match exactly.

Also here: the guards that keep the port apart from JAX and off the CPU
unless asked (no ``jax`` / ``repro`` import under ``src/repro_torch`` or
in ``chip_smoke.py``; CPU tensors never touch the CUDA library; entry
points raise without a GPU; ``chip_smoke.py`` fails without one).
"""

import ast
import ctypes
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import fused_add_rmsnorm as jrms  # noqa: E402
from repro.kernels import merge_attn_states as jmerge  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import silu_and_mul as jsilu  # noqa: E402
from repro_torch.kernels import _build, ops, ref, registry  # noqa: E402
from repro_torch.kernels import flash_decode, fused_add_rmsnorm  # noqa: E402
from repro_torch.kernels import merge_attn_states, silu_and_mul  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype`` (both
    round the fp32 values to nearest even)."""
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    x = x.astype(np.float32)
    return (jnp.asarray(x, dtype=JNP[dtype]),
            torch.from_numpy(x.copy()).to(TORCH[dtype]))


def jit(fn, **static):
    """The JAX function under ``jax.jit`` (one compile instead of one per
    op; the arithmetic is the same)."""
    return jax.jit(functools.partial(fn, **static))


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


def paged_case(b, hq, hkv, dh, page, n_pt, seed=0):
    """numpy q, pools, page table (tail past kv_len at trap page 0, pages
    shuffled) and ragged kv_len with 1 and an exact page multiple."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_pt + 1
    lens = rng.integers(1, n_pt * page + 1, size=b).astype(np.int32)
    lens[0] = 1
    lens[-1] = 2 * page
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_pt), np.int32)
    for i in range(b):
        used = -(-int(lens[i]) // page)
        table[i, :used] = perm[i * n_pt:i * n_pt + used]
    q = rng.standard_normal((b, hq, dh))
    k = rng.standard_normal((n_pages, page, hkv, dh))
    v = rng.standard_normal((n_pages, page, hkv, dh))
    return q, k, v, table, lens


# --------------------------------------------------------------------------
# the six oracles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [17, 33])
def test_oracle_fused_add_rmsnorm(rows, dtype):
    rng = np.random.default_rng(rows)
    x, r = rng.standard_normal((2, rows, 64))
    w = 1.0 + 0.1 * rng.standard_normal(64)
    (xj, xt), (rj, rt) = both(x, dtype), both(r, dtype)
    wj, wt = both(w, "float32")
    yj, nj = jit(jref.fused_add_rmsnorm)(xj, rj, wj)
    yt, nt = ref.fused_add_rmsnorm(xt, rt, wt, 1e-6)
    assert yt.dtype == TORCH[dtype] and nt.dtype == TORCH[dtype]
    close(yj, yt, dtype)
    close(nj, nt, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [17, 33])
def test_oracle_silu_and_mul(rows, dtype):
    x = np.random.default_rng(rows).standard_normal((rows, 2 * 96)) * 3
    xj, xt = both(x, dtype)
    out = ref.silu_and_mul(xt)
    assert out.shape == (rows, 96) and out.dtype == TORCH[dtype]
    close(jit(jref.silu_and_mul)(xj), out, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_oracle_merge_attn_states_lse(dtype):
    rng = np.random.default_rng(3)
    va, vb = rng.standard_normal((2, 17, 4, 32))
    sa, sb = rng.standard_normal((2, 17, 4)) * 4
    sa[0, :2] = -np.inf                 # one side empty
    sb[1, 0] = -np.inf
    sa[2, 3] = sb[2, 3] = -np.inf       # both empty: V = 0, S = -inf
    (vaj, vat), (vbj, vbt) = both(va, dtype), both(vb, dtype)
    (saj, sat), (sbj, sbt) = both(sa, "float32"), both(sb, "float32")
    vj, sj = jit(jref.merge_attn_states_lse)(vaj, saj, vbj, sbj)
    vt, st = ref.merge_attn_states_lse(vat, sat, vbt, sbt)
    close(vj, vt, dtype)
    np.testing.assert_array_equal(np.isneginf(np.asarray(sj)),
                                  torch.isneginf(st).numpy())
    fin = np.isfinite(np.asarray(sj))
    np.testing.assert_allclose(np.asarray(sj)[fin], st.numpy()[fin],
                               **TOL["float32"])
    assert (vt[2, 3] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (14, 2)])
def test_oracle_flash_decode_and_lse(hq, hkv, dtype):
    rng = np.random.default_rng(hq)
    b, s, dh = 3, 40, 32
    q = rng.standard_normal((b, hq, dh))
    k, v = rng.standard_normal((2, b, s, hkv, dh))
    lens = np.array([1, 17, 40], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), \
        both(v, dtype)
    lj, lt = both(lens, dtype)
    close(jit(jref.flash_decode_attention)(qj, kj, vj, kv_len=lj),
          ref.flash_decode_attention(qt, kt, vt, kv_len=lt), dtype)
    close(jit(jref.flash_decode_lse)(qj, kj, kv_len=lj),
          ref.flash_decode_lse(qt, kt, kv_len=lt), "float32")
    close(jit(jref.flash_decode_attention)(qj, kj, vj),
          ref.flash_decode_attention(qt, kt, vt), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (14, 2)])
def test_oracle_paged_flash_decode(hq, hkv, dtype):
    q, k, v, table, lens = paged_case(3, hq, hkv, 32, 8, 4)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), \
        both(v, dtype)
    (tj, tt), (lj, lt) = both(table, dtype), both(lens, dtype)
    close(jit(jref.paged_flash_decode_attention)(qj, kj, vj, tj,
                                                  kv_len=lj),
          ref.paged_flash_decode_attention(qt, kt, vt, tt, kv_len=lt), dtype)


# --------------------------------------------------------------------------
# the ported kernels' wrappers against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [17, 33])
def test_fused_add_rmsnorm_matches_pallas(rows, dtype):
    rng = np.random.default_rng(rows + 1)
    x, r = rng.standard_normal((2, rows, 128))
    w = 1.0 + 0.1 * rng.standard_normal(128)
    (xj, xt), (rj, rt), (wj, wt) = both(x, dtype), both(r, dtype), \
        both(w, "float32")
    yj, nj = jit(jops.fused_add_rmsnorm, impl="pallas")(xj, rj, wj)
    yt, nt = ops.fused_add_rmsnorm(xt, rt, wt, 1e-6)
    close(yj, yt, dtype)
    close(nj, nt, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [17, 33])
def test_silu_and_mul_matches_pallas(rows, dtype):
    x = np.random.default_rng(rows + 2).standard_normal((rows, 2 * 256)) * 3
    xj, xt = both(x, dtype)
    close(jit(jops.silu_and_mul, impl="pallas")(xj), ops.silu_and_mul(xt),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (14, 2)])
def test_paged_decode_matches_pallas(hq, hkv, dtype):
    """Group sizes 1, 2 and 7; kv_len 1 and an exact page multiple; the
    table's tail past kv_len points at trap page 0."""
    q, k, v, table, lens = paged_case(2, hq, hkv, 32, 8, 3, seed=hq)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), \
        both(v, dtype)
    (tj, tt), (lj, lt) = both(table, dtype), both(lens, dtype)
    close(jit(jops.paged_flash_decode_attention, impl="pallas")(
              qj, kj, vj, tj, kv_len=lj),
          ops.paged_flash_decode_attention(qt, kt, vt, tt, kv_len=lt), dtype)


# --------------------------------------------------------------------------
# genome by genome: the plain per-genome versions against the Pallas
# kernels of the same genome (interpret mode)
# --------------------------------------------------------------------------

def jax_genome(module, variant):
    """The JAX package's genome with the same field values (the port's
    launch knobs that JAX has no field for, such as rmsnorm's
    ``row_threads``, set only the launch)."""
    cls = getattr(module, type(variant).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(variant).items()
                  if k in names})


MERGE_GENOMES = {
    "baseline": merge_attn_states.BASELINE,
    "optimized": merge_attn_states.OPTIMIZED,
    "optimized_unfused_s": dataclasses.replace(merge_attn_states.OPTIMIZED,
                                               fuse_s_out=False),
}


def merge_case(s, h, d, seed):
    """v normal, scores normal x 8 with 10% of s_b at -inf, plus rows with
    one side empty and rows with both sides empty."""
    rng = np.random.default_rng(seed)
    va, vb = rng.standard_normal((2, s, h, d))
    sa, sb = rng.standard_normal((2, s, h)) * 8
    sb[rng.random((s, h)) < 0.1] = -np.inf
    sa[0, :2] = -np.inf                     # one side empty
    sa[1, 0] = sb[1, 0] = -np.inf           # both empty: V = 0, S = -inf
    sa[2, h - 1] = sb[2, h - 1] = -np.inf
    return va, sa, vb, sb


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(48, 7, 64), (17, 3, 128)])
@pytest.mark.parametrize("genome", sorted(MERGE_GENOMES))
def test_merge_genome_matches_pallas(genome, shape, dtype):
    variant = MERGE_GENOMES[genome]
    va, sa, vb, sb = merge_case(*shape, seed=shape[0])
    (vaj, vat), (vbj, vbt) = both(va, dtype), both(vb, dtype)
    (saj, sat), (sbj, sbt) = both(sa, "float32"), both(sb, "float32")
    vj, sj = jit(jmerge.merge_attn_states_lse,
                 variant=jax_genome(jmerge, variant),
                 interpret=True)(vaj, saj, vbj, sbj)
    vt, st = merge_attn_states.merge_attn_states_lse(vat, sat, vbt, sbt,
                                                     variant)
    assert vt.dtype == TORCH[dtype] and st.dtype == torch.float32
    assert vt.shape == va.shape and st.shape == sa.shape
    close(vj, vt, dtype)
    sj = np.asarray(sj)
    np.testing.assert_array_equal(np.isneginf(sj), torch.isneginf(st).numpy())
    assert np.isneginf(st[1, 0]) and (vt[1, 0] == 0).all()
    fin = np.isfinite(sj)
    np.testing.assert_allclose(sj[fin], st.numpy()[fin], **TOL["float32"])
    assert torch.isfinite(vt.float()).all()


RMS_GENOMES = {
    "baseline": (fused_add_rmsnorm.BASELINE, DTYPES),
    "optimized": (fused_add_rmsnorm.OPTIMIZED, DTYPES),
    "two_pass_rsqrt": (fused_add_rmsnorm.RmsNormVariant(
        name="two_pass_rsqrt", two_pass=True, use_rsqrt=True),
        ["bfloat16"]),
}
SILU_GENOMES = {
    "baseline": (silu_and_mul.BASELINE, DTYPES),
    "optimized": (silu_and_mul.OPTIMIZED, DTYPES),
    "bf16_fast_math": (silu_and_mul.SiluMulVariant(
        name="bf16_fast_math", compute_fp32=False, use_reciprocal=True,
        fast_exp=True, fused_split=True), ["bfloat16"]),
}


@pytest.mark.parametrize("genome,dtype", [
    (g, dt) for g, (_, dts) in sorted(RMS_GENOMES.items()) for dt in dts])
def test_fused_add_rmsnorm_genome_matches_pallas(genome, dtype):
    variant = RMS_GENOMES[genome][0]
    rng = np.random.default_rng(7)
    x, r = rng.standard_normal((2, 33, 256))
    w = 1.0 + 0.1 * rng.standard_normal(256)
    (xj, xt), (rj, rt), (wj, wt) = both(x, dtype), both(r, dtype), \
        both(w, "float32")
    yj, nj = jit(jrms.fused_add_rmsnorm, eps=1e-6,
                 variant=jax_genome(jrms, variant),
                 interpret=True)(xj, rj, wj)
    yt, nt = fused_add_rmsnorm.fused_add_rmsnorm(xt, rt, wt, 1e-6, variant)
    close(yj, yt, dtype)
    close(nj, nt, dtype)


@pytest.mark.parametrize("genome,dtype", [
    (g, dt) for g, (_, dts) in sorted(SILU_GENOMES.items()) for dt in dts])
def test_silu_and_mul_genome_matches_pallas(genome, dtype):
    variant = SILU_GENOMES[genome][0]
    x = np.random.default_rng(8).standard_normal((17, 2 * 384)) * 3
    xj, xt = both(x, dtype)
    close(jit(jsilu.silu_and_mul, variant=jax_genome(jsilu, variant),
              interpret=True)(xj),
          silu_and_mul.silu_and_mul(xt, variant), dtype)


def _launch_values(space_name):
    """(knob, value) for each legal value of each launch (pow2) knob."""
    space = registry.get_space(space_name)
    return [(k.name, 1 << b) for k in space.knobs if k.kind == "pow2"
            for b in range(k.lo.bit_length() - 1, k.hi.bit_length())]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_launch_knob_genome_matches_pallas(dtype):
    """The shipped genome at each value of each launch knob against the
    Pallas kernel (interpret mode) of the JAX genome with the same flags.
    A launch knob sets no arithmetic, so on the CPU every value gives the
    shipped genome's output; each launch runs on the card
    (test_torch_cuda.py: test_every_rmsnorm_genome_matches_plain)."""
    rng = np.random.default_rng(11)
    x, r = rng.standard_normal((2, 33, 256))
    w = 1.0 + 0.1 * rng.standard_normal(256)
    (xj, xt), (rj, rt), (wj, wt) = both(x, dtype), both(r, dtype), \
        both(w, "float32")
    yj, nj = jit(jrms.fused_add_rmsnorm, eps=1e-6,
                 variant=jax_genome(jrms, fused_add_rmsnorm.OPTIMIZED),
                 interpret=True)(xj, rj, wj)
    for knob, value in _launch_values("fused_add_rmsnorm"):
        variant = dataclasses.replace(fused_add_rmsnorm.OPTIMIZED,
                                      **{knob: value})
        yt, nt = fused_add_rmsnorm.fused_add_rmsnorm(xt, rt, wt, 1e-6,
                                                     variant)
        close(yj, yt, dtype)
        close(nj, nt, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_launch_knob_genome_matches_pallas(dtype):
    """The shipped genome at each value of each launch knob against the
    Pallas kernel (interpret mode) of the JAX genome with the same flags;
    each launch runs on the card (test_every_silu_genome_matches_plain)."""
    x = np.random.default_rng(12).standard_normal((17, 2 * 384)) * 3
    xj, xt = both(x, dtype)
    want = jit(jsilu.silu_and_mul,
               variant=jax_genome(jsilu, silu_and_mul.OPTIMIZED),
               interpret=True)(xj)
    for knob, value in _launch_values("silu_and_mul"):
        variant = dataclasses.replace(silu_and_mul.OPTIMIZED,
                                      **{knob: value})
        close(want, silu_and_mul.silu_and_mul(xt, variant), dtype)


@pytest.mark.parametrize("genome", ["optimized", "baseline"])
def test_rmsnorm_bf16_weight_equals_its_fp32_widening(genome):
    """A bf16 weight widens exactly: (y, r') are those of the fp32 weight
    with the same values, bit for bit (the kernel reads the weight in its
    own dtype, the wrapper casts nothing)."""
    variant = RMS_GENOMES[genome][0]
    rng = np.random.default_rng(13)
    x, r = (torch.tensor(a, dtype=torch.bfloat16)
            for a in rng.standard_normal((2, 9, 320)))
    w = torch.tensor(1.0 + 0.1 * rng.standard_normal(320),
                     dtype=torch.bfloat16)
    got = fused_add_rmsnorm.fused_add_rmsnorm(x, r, w, 1e-6, variant)
    want = fused_add_rmsnorm.fused_add_rmsnorm(x, r, w.float(), 1e-6,
                                               variant)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


FLASH_GENOMES = {
    "baseline": flash_decode.BASELINE,
    "optimized": flash_decode.OPTIMIZED,
    "chunk32_divide": flash_decode.FlashDecodeVariant(
        name="chunk32_divide", chunk=32, use_reciprocal=False,
        mask_oob=True),
}


def flash_case(b, hq, hkv, dh, s, seed):
    """numpy q, k, v and kv_len from 1 to s (1 first, s last)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, dh))
    k, v = rng.standard_normal((2, b, s, hkv, dh))
    lens = np.linspace(1, s, b).astype(np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 2, 80, 200), (3, 7, 1, 64, 150)],
                         ids=["d80_group4", "d64_group7"])
@pytest.mark.parametrize("genome", sorted(FLASH_GENOMES))
def test_flash_decode_genome_matches_pallas(genome, shape, dtype):
    """Group 4 at head_dim 80 (h2o-danube-1.8b) and group 7 at 64
    (qwen2-0.5b); kv_len 1 and s; s not a multiple of the chunk."""
    variant = FLASH_GENOMES[genome]
    q, k, v, lens = flash_case(*shape, seed=shape[-1])
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), \
        both(v, dtype)
    lj, lt = both(lens, dtype)
    want = jit(jfd.flash_decode_attention, variant=jax_genome(jfd, variant),
               interpret=True)(qj, kj, vj, kv_len=lj)
    got = flash_decode.flash_decode_attention(qt, kt, vt, kv_len=lt,
                                              variant=variant)
    assert got.dtype == TORCH[dtype] and got.shape == q.shape
    close(want, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_return_lse_matches_pallas(dtype):
    q, k, v, lens = flash_case(2, 8, 2, 80, 100, seed=5)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), \
        both(v, dtype)
    lj, lt = both(lens, dtype)
    oj, sj = jit(jfd.flash_decode_attention, interpret=True,
                 return_lse=True)(qj, kj, vj, kv_len=lj)
    ot, st = ops.flash_decode_attention(qt, kt, vt, kv_len=lt,
                                        return_lse=True)
    close(oj, ot, dtype)
    assert st.dtype == torch.float32 and st.shape == (2, 8)
    close(sj, st, "float32")


def test_flash_decode_plain_follows_the_pallas_grid_at_the_edges():
    """kv_len 0 and past s: the baseline's masked chunks still count
    (V of the zero padding included), ``mask_oob`` visits none, and a
    length past s reads s rows."""
    q, k, v, _ = flash_case(2, 4, 2, 16, 40, seed=6)
    lens = np.array([0, 40], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = both(q, "float32"), both(k, "float32"), \
        both(v, "float32")
    lj, lt = both(lens, "float32")
    for variant in (flash_decode.BASELINE, FLASH_GENOMES["chunk32_divide"]):
        want = jit(jfd.flash_decode_attention,
                   variant=jax_genome(jfd, variant),
                   interpret=True)(qj, kj, vj, kv_len=lj)
        close(want, flash_decode.flash_decode_attention(
            qt, kt, vt, kv_len=lt, variant=variant), "float32")
    zero = flash_decode.flash_decode_attention(
        qt, kt, vt, kv_len=lt, variant=flash_decode.OPTIMIZED)
    assert (zero[0] == 0).all()
    past = flash_decode.flash_decode_attention(
        qt, kt, vt, kv_len=torch.tensor([41, 99], dtype=torch.int32),
        variant=flash_decode.OPTIMIZED)
    torch.testing.assert_close(past[1], zero[1])


def _split_ranges(n_chunks: int, splits: int):
    """The kernel's ranges: ``splits`` ranges of ceil(n / splits) chunks,
    the last one short (uneven) where it does not divide."""
    per = -(-n_chunks // splits)
    return [(lo, min(n_chunks, lo + per)) for lo in range(0, n_chunks, per)]


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("genome", ["baseline", "optimized"])
def test_flash_decode_split_merge_matches_unsplit_and_pallas(genome, splits):
    """The split-KV kernels' math without the card: ``plain_state`` over
    ranges of whole chunks, merged with Kernel 1's (m, l) weights, equals
    the unsplit plain version and the Pallas kernel (interpret mode) at
    fp32 1e-5 / 1e-4. s = 200 in chunks of 64 (a ragged last chunk, so an
    uneven last range); kv_len 0 (the baseline's mean of V over the padded
    rows), 1, each range edge +- 1 and s."""
    variant = FLASH_GENOMES[genome]
    s, chunk = 200, variant.chunk
    ranges = _split_ranges(-(-s // chunk), splits)
    lens = {0, 1, s}
    for lo, _ in ranges[1:]:
        lens.update((lo * chunk - 1, lo * chunk, lo * chunk + 1))
    lens = np.array(sorted(lens), np.int32)
    rng = np.random.default_rng(splits)
    q = rng.standard_normal((len(lens), 8, 80))
    k, v = rng.standard_normal((2, len(lens), s, 2, 80))
    (qj, qt), (kj, kt), (vj, vt) = both(q, "float32"), \
        both(k, "float32"), both(v, "float32")
    lj, lt = both(lens, "float32")
    scale = 80 ** -0.5
    states = [flash_decode.plain_state(variant, qt, kt, vt, lt, scale,
                                       chunks=r) for r in ranges]
    acc, _, l = flash_decode.merge_states(states)
    got = flash_decode.finish(variant.use_reciprocal, acc, l, qt.dtype)
    whole = flash_decode.plain(variant, qt, kt, vt, lt, scale)
    torch.testing.assert_close(got, whole, **TOL["float32"])
    want = jit(jfd.flash_decode_attention, variant=jax_genome(jfd, variant),
               interpret=True)(qj, kj, vj, kv_len=lj)
    close(want, got, "float32")
    if variant.mask_oob:
        assert (got[0] == 0).all()
    else:                       # kv_len 0: the mean of V over 256 rows
        mean = vt[0].sum(dim=0) / (-(-s // chunk) * chunk)
        torch.testing.assert_close(got[0], mean.repeat_interleave(4, 0),
                                   **TOL["float32"])


PAGED_GENOMES = {"baseline": flash_decode.PAGED_BASELINE,
                 "optimized": flash_decode.PAGED_OPTIMIZED}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("genome", sorted(PAGED_GENOMES))
def test_paged_genome_matches_pallas(genome, dtype):
    """``paged_plain`` of each JAX genome against the Pallas paged kernel
    of the same genome (interpret mode): group 4, the table's tail on trap
    page 0, kv_len 0 (the baseline's mean of V over the table's rows, the
    trap page's included), 1, an exact page multiple and the table."""
    variant = PAGED_GENOMES[genome]
    q, k, v, table, lens = paged_case(4, 8, 2, 32, 8, 3, seed=11)
    lens[:] = (0, 1, 16, 24)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), \
        both(v, dtype)
    (tj, tt), (lj, lt) = both(table, dtype), both(lens, dtype)
    want = jit(jfd.paged_flash_decode_attention,
               variant=jax_genome(jfd, variant),
               interpret=True)(qj, kj, vj, tj, kv_len=lj)
    got = flash_decode.paged_flash_decode_attention(qt, kt, vt, tt,
                                                    kv_len=lt,
                                                    variant=variant)
    assert got.dtype == TORCH[dtype] and got.shape == q.shape
    close(want, got, dtype)
    if variant.mask_oob:
        assert (got[0] == 0).all()
    else:
        assert (got[0] != 0).any()


def test_plain_genomes_keep_their_arithmetic_order():
    """The plain versions differ where the genome says the arithmetic
    does: the two-pass form normalises the rounded r', bf16 compute
    rounds every operation."""
    rng = np.random.default_rng(9)
    x, r = (torch.tensor(a, dtype=torch.bfloat16)
            for a in rng.standard_normal((2, 4, 64)))
    w = torch.ones(64)
    one = fused_add_rmsnorm.plain(fused_add_rmsnorm.OPTIMIZED, x, r, w)[0]
    two = fused_add_rmsnorm.plain(
        dataclasses.replace(fused_add_rmsnorm.OPTIMIZED, two_pass=True),
        x, r, w)[0]
    assert not torch.equal(one, two)
    torch.testing.assert_close(one.float(), two.float(), rtol=3e-2,
                               atol=3e-2)
    xs = torch.tensor(rng.standard_normal((4, 128)) * 3,
                      dtype=torch.bfloat16)
    f32 = silu_and_mul.plain(silu_and_mul.OPTIMIZED, xs)
    b16 = silu_and_mul.plain(dataclasses.replace(
        silu_and_mul.OPTIMIZED, compute_fp32=False), xs)
    assert not torch.equal(f32, b16)


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------

def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(REPO)} imports {mod}"


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def test_library_signatures_match_the_c_interface():
    """``_build.SIGNATURES`` gives ctypes each ``extern "C"`` launcher of
    ``csrc/`` with its parameters' types in order: a launcher that gains a
    parameter (the decode ones take the wrapper's shared-memory figure)
    and a table that does not would pass the wrong values."""
    import re
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (repro_\w+)\(([^)]*)\)', src.read_text()):
            types = [" ".join(p.split()[:-1]) for p in params.split(",")]
            found[name] = [_C_TYPES[t] for t in types]
    assert set(found) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert list(argtypes) == found[name], name


def test_cpu_tensors_never_touch_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    before = ops.launch_counts()
    x = torch.randn(5, 64)
    ops.fused_add_rmsnorm(x, torch.randn(5, 64), torch.ones(64))
    ops.silu_and_mul(x)
    q, k, v, table, lens = paged_case(2, 4, 2, 16, 4, 3)
    t = [torch.tensor(a, dtype=torch.float32) for a in (q, k, v)]
    ops.paged_flash_decode_attention(*t, torch.from_numpy(table),
                                     kv_len=torch.from_numpy(lens))
    v, s = torch.randn(3, 2, 64), torch.randn(3, 2)
    ops.merge_attn_states_lse(v, s, v, s)
    q, k, v, lens = flash_case(2, 8, 2, 80, 30, seed=0)
    t = [torch.tensor(a, dtype=torch.float32) for a in (q, k, v)]
    ops.flash_decode_attention(*t, kv_len=torch.from_numpy(lens))
    for name in registry.registered_kernels():
        space = registry.get_space(name)
        case = space.make_inputs(space.suite_shapes[-1], seed=0,
                                 device="cpu")
        for genome in (space.baseline, space.shipped):
            space.run(genome, *case.args)
    assert ops.launch_counts() == before


def test_kernels_refuse_other_devices():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        ops.silu_and_mul(x)
    with pytest.raises(ValueError):
        ops.fused_add_rmsnorm(x, x, torch.empty(8, device="meta"))


def test_variant_record_names_known_kernels(monkeypatch):
    """``ops`` reads the registry, as the JAX ``ops`` does: with no
    override a kernel runs its space's shipped genome, an installed genome
    is read back, and a name with no registered space raises KeyError.
    Five spaces, as JAX registers: ``paged_flash_decode`` ships
    ``PAGED_OPTIMIZED``."""
    monkeypatch.setattr(ops, "_OVERRIDES", {})
    names = registry.registered_kernels()
    assert names == ("flash_decode", "fused_add_rmsnorm",
                     "merge_attn_states_lse", "paged_flash_decode",
                     "silu_and_mul")
    for name in names:
        assert ops.get_variant(name) == registry.get_space(name).shipped
        assert ops.get_variant(name).name == "astra_opt"
    assert ops.get_variant("paged_flash_decode") == \
        flash_decode.PAGED_OPTIMIZED
    assert jops.get_variant("paged_flash_decode") == jfd.PAGED_OPTIMIZED
    ops.set_variants(silu_and_mul=silu_and_mul.BASELINE)
    assert ops.get_variant("silu_and_mul") == silu_and_mul.BASELINE
    with pytest.raises(KeyError):
        ops.set_variants(no_such_kernel="x")
    with pytest.raises(KeyError):
        ops.get_variant("no_such_kernel")
    assert "no_such_kernel" not in ops._OVERRIDES


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """Alone in a directory and without a GPU, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_decode_ring_slots_depend_on_the_head_width_alone():
    """The decode kernels' rings keep three slots wherever three slots of
    the narrowest tile fit a block, so every layout at head_dim 128 and
    below (and every bf16 tensor-core layout) is the one it was; fp32 at
    head_dim 256 (recurrentgemma-2b's local attention: 10/1 heads) takes
    one slot, which fits at a 64-row chunk and not at 128."""
    def plan(dtype, d, chunk, q_heads=32, kv_heads=8):
        return flash_decode.launch_plan(
            dataclasses.replace(flash_decode.OPTIMIZED, chunk=chunk),
            batch=8, q_heads=q_heads, kv_heads=kv_heads, head_dim=d,
            seq=4096, dtype=dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 80, 128, 256):
            for chunk in (16, 32, 64, 128, 256):
                p = plan(dtype, d, chunk)
                one = dtype == torch.float32 and d == 256
                assert p["stages"] == (1 if one else 3), (dtype, d, chunk)
    bf16 = plan(torch.bfloat16, 256, 64, 10, 1)
    assert bf16["smem"] == 211_408 and bf16["grid"] == (2, 8, 8)
    fp32 = plan(torch.float32, 256, 64, 10, 1)
    assert fp32["smem"] == 141_776 <= flash_decode.SMEM_PER_BLOCK
    assert plan(torch.float32, 256, 128, 10, 1)["smem"] > \
        flash_decode.SMEM_PER_BLOCK
    paged = flash_decode.paged_launch_plan(
        batch=8, q_heads=10, kv_heads=1, head_dim=256, page=16, n_pt=128,
        dtype=torch.float32)
    assert paged["stages"] == 1 and paged["smem"] <= \
        flash_decode.SMEM_PER_BLOCK
