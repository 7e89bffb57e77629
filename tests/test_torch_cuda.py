"""Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (it builds the kernel
library at first use) and skips without one. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 rtol 1e-5 / atol 1e-4 and bf16 3e-2 / 3e-2, the JAX
package's kernel tolerances. The kernels sum in another order than the
plain versions and use CUDA's expf/rsqrtf, so fp32 agrees to rounding.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode, fused_add_rmsnorm, ops, ref
from repro_torch.kernels import silu_and_mul

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

