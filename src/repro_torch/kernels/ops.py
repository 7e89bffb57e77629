"""Kernel dispatch for the model layers (the "reintegration" layer).

The model calls these functions, never a kernel module directly, so a
tuned variant can later drop in for the whole framework. Dispatch follows
the tensor: a CUDA tensor launches the Hopper kernel (or raises), a CPU
tensor takes the plain PyTorch version. There is no fallback from one to
the other.

``set_variants`` / ``get_variant`` keep the process-wide record of tuned
variants. Each kernel has one variant so far; the genomes and the
registry that give the record its values come with the agent loop.
"""

from __future__ import annotations

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import fused_add_rmsnorm as _rms
from repro_torch.kernels import silu_and_mul as _silu

KERNELS = ("fused_add_rmsnorm", "silu_and_mul", "paged_flash_decode")

_OVERRIDES: dict[str, object] = {}


def set_variants(**kwargs) -> None:
    """Record tuned variants by kernel name; unknown names raise KeyError."""
    for name, variant in kwargs.items():
        if name not in KERNELS:
            raise KeyError(f"unknown kernel {name!r}; have {KERNELS}")
        _OVERRIDES[name] = variant


def get_variant(name: str):
    """The recorded variant of ``name``, or None for the shipped kernel."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {KERNELS}")
    return _OVERRIDES.get(name)


def silu_and_mul(x):
    """SwiGLU gate: ``silu(x[..., :d]) * x[..., d:]``."""
    return _silu.silu_and_mul(x)


def fused_add_rmsnorm(x, residual, weight, eps: float = 1e-6):
    """Residual add + RMSNorm. Returns ``(y, new_residual)``."""
    return _rms.fused_add_rmsnorm(x, residual, weight, eps)


def paged_flash_decode_attention(q, k_pages, v_pages, page_table, *,
                                 kv_len=None, sm_scale=None):
    """Single-token GQA decode attention over a paged KV pool."""
    return _fd.paged_flash_decode_attention(
        q, k_pages, v_pages, page_table, kv_len=kv_len, sm_scale=sm_scale)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {"fused_add_rmsnorm": _rms.fused_add_rmsnorm.launches,
            "silu_and_mul": _silu.silu_and_mul.launches,
            "paged_flash_decode": _fd.paged_flash_decode_attention.launches}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _rms.fused_add_rmsnorm.launches = 0
    _silu.silu_and_mul.launches = 0
    _fd.paged_flash_decode_attention.launches = 0
