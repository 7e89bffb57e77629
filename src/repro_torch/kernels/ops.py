"""Kernel dispatch for the model layers (the "reintegration" layer).

The model calls these functions, never a kernel module directly, so a
tuned genome drops in for the whole framework. Dispatch follows the
tensor: a CUDA tensor launches the Hopper kernel (or raises), a CPU tensor
takes the genome's plain PyTorch version. There is no fallback from one to
the other.

``set_variants`` installs tuned genomes process-wide (what the paper calls
reintegration); ``get_variant`` reads them back through the kernel
registry, as the JAX package's ``ops`` does: a kernel with no override
runs its registered space's shipped genome, and a name with no registered
space raises KeyError.

Training differentiates the norm and the SwiGLU gate: with grad mode on
and an input that requires grad, ``fused_add_rmsnorm`` and
``silu_and_mul`` go through an autograd Function whose forward is the
same wrapper call (the kernel, counted, on a CUDA tensor) and whose
backward is the plain PyTorch gradient of the oracle (``ref.*_vjp``): the
JAX package has no backward kernel, it differentiates its jnp reference.
Otherwise, as on the serving path, they call the wrapper directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import fused_add_rmsnorm as _rms
from repro_torch.kernels import merge_attn_states as _merge
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry as _registry
from repro_torch.kernels import silu_and_mul as _silu

_OVERRIDES: dict[str, object] = {}

_WRAPPERS = {"fused_add_rmsnorm": _rms.fused_add_rmsnorm,
             "silu_and_mul": _silu.silu_and_mul,
             "paged_flash_decode": _fd.paged_flash_decode_attention,
             "merge_attn_states_lse": _merge.merge_attn_states_lse,
             "flash_decode": _fd.flash_decode_attention}


def set_variants(**kwargs) -> None:
    """Reintegrate tuned genomes by kernel name (paper §3.2
    post-processing); a name with no registered space raises KeyError."""
    for name, variant in kwargs.items():
        _registry.get_space(name)
        _OVERRIDES[name] = variant


def get_variant(name: str):
    """The installed genome of ``name``, else its space's shipped one."""
    try:
        return _OVERRIDES[name]
    except KeyError:
        return _registry.get_space(name).shipped


class _SiluAndMul(torch.autograd.Function):
    """``silu_and_mul`` (the kernel on a CUDA tensor) with the oracle's
    gradient."""

    @staticmethod
    def forward(ctx, x, variant):
        ctx.save_for_backward(x)
        return _silu.silu_and_mul(x, variant)

    @staticmethod
    def backward(ctx, dout):
        x, = ctx.saved_tensors
        return _ref.silu_and_mul_vjp(x, dout), None


class _FusedAddRmsNorm(torch.autograd.Function):
    """``fused_add_rmsnorm`` (the kernel on a CUDA tensor) with the
    oracle's gradient, from the saved inputs."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps, variant):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps = eps
        return _rms.fused_add_rmsnorm(x, residual, weight, eps, variant)

    @staticmethod
    def backward(ctx, dy, dr):
        x, residual, weight = ctx.saved_tensors
        return (*_ref.fused_add_rmsnorm_vjp(x, residual, weight, dy, dr,
                                            ctx.eps), None, None)


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def silu_and_mul(x):
    """SwiGLU gate: ``silu(x[..., :d]) * x[..., d:]``."""
    variant = get_variant("silu_and_mul")
    if _differentiated(x):
        return _SiluAndMul.apply(x, variant)
    return _silu.silu_and_mul(x, variant)


def fused_add_rmsnorm(x, residual, weight, eps: float = 1e-6):
    """Residual add + RMSNorm. Returns ``(y, new_residual)``."""
    variant = get_variant("fused_add_rmsnorm")
    if _differentiated(x, residual, weight):
        return _FusedAddRmsNorm.apply(x, residual, weight, eps, variant)
    return _rms.fused_add_rmsnorm(x, residual, weight, eps, variant)


def merge_attn_states_lse(v_a, s_a, v_b, s_b):
    """LSE merge of two partial attention states. Returns ``(v, s)``."""
    return _merge.merge_attn_states_lse(v_a, s_a, v_b, s_b,
                                        get_variant("merge_attn_states_lse"))


def flash_decode_attention(q, k, v, *, kv_len=None, sm_scale=None,
                           return_lse: bool = False):
    """Single-token GQA decode attention over a contiguous KV cache
    ``[batch, seq, kv_heads, head_dim]``."""
    return _fd.flash_decode_attention(q, k, v, kv_len=kv_len,
                                      sm_scale=sm_scale,
                                      variant=get_variant("flash_decode"),
                                      return_lse=return_lse)


def paged_flash_decode_attention(q, k_pages, v_pages, page_table, *,
                                 kv_len=None, sm_scale=None):
    """Single-token GQA decode attention over a paged KV pool."""
    return _fd.paged_flash_decode_attention(
        q, k_pages, v_pages, page_table, kv_len=kv_len, sm_scale=sm_scale,
        variant=get_variant("paged_flash_decode"))


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (kernel name -> launches, possibly negative) to the
    counts. A CUDA graph records its launches once, at capture, where the
    wrappers count them though nothing runs: the capturer takes that
    delta of ``launch_counts()`` off again and adds it back on each
    replay, so the counts stay the launches the device ran."""
    for name, n in delta.items():
        _WRAPPERS[name].launches += n
