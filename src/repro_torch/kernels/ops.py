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

On DTensors (the dry run's sharded step, ``sharding/spmd.py``) each kernel
runs on the local shards, its inputs redistributed to placements under
which that is right; the contiguous decode attention over a cache whose
sequence is sharded runs split-KV across the shards, its partials merged
with Kernel 1's LSE math over the shards' group (JAX's
``decode_attention(seq_shard_axis=)``). Every call also marks its kernel
for an active roofline counter (``spmd.kernel``), which charges the
registered cost at the local shapes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import fused_add_rmsnorm as _rms
from repro_torch.kernels import merge_attn_states as _merge
from repro_torch.kernels import prefill_attention as _prefill
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry as _registry
from repro_torch.kernels import silu_and_mul as _silu
from repro_torch.sharding import spmd

_OVERRIDES: dict[str, object] = {}

_WRAPPERS = {"fused_add_rmsnorm": _rms.fused_add_rmsnorm,
             "silu_and_mul": _silu.silu_and_mul,
             "paged_flash_decode": _fd.paged_flash_decode_attention,
             "merge_attn_states_lse": _merge.merge_attn_states_lse,
             "flash_decode": _fd.flash_decode_attention,
             "prefill_attention": _prefill.prefill_attention}


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
    if spmd.distributed(x):
        return spmd.halves(silu_and_mul, x)
    variant = get_variant("silu_and_mul")
    d = x.shape[-1] // 2
    with spmd.kernel("silu_and_mul", variant, rows=x.numel() // max(2 * d, 1),
                     d=d, dtype=x.dtype) as shapes_only:
        if _differentiated(x):
            return _SiluAndMul.apply(x, variant)
        if shapes_only:
            return x.new_empty((*x.shape[:-1], d))
        return _silu.silu_and_mul(x, variant)


def fused_add_rmsnorm(x, residual, weight, eps: float = 1e-6):
    """Residual add + RMSNorm. Returns ``(y, new_residual)``."""
    if spmd.distributed(x, residual, weight):
        return spmd.rowwise(lambda x, r, w: fused_add_rmsnorm(x, r, w, eps),
                            (x, residual), weight)
    variant = get_variant("fused_add_rmsnorm")
    d = x.shape[-1]
    with spmd.kernel("fused_add_rmsnorm", variant,
                     rows=x.numel() // max(d, 1), d=d,
                     dtype=x.dtype) as shapes_only:
        if _differentiated(x, residual, weight):
            return _FusedAddRmsNorm.apply(x, residual, weight, eps, variant)
        if shapes_only:
            return torch.empty_like(x), torch.empty_like(x)
        return _rms.fused_add_rmsnorm(x, residual, weight, eps, variant)


def merge_attn_states_lse(v_a, s_a, v_b, s_b):
    """LSE merge of two partial attention states. Returns ``(v, s)``."""
    if spmd.distributed(v_a, s_a, v_b, s_b):
        raise NotImplementedError("merge_attn_states_lse has no sharded "
                                  "form (the model path does not call it)")
    variant = get_variant("merge_attn_states_lse")
    d = v_a.shape[-1]
    with spmd.kernel("merge_attn_states_lse", variant,
                     rows=v_a.numel() // max(d, 1), d=d,
                     dtype=v_a.dtype) as shapes_only:
        if shapes_only:
            return torch.empty_like(v_a), torch.empty_like(s_a)
        return _merge.merge_attn_states_lse(v_a, s_a, v_b, s_b, variant)


def _split_kv(info, q, k, v, kv_len, sm_scale, return_lse):
    """One shard's decode attention; over a sequence shard, its partial
    state merged with the other shards' (JAX's ``decode_attention`` with
    ``seq_shard_axis``): weights ``e^(lse - max lse)``, an empty shard's
    zero, the weighted outputs and the weights summed over the group."""
    if info.seq_group is None:
        return flash_decode_attention(q, k, v, kv_len=kv_len,
                                      sm_scale=sm_scale,
                                      return_lse=return_lse)
    import torch.distributed._functional_collectives as funcol
    s = k.shape[1]
    if kv_len is None:
        kv_len = torch.full((q.shape[0],), info.seq_offset + s,
                            dtype=torch.int32, device=q.device)
    local_len = torch.clamp(kv_len - info.seq_offset, 0, s)
    o, lse = flash_decode_attention(q, k, v, kv_len=local_len,
                                    sm_scale=sm_scale, return_lse=True)
    empty = (local_len == 0)[:, None]                       # [B, 1]
    lse = torch.where(empty, float("-inf"), lse)
    m = funcol.all_reduce(lse, "max", info.seq_group)
    m = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.where(empty, 0.0, torch.exp(lse - m))
    num = funcol.all_reduce(w[..., None] * torch.where(
        empty[..., None], 0.0, o.to(torch.float32)), "sum", info.seq_group)
    den = funcol.all_reduce(w, "sum", info.seq_group)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    if not return_lse:
        return out
    return out, m + torch.log(torch.clamp(den, min=1e-30))


def _empty_decode(q, return_lse: bool):
    """Empty outputs of a decode attention's shapes (a shapes-only
    trace)."""
    out = torch.empty_like(q)
    if not return_lse:
        return out
    return out, q.new_empty(q.shape[:2], dtype=torch.float32)


def flash_decode_attention(q, k, v, *, kv_len=None, sm_scale=None,
                           return_lse: bool = False):
    """Single-token GQA decode attention over a contiguous KV cache
    ``[batch, seq, kv_heads, head_dim]``."""
    if spmd.distributed(q, k, v):
        b, hq, _ = q.shape
        outs = ((q.shape, "bh."), ((b, hq), "bh"))[:2 if return_lse else 1]
        return spmd.per_head(
            lambda info, q, k, v, kv_len: _split_kv(
                info, q, k, v, kv_len, sm_scale, return_lse),
            1, (q, k, v, kv_len), ("bh.", "bsk.", "bsk.", "b"),
            seq_split=True, out_roles=outs)
    variant = get_variant("flash_decode")
    b, hq, dh = q.shape
    with spmd.kernel("flash_decode", variant, batch=b, q_heads=hq,
                     kv_heads=k.shape[2], head_dim=dh, seq=k.shape[1],
                     dtype=q.dtype) as shapes_only:
        if shapes_only:
            return _empty_decode(q, return_lse)
        return _fd.flash_decode_attention(q, k, v, kv_len=kv_len,
                                          sm_scale=sm_scale,
                                          variant=variant,
                                          return_lse=return_lse)


def paged_flash_decode_attention(q, k_pages, v_pages, page_table, *,
                                 kv_len=None, sm_scale=None):
    """Single-token GQA decode attention over a paged KV pool."""
    if spmd.distributed(q, k_pages, v_pages):
        raise NotImplementedError("the paged decode has no sharded form: "
                                  "the dry run decodes from the "
                                  "contiguous cache")
    variant = get_variant("paged_flash_decode")
    b, hq, dh = q.shape
    with spmd.kernel("paged_flash_decode", variant, batch=b, q_heads=hq,
                     kv_heads=k_pages.shape[2], head_dim=dh,
                     seq=page_table.shape[1] * k_pages.shape[1],
                     dtype=q.dtype) as shapes_only:
        if shapes_only:
            return _empty_decode(q, False)
        return _fd.paged_flash_decode_attention(
            q, k_pages, v_pages, page_table, kv_len=kv_len,
            sm_scale=sm_scale, variant=variant)


def prefill_attention(q, k, v, *, window=None):
    """Causal GQA self-attention over whole prompts, optionally over a
    sliding window: q ``[batch, seq, q_heads, head_dim]``, k/v ``[batch,
    seq, kv_heads, head_dim]``. ``layers.flash_attention`` sends it its
    causal calls in bf16 without grad (on DTensors, each rank's local
    shards). The kernel has no genome or search space: it is not one of
    the JAX package's Pallas kernels, and the roofline counter charges
    it by the ops of its caller's ``flash`` region, as it charges the
    walk."""
    return _prefill.prefill_attention(q, k, v, window=window)


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
