"""SeamlessM4T-large-v2 backbone: an encoder-decoder transformer
[arXiv:2308.11596]. The port of the JAX ``models/seamless.py``: the
training forward and loss, prefill and the decode step.

Only the transformer backbone is modelled, as in JAX: the audio frontend
is a stub, and a prompt is ``[S_src, d_model]`` precomputed frame
embeddings (``cfg.frontend == "frames"``). The speech encoder is plain
bidirectional transformer layers (rope on q and k, attention over every
frame); the text decoder is causal self-attention (rope), cross-attention
to the encoder output (no rope) and the SwiGLU MLP. Parameters are
``{"embed", "enc_layers": [layer, ...], "dec_layers": [layer, ...],
"enc_norm", "final_norm", "lm_head"}``, one dict a layer where JAX stacks
them.

Which kernels run: the norms are the plain ``layers.rms_norm``, so the
family launches no ``fused_add_rmsnorm``; every encoder and decoder MLP
launches ``silu_and_mul``, and each decoder layer's decode launches
``flash_decode`` twice, for self-attention over its ``pos + 1`` rows and
for cross-attention. The encoder's attention is the plain
``layers.flash_attention`` (non-causal), as it is jnp in JAX.

Training (``forward``) runs the encoder on ``batch["frames"]`` and the
decoder (causal self-attention, cross-attention to the encoder output,
the MLP) on the tokens, every encoder and decoder layer under
``layers.remat``, as JAX checkpoints both scans.

The cache holds two K/V pairs a decoder layer, ``k``/``v`` (generated
tokens) and ``ck``/``cv`` (the encoder output's projections), all
``[layers, batch, seq, heads, head_dim]``: prefill writes rows ``[0,
S_src)`` of ``ck``/``cv`` and decode's cross-attention reads every row of
them (JAX's ``src_len`` is the cache's row count), so rows past a
request's frames hold zeros or the slot's last occupant's rows and take
part, as in JAX. The encoder is bidirectional, so frames are encoded at
exact length (``PAD_PREFILL``), and the cross cache is indexed by the
source, not by the decode position, so it does not page (``PAGED_OK``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import spmd

# The encoder is bidirectional: pad frames would reach every position's
# encoding, so source frames are always encoded at exact length.
PAD_PREFILL = False

# The cross-attention cache is indexed by the source, not by the decode
# position, so the uniform page layout does not describe it. Contiguous
# per-slot cache only.
PAGED_OK = False


def cast_params(tree, cfg: ModelConfig, device):
    """Move a parameter tree to ``device``: the norms in fp32, everything
    else in the compute dtype."""
    return T.cast_params(tree, cfg, device)


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the JAX init's distributions, from ``gen``
    (which must live on ``device``), drawn and cast one layer at a
    time."""
    d = cfg.d_model

    def normal(shape, scale):
        return T._trunc_normal(shape, scale, gen, device)

    def mlp():
        return {"w_gateup": normal((d, 2 * cfg.d_ff), d ** -0.5),
                "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}

    def ones():
        return torch.ones(d, device=device)

    enc = [cast_params({"attn": T.attn_init(cfg, normal), "mlp": mlp(),
                        "attn_norm": ones(), "mlp_norm": ones()},
                       cfg, device) for _ in range(cfg.enc_layers)]
    dec = [cast_params({"attn": T.attn_init(cfg, normal),
                        "cross": T.attn_init(cfg, normal), "mlp": mlp(),
                        "attn_norm": ones(), "cross_norm": ones(),
                        "mlp_norm": ones()}, cfg, device)
           for _ in range(cfg.n_layers)]
    dt = cfg.torch_dtype
    return {"embed": normal((cfg.padded_vocab, d), 1.0).to(dt),
            "enc_layers": enc, "dec_layers": dec,
            "enc_norm": ones(), "final_norm": ones(),
            "lm_head": normal((d, cfg.padded_vocab), d ** -0.5).to(dt)}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init``'s tree (JAX's ``init``
    axes, per layer)."""
    dec = {**T.layer_axes(cfg), "cross": T.attn_axes(cfg),
           "cross_norm": ("embed",)}
    return {**T.model_axes(
        enc_layers=[T.layer_axes(cfg) for _ in range(cfg.enc_layers)],
        dec_layers=[dict(dec) for _ in range(cfg.n_layers)]),
        "enc_norm": ("embed",)}


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def _enc_block(p, x, cos, sin, cfg: ModelConfig):
    x = spmd.shard_batch(x)
    normed = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], normed, cfg)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    o = L.flash_attention(q, k, v, causal=False)
    # pinned at the mid-block add, as the decoder's are (on DTensors)
    x = spmd.shard_batch(x + L.out_proj(p["attn"], o, x.dtype))
    normed = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], normed)


def _rope_table(x, cfg: ModelConfig):
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    return L.rope_angles(pos, cfg.head_dim, cfg.rope_theta)


def encode(params, cfg: ModelConfig, frames):
    """frames: ``[B, S_src, D]`` precomputed frame embeddings -> the
    encoder output ``[B, S_src, D]`` in the compute dtype (each layer
    recomputed in the backward pass when grad mode is on)."""
    x = frames.to(cfg.torch_dtype)
    cos, sin = _rope_table(x, cfg)
    for p in params["enc_layers"]:
        x = L.remat(_enc_block, p, x, cos, sin, cfg)
    return L.rms_norm(spmd.shard_batch(x), params["enc_norm"], cfg.norm_eps)


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------

def _dec_block(p, x, enc, cos, sin, cfg: ModelConfig):
    x = spmd.shard_batch(x)
    # causal self-attention
    normed = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], normed, cfg)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    o = L.flash_attention(q, k, v, causal=True)
    x = spmd.shard_batch(x + L.out_proj(p["attn"], o, x.dtype))
    # cross-attention to the encoder output
    normed = L.rms_norm(x, p["cross_norm"], cfg.norm_eps)
    qc, _, _ = L.qkv_proj(p["cross"], normed, cfg)
    _, kc, vc = L.qkv_proj(p["cross"], enc.to(x.dtype), cfg)
    oc = L.flash_attention(qc, kc, vc, causal=False)
    x = spmd.shard_batch(x + L.out_proj(p["cross"], oc, x.dtype))
    normed = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], normed)


def forward(params, cfg: ModelConfig, batch):
    """Teacher-forced translation logits ``[B, S_tgt, V_pad]`` for
    ``batch = {"frames": [B, S_src, D], "tokens": [B, S_tgt]}``."""
    enc = encode(params, cfg, batch["frames"])
    x = L.embed_tokens(params["embed"], batch["tokens"]).to(cfg.torch_dtype)
    cos, sin = _rope_table(x, cfg)
    for p in params["dec_layers"]:
        x = L.remat(_dec_block, p, x, enc, cos, sin, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["lm_head"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy of ``forward``; the labels are
    ``batch["labels"]``."""
    logits = forward(params, cfg, batch)
    return L.ce_loss(logits, batch["labels"], cfg.vocab)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """(shape and dtype of each leaf, its logical axes): the self K/V and
    the cross K/V, each ``[layers, batch, seq, heads, head_dim]``."""
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.torch_dtype
    names = ("k", "v", "ck", "cv")
    return ({name: (shape, dt) for name in names},
            {name: T.CACHE_AXES for name in names})


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A zeroed contiguous cache of ``batch`` slots (``cache_spec``)."""
    spec, _ = cache_spec(cfg, batch, seq)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()}


def prefill(params, cfg: ModelConfig, frames, *, length: int | None = None,
            cache_len: int | None = None):
    """Encode ``frames [B, S_src, D]``, project every decoder layer's
    cross K/V from the encoder output, and run the decode step on BOS
    (token 0) at position 0 over a zeroed self cache of ``cache_len`` (or
    S_src) rows. Returns (the BOS step's logits ``[B, V_pad]``, the
    cache). ``length`` (right-padded frames) is refused."""
    if length is not None:
        raise ValueError("enc-dec prefill does not take padded frames "
                         "(PAD_PREFILL is False)")
    b, s_src, _ = frames.shape
    enc = encode(params, cfg, frames)
    ck = torch.stack([L._heads_matmul(enc, p["cross"]["wk"])
                      for p in params["dec_layers"]])
    cv = torch.stack([L._heads_matmul(enc, p["cross"]["wv"])
                      for p in params["dec_layers"]])
    n = cache_len or s_src
    zeros = torch.zeros(ck.shape[:2] + (n,) + ck.shape[3:], dtype=ck.dtype,
                        device=ck.device)
    cache = {"k": zeros, "v": zeros.clone(), "ck": ck, "cv": cv}
    start = torch.zeros((b,), dtype=torch.int32, device=frames.device)
    return decode_step(params, cfg, cache, start, start)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step over the contiguous cache, in place. token, pos:
    ``[B]`` int32. Each decoder layer writes its new K/V at row ``pos``
    (a row past the cache is dropped), attends over ``pos + 1`` self rows
    and over every row of the cross cache, both through the
    ``flash_decode`` kernel. Returns (logits ``[B, V_pad]``, cache)."""
    x = L.embed_tokens(params["embed"], token[:, None]).to(cfg.torch_dtype)
    kv_len = (pos + 1).to(torch.int32)
    src_len = torch.full_like(kv_len, cache["ck"].shape[2])
    cos, sin = L.rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for li, p in enumerate(params["dec_layers"]):
        k_l, v_l = cache["k"][li], cache["v"][li]
        x = spmd.shard_batch(x)
        normed = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = L.qkv_proj(p["attn"], normed, cfg)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        L.update_cache(k_l, v_l, k_new[:, 0], v_new[:, 0], pos)
        o = ops.flash_decode_attention(q[:, 0].contiguous(), k_l, v_l,
                                       kv_len=kv_len)
        x = spmd.shard_batch(x + L.out_proj(p["attn"], o[:, None], o.dtype))
        normed = L.rms_norm(x, p["cross_norm"], cfg.norm_eps)
        qc = L._heads_matmul(normed, p["cross"]["wq"])
        oc = ops.flash_decode_attention(qc[:, 0].contiguous(),
                                        cache["ck"][li], cache["cv"][li],
                                        kv_len=src_len)
        x = spmd.shard_batch(x + L.out_proj(p["cross"], oc[:, None], oc.dtype))
        normed = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp_block(p["mlp"], normed)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x[:, 0], params["lm_head"]), cache
