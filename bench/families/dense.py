"""The dense decoder-only transformer (llama and mistral layout: GQA, rope,
SwiGLU, RMSNorm, an optional sliding window), as the benchmark knows it.

Four things, all plain PyTorch, importing nothing of the program:

- ``port_config``: the program's ``ModelConfig`` fields for a
  configuration file (its Hugging Face keys);
- ``draw_weights``: seeded weights, drawn on the device in the type they
  are served in, in the program's parameter layout, a few large calls;
- ``reference_logits``: the plain forward pass in float32 (TF32 off),
  layer by layer over whole sequences, with an optional lower-precision
  mode (``quant="fp8"``) that is the correctness control;
- the work of a token and of a decode-attention call, in FLOPs and bytes,
  from the configuration alone.
"""

from __future__ import annotations

import torch

F32 = torch.float32
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(c: dict) -> dict:
    """The sizes every function below works from."""
    d, hq = c["hidden_size"], c["num_attention_heads"]
    dh = c.get("head_dim") or d // hq
    if dh * hq != d:
        raise ValueError(f"head_dim {dh} x {hq} heads != hidden {d}")
    return {"L": c["num_hidden_layers"], "d": d, "hq": hq,
            "hkv": c["num_key_value_heads"], "dh": dh,
            "ff": c["intermediate_size"], "vocab": c["vocab_size"],
            "vpad": -(-c["vocab_size"] // 256) * 256,
            "window": c.get("sliding_window"),
            "theta": float(c.get("rope_theta", 10000.0)),
            "eps": float(c["rms_norm_eps"]),
            "bytes": torch.finfo(DTYPES[c["torch_dtype"]]).bits // 8}


def port_config(c: dict, name: str) -> dict:
    """Keyword arguments of the program's ``ModelConfig``."""
    m = dims(c)
    return dict(name=name, family="dense", n_layers=m["L"], d_model=m["d"],
                n_heads=m["hq"], n_kv_heads=m["hkv"], d_ff=m["ff"],
                vocab=m["vocab"], window=m["window"],
                rope_theta=m["theta"], norm_eps=m["eps"],
                dtype=c["torch_dtype"])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def draw_weights(c: dict, seed: int, device) -> dict:
    """Weights from ``seed``: each kind of matrix is one ``[L, ...]``
    tensor drawn by one call of a ``torch.Generator`` on ``device``, in
    the serving type, normal with the fan-in scale (the embedding at 1);
    norm weights ``1 + N(0, 0.1)`` in float32. Returns the program's
    layout: ``{"embed", "layers": [{"attn": {"wq", "wk", "wv", "wo"},
    "mlp": {"w_gateup", "w_down"}, "attn_norm", "mlp_norm"}],
    "final_norm", "lm_head"}``, each layer's leaves views of the stacks."""
    m = dims(c)
    L, d, hq, hkv, dh, ff = (m[k] for k in ("L", "d", "hq", "hkv", "dh",
                                            "ff"))
    dt = DTYPES[c["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)

    def normal(shape, std, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=gen)

    wq = normal((L, d, hq, dh), d ** -0.5)
    wk = normal((L, d, hkv, dh), d ** -0.5)
    wv = normal((L, d, hkv, dh), d ** -0.5)
    wo = normal((L, hq, dh, d), (hq * dh) ** -0.5)
    gu = normal((L, d, 2 * ff), d ** -0.5)
    down = normal((L, ff, d), ff ** -0.5)
    norms = normal((2 * L + 1, d), 0.1, F32).add_(1.0)
    layers = [{"attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i],
                        "wo": wo[i]},
               "mlp": {"w_gateup": gu[i], "w_down": down[i]},
               "attn_norm": norms[2 * i], "mlp_norm": norms[2 * i + 1]}
              for i in range(L)]
    return {"embed": normal((m["vpad"], d), 1.0), "layers": layers,
            "final_norm": norms[2 * L],
            "lm_head": normal((d, m["vpad"]), d ** -0.5)}


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

def _fp8(x, dim: int):
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (amax to 448), back in float32: the control's precision."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _matmul(x, w, quant):
    """``x [S, in] @ w [in, out]`` in float32; under ``quant="fp8"`` both
    sides go through e4m3 first (x per row, w per output column)."""
    if quant == "fp8":
        return _fp8(x, -1) @ w
    return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """Rotate-half rope over ``x [S, H, dh]`` at positions ``pos [S]``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device)
                      / half)
    ang = pos[:, None].to(F32) * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, window, block: int):
    """Causal GQA attention in float32, ``q [S, Hq, dh]``, ``k, v [S,
    Hkv, dh]``: query i sees keys j <= i with i - j < window. Queries go
    in blocks of ``block`` rows over the keys they can see."""
    s, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty_like(q)
    kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)          # [Hkv, S, dh]
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        j0 = max(0, i0 - window + 1) if window else 0
        qb = q[i0:i1].reshape(i1 - i0, hkv, g, dh).permute(1, 2, 0, 3)
        sc = torch.einsum("hgqd,hkd->hgqk", qb, kh[:, j0:i1]) * dh ** -0.5
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(j0, i1, device=q.device)[None, :]
        mask = kj <= qi
        if window:
            mask &= (qi - kj) < window
        sc = sc.masked_fill(~mask, float("-inf"))
        o = torch.einsum("hgqk,hkd->hgqd", torch.softmax(sc, -1),
                         vh[:, j0:i1])
        out[i0:i1] = o.permute(2, 0, 1, 3).reshape(i1 - i0, hq, dh)
    return out


def reference_logits(w: dict, c: dict, seqs, starts, *, quant=None,
                     block: int = 1024) -> list:
    """Float32 logits over the real vocabulary at positions ``starts[i]``
    to the end of each sequence ``seqs[i]`` (token ids ``[S_i]`` on the
    weights' device), from the full forward pass: embed, then per layer
    ``h += attn(rms(h))``, ``h += mlp(rms(h))``, then the final norm and
    the head. Each layer's weights are cast to float32 once, used for
    every sequence and dropped, so one layer's copy is the largest
    temporary. ``quant="fp8"`` rounds every matrix product's operands
    through float8 e4m3 (the control)."""
    m = dims(c)
    hq, hkv, dh, ff, eps = m["hq"], m["hkv"], m["dh"], m["ff"], m["eps"]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            hs = [w["embed"][s].to(F32) for s in seqs]
            pos = [torch.arange(len(s), device=s.device) for s in seqs]
            for p in w["layers"]:
                mats = {"wq": p["attn"]["wq"].reshape(m["d"], hq * dh),
                        "wk": p["attn"]["wk"].reshape(m["d"], hkv * dh),
                        "wv": p["attn"]["wv"].reshape(m["d"], hkv * dh),
                        "wo": p["attn"]["wo"].reshape(hq * dh, m["d"]),
                        "gu": p["mlp"]["w_gateup"],
                        "down": p["mlp"]["w_down"]}
                mats = {k: v.to(F32) for k, v in mats.items()}
                if quant == "fp8":
                    mats = {k: _fp8(v, 0) for k, v in mats.items()}
                an, mn = p["attn_norm"].to(F32), p["mlp_norm"].to(F32)
                for i, h in enumerate(hs):
                    x = _rms(h, an, eps)
                    q = _matmul(x, mats["wq"], quant).view(-1, hq, dh)
                    k = _matmul(x, mats["wk"], quant).view(-1, hkv, dh)
                    v = _matmul(x, mats["wv"], quant).view(-1, hkv, dh)
                    q = _rope(q, pos[i], m["theta"])
                    k = _rope(k, pos[i], m["theta"])
                    o = _attention(q, k, v, m["window"], block)
                    h = h + _matmul(o.reshape(-1, hq * dh), mats["wo"],
                                    quant)
                    x = _rms(h, mn, eps)
                    gu = _matmul(x, mats["gu"], quant)
                    act = torch.nn.functional.silu(gu[:, :ff]) * gu[:, ff:]
                    hs[i] = h + _matmul(act, mats["down"], quant)
                del mats
            head = w["lm_head"].to(F32)[:, :m["vocab"]]
            if quant == "fp8":
                head = _fp8(head, 0)
            fn = w["final_norm"].to(F32)
            return [_matmul(_rms(h[s0:], fn, eps), head, quant)
                    for h, s0 in zip(hs, starts)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------

def layer_matmul_params(c: dict) -> int:
    """Weights one token multiplies by in one layer."""
    m = dims(c)
    d, hq, hkv, dh, ff = m["d"], m["hq"], m["hkv"], m["dh"], m["ff"]
    return d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * ff


def weight_bytes(c: dict) -> int:
    """Bytes of every weight as served: the matrices, the embedding and
    the head in the serving type, the norms in float32."""
    m = dims(c)
    mats = m["L"] * layer_matmul_params(c) + 2 * m["vpad"] * m["d"]
    return mats * m["bytes"] + (2 * m["L"] + 1) * m["d"] * 4


def kv_row_bytes(c: dict) -> int:
    """Cache bytes of one position over all layers (K and V)."""
    m = dims(c)
    return m["L"] * 2 * m["hkv"] * m["dh"] * m["bytes"]


def attended_rows(c: dict, pos: int) -> int:
    """Keys the token at ``pos`` attends to (itself included)."""
    w = dims(c)["window"]
    return min(pos + 1, w) if w else pos + 1


def token_flops(c: dict, rows: int, head: bool) -> float:
    """Model FLOPs of one token through every layer, attending ``rows``
    keys, and through the head when ``head``."""
    m = dims(c)
    f = 2 * m["L"] * layer_matmul_params(c) \
        + 4 * m["L"] * m["hq"] * m["dh"] * rows
    return f + (2 * m["d"] * m["vocab"] if head else 0)


def prefill_flops(c: dict, n: int) -> float:
    """Model FLOPs of a prompt of ``n`` tokens: every position through
    the layers with causal (windowed) attention, the last through the
    head."""
    m = dims(c)
    w = m["window"] or n
    full = min(n, w)
    rows = full * (full + 1) // 2 + (n - full) * w
    return 2 * m["L"] * layer_matmul_params(c) * n \
        + 4 * m["L"] * m["hq"] * m["dh"] * rows + 2 * m["d"] * m["vocab"]


def decode_attn_work(c: dict, rows: int) -> tuple[float, float]:
    """(FLOPs, bytes) one slot's decode attention needs over all layers
    when it reads ``rows`` cached positions: the K/V rows once, the query
    in and the output out."""
    m = dims(c)
    flops = 4 * m["L"] * m["hq"] * m["dh"] * rows
    nbytes = rows * kv_row_bytes(c) \
        + m["L"] * 2 * m["hq"] * m["dh"] * m["bytes"]
    return float(flops), float(nbytes)
