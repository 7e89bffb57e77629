"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX families stack every layer weight on leading axes (their layers
run under ``lax.scan``); the port keeps one dict per layer. The dense
decoder and the mixture of experts stack ``layers`` as ``[n_layers,
...]``; the Griffin hybrid stacks ``periods`` (``rec`` as ``[P, 2, ...]``,
its two recurrent blocks, and ``attn`` as ``[P, ...]``) and ``tail`` as
``[T, ...]``; the xLSTM stacks ``periods`` (``mlstm`` as ``[P, 7, ...]``,
``slstm`` as ``[P, ...]``); the encoder-decoder ``enc_layers`` and
``dec_layers``, with ``enc_norm`` beside them. Leaf names and the layout
of each leaf are the same on both sides (an MoE layer: ``attn``, ``router
[D, E]``, ``w_gateup [E, D, 2F]``, ``w_down [E, F, D]``, ``attn_norm``,
``mlp_norm``), so the conversion unstacks, copies and casts as the
family's ``cast_params`` says (matrix weights, embeddings and biases to
the compute dtype; norm weights, the MoE router, the RG-LRU gates and the
mLSTM gates in fp32).
With ``master=True`` every leaf stays fp32 (training's master weights);
the same unstacking maps a JAX gradient tree, whose layout is the
parameters', onto the port's. The JAX tree itself is never imported here:
the caller hands over ``jax.tree.map(np.asarray, params)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry


def _unstack(tree, *idx: int):
    """The entry ``idx`` of every stacked leaf of ``tree``, as fp32
    tensors."""
    return {k: _unstack(v, *idx) if isinstance(v, dict)
            else _tensor(np.asarray(v)[idx])
            for k, v in tree.items()}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _stacked(tree: dict, name: str) -> int:
    """Entries on the leading axis of ``tree``'s stacked leaf ``name``."""
    return np.asarray(tree[name]).shape[0]


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None, *,
                    master: bool = False) -> dict:
    """The port's parameters for ``cfg`` from the JAX parameter tree (leaves
    as numpy arrays), on ``device`` (default ``cuda``): cast as the
    family's ``cast_params`` says, or every leaf fp32 with ``master``."""
    dev = resolve_device(device)
    tree = {"embed": _tensor(np_tree["embed"]),
            "final_norm": _tensor(np_tree["final_norm"]),
            "lm_head": _tensor(np_tree["lm_head"])}
    if cfg.family == "hybrid":
        periods, tail = np_tree["periods"], np_tree["tail"]
        n_p = _stacked(periods["attn"], "attn_norm")
        n_t = _stacked(tail, "norm") if tail else 0
        n = 3 * n_p + n_t
        tree["periods"] = [{"rec": [_unstack(periods["rec"], i, j)
                                    for j in range(2)],
                            "attn": _unstack(periods["attn"], i)}
                           for i in range(n_p)]
        tree["tail"] = [_unstack(tail, i) for i in range(n_t)]
    elif cfg.family == "xlstm":
        periods = np_tree["periods"]
        n_p = _stacked(periods["slstm"], "norm")
        n_m = np.asarray(periods["mlstm"]["norm"]).shape[1]
        n = (n_m + 1) * n_p
        tree["periods"] = [{"mlstm": [_unstack(periods["mlstm"], i, j)
                                      for j in range(n_m)],
                            "slstm": _unstack(periods["slstm"], i)}
                           for i in range(n_p)]
    elif cfg.family == "encdec":
        enc, dec = np_tree["enc_layers"], np_tree["dec_layers"]
        n_e = _stacked(enc, "attn_norm")
        if n_e != cfg.enc_layers:
            raise ValueError(f"tree has {n_e} encoder layers, config "
                             f"{cfg.enc_layers}")
        n = _stacked(dec, "attn_norm")
        tree["enc_layers"] = [_unstack(enc, i) for i in range(n_e)]
        tree["dec_layers"] = [_unstack(dec, i) for i in range(n)]
        tree["enc_norm"] = _tensor(np_tree["enc_norm"])
    else:
        n = _stacked(np_tree["layers"], "attn_norm")
        tree["layers"] = [_unstack(np_tree["layers"], i) for i in range(n)]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} stacked layers, config "
                         f"{cfg.n_layers}")
    if master:
        cfg = dataclasses.replace(cfg, dtype="float32")
    return registry.module_for(cfg).cast_params(tree, cfg, dev)
