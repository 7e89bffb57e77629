"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX families (the dense decoder and the mixture of experts) stack
every layer weight on a leading ``[n_layers, ...]`` axis (their layers
run under ``lax.scan``); the port keeps one dict per layer. Leaf names and
the layout of each leaf are the same on both sides (an MoE layer: ``attn``,
``router [D, E]``, ``w_gateup [E, D, 2F]``, ``w_down [E, F, D]``,
``attn_norm``, ``mlp_norm``), so the conversion unstacks, copies and casts
as the family's ``cast_params`` says (matrix weights, embeddings and
biases to the compute dtype; norm weights, and the MoE router, in fp32).
The JAX tree itself is never imported here: the caller hands over
``jax.tree.map(np.asarray, params)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry


def _unstack(tree, i: int):
    return {k: _unstack(v, i) if isinstance(v, dict)
            else torch.from_numpy(np.array(v[i], np.float32))
            for k, v in tree.items()}


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters for ``cfg`` from the JAX parameter tree (leaves
    as numpy arrays), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    n = np.asarray(np_tree["layers"]["attn_norm"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} stacked layers, config "
                         f"{cfg.n_layers}")
    tree = {
        "embed": torch.from_numpy(np.array(np_tree["embed"], np.float32)),
        "layers": [_unstack(np_tree["layers"], i) for i in range(n)],
        "final_norm": torch.from_numpy(
            np.array(np_tree["final_norm"], np.float32)),
        "lm_head": torch.from_numpy(np.array(np_tree["lm_head"],
                                             np.float32)),
    }
    return registry.module_for(cfg).cast_params(tree, cfg, dev)
