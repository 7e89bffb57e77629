"""yi-34b [dense]: llama-architecture GQA [arXiv:2403.04652; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, rope_theta=5e6)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab=512)
