"""h2o-danube-1.8b [dense]: llama and mistral mix, sliding-window
attention (window 4096) [arXiv:2401.16818; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv_heads=8, d_ff=6912, vocab=32000, window=4096)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab=512, window=64)
