"""qwen3-8b [dense]: qk-norm, GQA [hf:Qwen/Qwen3-8B; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab=512)
