"""qwen2-0.5b [dense]: GQA kv=2, QKV bias [arXiv:2407.10671; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936,
    qkv_bias=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=1, d_ff=128, vocab=256)
