"""recurrentgemma-2b [hybrid]: RG-LRU recurrent blocks and local attention
(2 recurrent : 1 attention), MQA with one KV head, window 2048
[arXiv:2402.19427; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000,
    window=2048, lru_width=2560, period=3, attn_in_period=(2,))


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=5, d_model=64, n_heads=2,
                               n_kv_heads=1, d_ff=128, vocab=256,
                               window=32, lru_width=64)
