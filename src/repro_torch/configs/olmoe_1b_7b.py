"""olmoe-1b-7b [moe]: 64 experts top-8 [arXiv:2409.02060; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, expert_ff=1024)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=2, d_ff=64, vocab=256,
                               n_experts=4, top_k=2, expert_ff=64)
