"""granite-moe-3b-a800m [moe]: 40 experts top-8, d_ff 512 an expert (the
assigned 40 experts; the HF card's granite-3.0 sibling lists 32)
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
    n_experts=40, top_k=8, expert_ff=512)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=1, d_ff=64, vocab=256,
                               n_experts=4, top_k=2, expert_ff=64)
