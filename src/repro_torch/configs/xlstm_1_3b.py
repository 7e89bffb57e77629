"""xlstm-1.3b [ssm]: sLSTM and mLSTM blocks (7:1) [arXiv:2405.04517]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, slstm_every=8)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=8, d_model=64, n_heads=2,
                               n_kv_heads=2, vocab=256)
