"""chameleon-34b [vlm]: early fusion; VQ image tokens are ordinary ids in
the unified 65,536 vocab, so a prompt is token ids [arXiv:2405.09818]. The
backbone is a dense transformer with qk-norm."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True)


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab=512)
