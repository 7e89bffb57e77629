"""seamless-m4t-large-v2 [audio]: the encoder-decoder backbone; the audio
frontend is a stub, prompts are precomputed frame embeddings
[arXiv:2308.11596; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
    enc_layers=24, frontend="frames")


def smoke() -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    return dataclasses.replace(CONFIG, n_layers=2, enc_layers=2, d_model=64,
                               n_heads=2, n_kv_heads=2, d_ff=128, vocab=256)
