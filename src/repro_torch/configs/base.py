"""Model configuration schema (the JAX package's ``ModelConfig``, all five
families: dense, moe, hybrid, xlstm and encdec)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def pad_to(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return -(-x // m) * m


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's dimensions; ``dtype`` is the compute type."""

    name: str
    family: str                 # dense | moe | xlstm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window attention
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0                    # d_ff per expert
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma): layer pattern period -- indices of attention
    # layers within each period; the others are RG-LRU recurrent blocks
    period: int = 0
    attn_in_period: tuple = ()
    conv_width: int = 4
    lru_width: int = 0

    # xlstm: blocks alternate (mLSTM, sLSTM) within each period
    slstm_every: int = 0                  # 0 = all mLSTM

    # enc-dec
    enc_layers: int = 0                   # 0 = decoder-only

    # modality frontend stub: prompts are precomputed frame embeddings
    # ``[S, d_model]`` instead of token ids
    frontend: str = "tokens"              # tokens | frames

    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        """Per-head width."""
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it."""
        return pad_to(self.vocab, 256)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype as a ``torch.dtype``."""
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {self.dtype!r}; have "
                             f"{sorted(_DTYPES)}") from None


def long_context_ok(cfg: ModelConfig) -> bool:
    """True for the sub-quadratic mixers (the recurrent families and a
    sliding window), the configs the JAX package runs at 500k tokens."""
    return cfg.family in ("xlstm", "hybrid") or cfg.window is not None
