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

    @property
    def activated_params(self) -> int:
        """~N for the 6·N·D model-FLOPs count (MoE: the active experts
        only), JAX's arithmetic as written."""
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab * d * (1 if self.enc_layers else 2)
        att = L * d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + L * self.n_heads * self.head_dim * d
        if self.family == "moe":
            mlp = L * 3 * d * self.expert_ff * self.top_k \
                + L * d * self.n_experts          # router
        elif self.family == "xlstm":
            att = L * d * d * 4                   # qkv+o equivalents, gates
            mlp = 0
        else:
            mlp = L * 3 * d * self.d_ff
        if self.enc_layers:
            att += self.enc_layers * 4 * d * d + self.n_layers * 4 * d * d
            mlp += self.enc_layers * 3 * d * self.d_ff
        return emb + att + mlp


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the dry run."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def long_context_ok(cfg: ModelConfig) -> bool:
    """True for the sub-quadratic mixers (the recurrent families and a
    sliding window), the configs the JAX package runs at 500k tokens."""
    return cfg.family in ("xlstm", "hybrid") or cfg.window is not None


def cells_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The shape cells ``cfg`` runs: all but ``long_500k`` for a full
    attention."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if long_context_ok(cfg):
        cells.append(LONG_500K)
    return cells
