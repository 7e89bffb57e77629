"""The roofline of one dry-run cell on an H100 mesh (the JAX package's
``roofline/analysis.py``, priced at the H100's published rates).

Three terms per (arch x shape x mesh), from what rank 0 runs
(``roofline/counter.py``):

    compute    = FLOPs per card / 989e12 FLOP/s (dense bf16)
    memory     = device-memory bytes per card / 3.35e12 B/s (HBM3)
    collective = bytes on ``model`` / 450e9 B/s (NVLink, each way)
               + bytes on ``data`` and ``pod`` / 50e9 B/s (400 Gb/s NDR,
                 one NIC a card as on a DGX H100)

The model axis is the 8 cards of one NVLink domain
(``launch/mesh.py::make_production_mesh``); every other axis crosses the
network. The two links are summed: a step's collectives on each are not
assumed to overlap. The rates are NVIDIA's data sheets (H100 SXM, 700
W); no TPU constant remains.

MODEL_FLOPS (6·N·D train / 2·N·D inference, N = activated params) is the
useful-compute yardstick; the counted/model ratio exposes recompute and
redundant work (heads replicated over the model axis, for one).
"""

from __future__ import annotations

import dataclasses
import json

# H100 SXM, per card (NVIDIA data sheet, 700 W)
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9       # each way, the model axis
NET_BW = 50e9           # 400 Gb/s NDR a card, the data and pod axes
LINK_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}


@dataclasses.dataclass
class Roofline:
    """One cell's counts per card and its three terms (JAX's
    ``Roofline``; ``coll_breakdown`` by kind and mesh axis)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict            # {(kind, axis): wire bytes}
    model_flops_global: float
    peak_memory_per_chip: float
    matmul_flops_per_chip: float = 0.0

    @property
    def compute_s(self) -> float:
        """FLOPs per card over the dense bf16 peak."""
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        """Device-memory bytes per card over the HBM rate."""
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        """NVLink time plus network time (a collective on an axis this
        table does not name is priced at the network's rate)."""
        return sum(v / LINK_BW.get(axis, NET_BW)
                   for (_, axis), v in self.coll_breakdown.items())

    @property
    def dominant(self) -> str:
        """The largest of the three terms."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-model step latency: the dominant term binds."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): the recompute and
        redundancy gauge."""
        counted = self.flops_per_chip * self.chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-model step time."""
        denom = self.step_time_s * PEAK_FLOPS_BF16 * self.chips
        return self.model_flops_global / denom if denom else 0.0

    def row(self) -> dict:
        """The cell's JSON row (JAX's keys, plus the per-card counts and
        the collectives by kind and axis)."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "dominant": self.dominant,
            "step_ms": self.step_time_s * 1e3,
            "useful_flops_ratio": self.useful_ratio,
            "mfu_at_roofline": self.mfu,
            "hbm_gb_per_chip": self.peak_memory_per_chip / 2**30,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_breakdown_mb": {f"{kind}@{axis}": v / 2**20
                                  for (kind, axis), v
                                  in sorted(self.coll_breakdown.items())
                                  if v},
        }


def analyze(*, arch, shape, mesh_name, chips, totals, model_flops_global,
            kernel_traffic: float = 0.0) -> Roofline:
    """A Roofline from a counter's ``Totals`` (``roofline/counter.py``):
    its FLOPs, bytes (plus the analytic traffic of the JAX kernel
    regions), collectives and peak live bytes, all rank 0's."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=totals.flops,
        bytes_per_chip=totals.bytes + kernel_traffic,
        coll_bytes_per_chip=totals.coll_bytes,
        coll_breakdown=dict(totals.coll),
        model_flops_global=model_flops_global,
        peak_memory_per_chip=float(totals.peak),
        matmul_flops_per_chip=totals.matmul_flops)


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D train, 2·N·D inference (N = activated params)."""
    n = cfg.activated_params
    return (6.0 if shape_kind == "train" else 2.0) * n * tokens


def _attention_calls(cfg) -> int:
    """Flash-attention invocations per full forward, by family."""
    if cfg.family == "xlstm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // 3            # attention layers only
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers   # enc + dec self + cross
    return cfg.n_layers


def kernel_traffic(cfg, spec, chips: int) -> float:
    """Analytic per-card device-memory bytes of the JAX kernel regions
    (JAX's formulas as written, plus the RG-LRU scan).

    flash: streams Q, K, V once, writes O (+ stats): forward Q+K+V+O; the
    backward reads Q, K, V, O, dO and writes dQ, dK, dV (~2x forward);
    training's recompute replays the forward (~+1x): 4x in training, as
    the port's ``flash`` region covers all three (``layers.
    _FlashAttention``). The interior probability tiles never touch device
    memory: that is the point of the kernel.

    mlstm / slstm (linear-scan kernels): stream q, k, v / z, i, f once
    per sweep, write h once; the recurrent state stays on chip across the
    sweep (chunk-boundary states spill). rglru (no JAX term; JAX's
    pattern names the region but no JAX code opens it): stream a and the
    gated input once, write h once. The port's regions of the three scans
    cover the forward and its recompute but not the backward, which
    autograd runs op by op and the counter charges by its ops: 2x in
    training.
    """
    if spec.kind == "decode":
        return 0.0                          # decode uses flash_decode path
    b, s = spec.global_batch, spec.seq_len
    item = 4                                # fp32 compute in the reference
    flash_factor = 4.0 if spec.kind == "train" else 1.0
    scan_factor = 2.0 if spec.kind == "train" else 1.0
    total = 0.0

    q_bytes = b * s * cfg.n_heads * cfg.head_dim * item
    kv_bytes = 2 * b * s * cfg.n_kv_heads * cfg.head_dim * item
    total += _attention_calls(cfg) * (2 * q_bytes + kv_bytes) * flash_factor

    if cfg.family == "xlstm":
        period = 8
        n_p = cfg.n_layers // period
        h, d_inner = cfg.n_heads, 2 * cfg.d_model
        dh = d_inner // h
        dqk = dh // 2
        per = (b * s * h * (2 * dqk + 2 * dh + 2) * item
               + (s // 64) * b * h * dqk * dh * item)
        total += n_p * (period - 1) * per * scan_factor
        total += n_p * 4 * b * s * cfg.d_model * item * scan_factor
    if cfg.family == "hybrid":
        rec = cfg.n_layers - cfg.n_layers // 3
        r = cfg.lru_width or cfg.d_model
        total += rec * 3 * b * s * r * item * scan_factor
    return total / chips


def save_rows(rows: list[dict], path: str):
    """Write ``rows`` to ``path`` as one JSON list."""
    with open(path, "w") as f:
        json.dump(rows, f, indent=2, default=str)
