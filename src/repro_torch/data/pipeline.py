"""Synthetic, deterministic, restartable data pipeline (the JAX
``data/pipeline.py``).

Every batch is a function of (seed, step, shard) alone, drawn with numpy
exactly as JAX's ``_batch_np`` draws it, so a restarted run resumes from
the checkpointed cursor with no batch lost or repeated, and the port and
the JAX package see the same tokens. A background thread keeps
``prefetch`` batches ready on the host; ``next`` moves one to the
pipeline's device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class Cursor:
    """Checkpointable pipeline position."""
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["seed"]), int(d["step"]))


def _batch_np(cfg: ModelConfig, batch: int, seq: int, seed: int, step: int,
              shard: int = 0, n_shards: int = 1):
    """Deterministic synthetic batch for (seed, step, shard)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step) * 131
                                + np.uint64(shard))
    local = batch // n_shards
    tokens = rng.integers(0, cfg.vocab, (local, seq), dtype=np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "frames":
        out["frames"] = rng.standard_normal(
            (local, seq, cfg.d_model)).astype(np.float32)
    return out


class Pipeline:
    """Sharded, prefetching, restartable loader; batches land on
    ``device``."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1, prefetch: int = 2, device="cpu"):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.device = torch.device(device)
        self.cursor = Cursor(seed, start_step)
        self.shard, self.n_shards = shard, n_shards
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.cursor.step
        while not self._stop.is_set():
            b = _batch_np(self.cfg, self.batch, self.seq, self.cursor.seed,
                          step, self.shard, self.n_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, b = self._q.get()
        self.cursor.step = step + 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in b.items()}

    def close(self):
        self._stop.set()

    # restart support ------------------------------------------------------
    def state_dict(self):
        return self.cursor.to_dict()

    @classmethod
    def restore(cls, cfg, batch, seq, state, **kw):
        c = Cursor.from_dict(state)
        return cls(cfg, batch, seq, seed=c.seed, start_step=c.step, **kw)
