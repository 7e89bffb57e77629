"""Atomic, restartable checkpoints (the JAX ``training/checkpoint.py``).

Format, one directory a step::

    step_00000123.tmp/      written first
        manifest.json       step, extra (the pipeline cursor), each leaf's
                            shape and dtype
        arrays.npz          one array a named leaf
    step_00000123/          the rename commits it

A crash during a save never corrupts the newest commit, and ``restore``
takes the newest committed step. ``save`` copies every leaf to the host
before it returns (a CUDA tensor is copied and the copy waited for), so
the training that goes on cannot change the snapshot; the file is written
by a background thread, which ``wait`` (and the next ``save``) joins.

Trees are the port's (dicts, lists, named tuples of tensors), leaves named
by path (``training.tree``). numpy has no bfloat16: a leaf in another
dtype than numpy holds is saved as its fp32 value (exact for bf16 and
fp16) with its own dtype in the manifest, and ``restore`` casts every
array to the dtype and device of the template's leaf.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.training import tree as T

_NUMPY_DTYPES = (torch.float32, torch.float64, torch.int8, torch.int16,
                 torch.int32, torch.int64, torch.uint8, torch.bool)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later changes to ``t`` do not reach."""
    t = t.detach()
    if t.dtype not in _NUMPY_DTYPES:
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None, *,
             blocking: bool = False):
        """Snapshot ``tree`` (and the json-serializable ``extra``) at
        ``step``."""
        named = T.named_leaves(tree)
        host = {k: _host(v) for k, v in named}
        dtypes = {k: str(v.dtype).removeprefix("torch.") for k, v in named}
        self.wait()

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {
                "step": step,
                "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                           for k, v in host.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.committed_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, template_tree, step: int | None = None):
        """Restore into the structure of ``template_tree``, each leaf in
        the template leaf's dtype and on its device. Returns (tree, extra,
        step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [torch.from_numpy(data[k]).to(device=t.device,
                                                    dtype=t.dtype)
                      for k, t in T.named_leaves(template_tree)]
        return T.rebuild(template_tree, leaves), manifest["extra"], step
