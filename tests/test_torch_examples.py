"""The port's five examples (``examples/torch/``) on the CPU, each at its
smallest size with ``--device cpu``: each exits 0 and prints what its
steps promise (the tuned kernel installed, three serves' JSON lines, a
restart from a checkpoint, the split-KV merge within 1e-4, the Table 3
comparison and the beam search)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


def _example(name, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch" / f"{name}.py"),
         "--device", "cpu", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_quickstart():
    out = _example("quickstart", "--rounds", "1")
    assert "speedup over baseline" in out
    assert "installed: silu_and_mul@" in out
    assert "silu_and_mul((8, 1024)) -> (8, 512) torch.bfloat16 on cpu" in out


def test_serve_lm():
    out = _example("serve_lm", "--smoke")
    runs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert len(runs) == 3
    assert all(r["all_done"] and r["steps"] == r["readbacks"] for r in runs)
    assert runs[1]["sampling_step"] and not runs[0]["sampling_step"]
    assert runs[2]["num_pages"] == 8 and runs[2]["scheduler"] == "priority"


def test_train_lm():
    out = _example("train_lm", "--steps", "4")
    assert "[restore] resumed from step 2" in out
    assert "survived one injected failure" in out


def test_long_context_decode():
    out = _example("long_context_decode", "--seq", "512")
    assert "8-shard tree-merge vs monolithic decode" in out
    for arch in ("h2o-danube-1.8b", "xlstm-1.3b", "recurrentgemma-2b"):
        assert arch in out


def test_optimize_kernels():
    out = _example("optimize_kernels", "--rounds", "1")
    assert "geomean" in out and "beam search (width=4)" in out
    assert "tuned variants reintegrated" in out
