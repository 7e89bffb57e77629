"""Fixtures of the benchmark's CPU tests: a throwaway benchmark root (a
copy of ``bench/`` and a ``BENCHMARK.json`` with tiny cells only) that the
harness runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"family": "dense", "hidden_size": 128, "intermediate_size": 256,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "vocab_size": 512, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "torch_dtype": "float32"}


def tiny_configs(dtype: str = "float32") -> dict:
    """A windowed config on the ring and a paged one, at smoke size."""
    return {
        "tiny-ring": dict(TINY, torch_dtype=dtype, sliding_window=32,
                          serving={"slots": 4, "max_seq": 256,
                                   "paged": False}),
        "tiny-paged": dict(TINY, torch_dtype=dtype,
                           serving={"slots": 4, "max_seq": 256,
                                    "paged": True, "page_size": 16,
                                    "num_pages": 48, "prefix_cache": True})}


def tiny_mixes(limit: float, min_tokens: int = 10) -> dict:
    chk = {"requests": 16, "min_tokens": min_tokens, "max_logit_gap": limit}
    return {
        "tiny-open": {"loop": "open", "rate_per_s": 25, "lead_s": 0.3,
                      "check": chk,
                      "prompt": {"median": 40, "sigma": 0.5, "min": 16,
                                 "max": 90},
                      "output": {"median": 10, "sigma": 0.5, "min": 4,
                                 "max": 24}},
        "tiny-closed": {"loop": "closed", "clients": 6,
                        "check": chk,
                        "prompt": {"median": 30, "sigma": 0.5, "min": 16,
                                   "max": 80},
                        "output": {"median": 16, "sigma": 0.5, "min": 4,
                                   "max": 40}}}


def make_root(path: Path, dtype: str = "float32", limit: float = 1e-3,
              min_tokens: int = 10) -> Path:
    """A benchmark root at ``path``: the repository's ``bench/`` copied,
    tiny configurations and mixes added as new files, and a
    ``BENCHMARK.json`` whose cells are ``tiny-open`` (ring) and
    ``tiny-closed`` (paged)."""
    shutil.copytree(REPO / "bench", path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in tiny_configs(dtype).items():
        (path / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
    for name, mix in tiny_mixes(limit, min_tokens).items():
        (path / "bench" / "mixes" / f"{name}.json").write_text(
            json.dumps(mix))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [
        {"name": n, "source": "test", "file": f"bench/configs/{n}.json",
         "reduced": []} for n in tiny_configs()]
    spec["workloads"] = [
        {"name": "tiny-open", "config": "tiny-ring", "traffic": "tiny-open",
         "chips": 1, "why": "test"},
        {"name": "tiny-closed", "config": "tiny-paged",
         "traffic": "tiny-closed", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            closed = m["name"] == "out_tok_s" or m.get("moves") == "out_tok_s"
            m["workloads"] = ["tiny-closed" if closed else "tiny-open"]
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return path


@pytest.fixture(autouse=True)
def few_threads():
    """Two CPU threads a test: the suite runs in several workers, and the
    harness measures windows of wall time."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
