"""What the harness and the reference load, compared by whole top-level
module names: no run loads ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (the port's name, ``repro_torch``, merely begins with
it), and the reference loads nothing of the port."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _run(code: str, tmp_path) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import json, sys, time, torch
torch.set_num_threads(2)
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}, {str(BENCH)!r}]
from conftest import make_root
from bench import harness
from pathlib import Path
root = make_root(Path({str(tmp_path)!r}))
for cell, trace in (("tiny-open", True), ("tiny-closed", False)):
    res = harness.run(root, cell, 5, 2.0, trace, "cpu", time.perf_counter())
    assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _run(code, tmp_path)
    assert "repro_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    code = f"""
import json, sys
sys.path[:0] = [{str(REPO)!r}]
from bench import check
from bench.accounting import Rec
from bench.harness import load_module
fam = load_module(__import__("pathlib").Path({str(BENCH)!r}) / "families"
                  / "dense.py", "fam")
c = {{"family": "dense", "hidden_size": 64, "intermediate_size": 96,
     "num_hidden_layers": 2, "num_attention_heads": 4,
     "num_key_value_heads": 2, "vocab_size": 256, "sliding_window": 16,
     "rms_norm_eps": 1e-5, "torch_dtype": "float32"}}
w = fam.draw_weights(c, 1, "cpu")
class R: prompt = list(range(40)); out_tokens = [1, 2, 3]
check.served_gaps(fam, c, w, [Rec(0, 40, 3, 0.0, req=R)], "cpu")
check.control_gaps(fam, c, w, [Rec(0, 40, 3, 0.0, req=R)], "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _run(code, tmp_path)
    assert "torch" in top
    assert not top & (FORBIDDEN | {"repro_torch"})


def test_no_bench_source_imports_jax_the_jax_package_or_its_benchmark():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & (FORBIDDEN | {"benchmarks"}), (path, names)
        if path.parent.name == "families":
            assert "repro_torch" not in names, path
