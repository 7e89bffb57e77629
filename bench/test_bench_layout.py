"""A later change adds a configuration, a mix, a per-layer metric and a
roofline role as new files and entries only: the harness runs the new
cell from them with no existing file edited."""

import json
import time

from bench import harness


def test_a_cell_made_only_of_new_files_runs(tiny_root):
    root = tiny_root
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "bench/configs/tiny-ring.json").read_text())
    cfg["num_hidden_layers"] = 3
    (root / "bench/configs/tiny-new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "bench/mixes/tiny-closed.json").read_text())
    mix["clients"] = 5
    (root / "bench/mixes/tiny-new-mix.json").write_text(json.dumps(mix))
    (root / "bench/metrics/finished_share.py").write_text(
        "def read(ctx):\n"
        "    done = [r for r in ctx.recs if r.reason == 'done']\n"
        "    return 100.0 * len(done) / len(ctx.recs) if ctx.recs else None\n")
    (root / "bench/kernels/new_role").mkdir()
    (root / "bench/kernels/new_role/impl.txt").write_text("some_kernel\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-new", "source": "test",
                            "file": "bench/configs/tiny-new.json",
                            "reduced": ["num_hidden_layers"]})
    spec["workloads"].append({"name": "tiny-new", "config": "tiny-new",
                              "traffic": "tiny-new-mix", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tiny-new")
    for m in spec["per_layer"]:
        if m["name"] == "decode_step_ms.tok":
            m["workloads"].append("tiny-new")
    spec["per_layer"].append({"name": "finished_share.tok", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine", "moves": "out_tok_s",
                              "workloads": ["tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in before}
    assert after == before       # nothing that was there changed

    cell = harness.Cell.load(root, "tiny-new")
    assert cell.kernel_roles()["new_role"] == ["some_kernel"]
    res = harness.run(root, "tiny-new", 2**31 + 3, 2.0, False, "cpu",
                      time.perf_counter())
    assert set(res["metrics"]) == {"out_tok_s", "setup_s"}
    assert res["correct"], res["checks"]
    res = harness.run(root, "tiny-new", 4, 2.0, True, "cpu",
                      time.perf_counter())
    assert set(res["metrics"]) == {"finished_share.tok",
                                   "decode_step_ms.tok"}
    assert list(res)[-1] == "checks"
