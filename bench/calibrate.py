"""Readings for a cell's ``max_logit_gap`` limit: in one process, a whole
run of the cell on each seed (the window at the cell's own load, then the
check), and on the first ``--control`` seeds the control's widest gap on
the same sample (the reference with its products in float8). Run on the
card:

    python3 bench/calibrate.py --workload <cell> --seconds 15 \
        --control 4 --seeds 11 12 13 ...

One JSON line a seed: the program's widest gap, the tokens checked, the
control's widest gap (where read), and ``correct`` under the limit the
mix holds now. The limit is set from these readings by hand (PERF.md).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import check, harness
    real = check.run_check
    for k, seed in enumerate(args.seeds):
        seen: dict = {}

        def spy(cell, weights, done, failed, seed_, dev, k=k, seen=seen):
            out = real(cell, weights, done, failed, seed_, dev)
            if k < args.control:
                recs = check.sample(done, cell.mix["check"], seed_)
                t = time.perf_counter()
                gaps = check.control_gaps(cell.family, cell.config, weights,
                                          recs, dev)
                seen["control_gap"] = max(float(g.max()) for g in gaps)
                seen["control_s"] = time.perf_counter() - t
            return out
        check.run_check = spy
        t = time.perf_counter()
        res = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          "cuda", time.perf_counter())
        check.run_check = real
        row = {"seed": seed, "correct": res["correct"],
               "gap": res["checks"]["max_logit_gap"]["value"],
               "tokens": res["checks"]["tokens_checked"]["value"],
               "failed": res["failed"], "run_s": time.perf_counter() - t,
               "metrics": {k_: v["value"] for k_, v in res["metrics"].items()},
               **seen}
        print(json.dumps(row), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
