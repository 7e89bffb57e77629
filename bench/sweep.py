"""Find the highest arrival rate an open-loop cell sustains: one engine,
one warm-up, then each rate in turn for ``--seconds``, served by the
harness's own loop (``harness.Run.serve``), the engine drained between
rates. Run on the card, once, when a cell's rate is chosen; list a rate
twice to read it twice (each reading starts the block elsewhere):

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds 30 \
        --rates 1.5 1.5 2 2 2.5 2.5

For each rate it prints the requests offered, admitted and finished per
second, the queue (waiting requests) at the start and end of the second
half, its growth per second (the least-squares slope over the second
half), and the 90th-percentile time to first token. A rate is sustained
where the queue does not grow.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    from bench.accounting import percentile
    from bench.traffic import Traffic
    cell = harness.Cell.load(ROOT, args.workload)
    run = harness.Run(cell, args.seed, args.seconds, False, "cuda")
    run.warm()
    eng = run.eng
    for k, rate in enumerate(args.rates):
        mix = dict(cell.mix, rate_per_s=rate)
        run.traffic = Traffic(mix, args.seed + k, run.traffic.vocab,
                              run.traffic.max_seq)
        run._feed, run._next_item = False, 0
        first = len(run.recs)
        samples = []
        t = time.perf_counter()
        t_end = t + args.seconds
        run.serve(t, t_end, t_end,
                  lambda now, t=t: samples.append((now - t,
                                                   len(eng.scheduler))))
        recs = list(run.recs.values())[first:]
        half = np.array([(s, q) for s, q in samples
                         if s >= args.seconds / 2], dtype=float)
        growth = float(np.polyfit(half[:, 0], half[:, 1], 1)[0]) \
            if len(half) > 1 else 0.0
        ttft = [(r.tokens[0] if r.tokens else t_end) - r.due for r in recs]
        row = {"rate": rate, "offered_per_s": len(recs) / args.seconds,
               "admitted_per_s": sum(bool(r.tokens) for r in recs)
               / args.seconds,
               "finished_per_s": sum(r.done is not None and r.done < t_end
                                     for r in recs) / args.seconds,
               "queue_mid": int(half[0, 1]) if len(half) else 0,
               "queue_end": int(half[-1, 1]) if len(half) else 0,
               "queue_growth_per_s": growth,
               "ttft_p90_ms": percentile(ttft, 90) * 1e3}
        print(json.dumps(row), flush=True)
        while eng.has_work():
            run._step(False)
        eng.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
