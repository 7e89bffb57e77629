"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for, and prints the result object as the last line of standard
output; the numbers compared for ``correct`` end standard error. Build
and kernel caches stay inside the checkout (``build/``). It exits with a
code other than 0, printing no result, where CUDA is missing, where the
cell asks for more cards than there are, where the program
(``src/repro_torch``) is absent, and where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench" / "cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips[args.workload]:
        print(f"needs {chips[args.workload]} CUDA device(s); found {cards}",
              file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 4
    from bench import harness
    res = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_PROC0)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 5
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
