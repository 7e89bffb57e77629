"""Reproduce the paper end to end on the PyTorch port: optimize the SGLang
kernels with the multi-agent system, compare with the single-agent
baseline (Table 3), and print the per-round optimization trajectories
(the case-study data behind the paper's §5.3); then go beyond Algorithm 1
with the pluggable search strategies (beam) sharing one memoized
evaluation cache.

On the card (the default device; genomes timed with CUDA events, the
final comparison at the paper's 100 reps):
    PYTHONPATH=src python examples/torch/optimize_kernels.py
On the CPU (the analytic H100 cost model, the comparison at 10**6 reps
of its noise model):
    PYTHONPATH=src python examples/torch/optimize_kernels.py \\
        --device cpu --rounds 1
"""
import argparse

import numpy as np

from repro_torch.core import (SPACES, ProfilingAgent, TestingAgent,
                              optimize_single_agent, reintegrate)
from repro_torch.device import resolve_device
from repro_torch.search import BeamSearch, EvalCache, SearchOrchestrator

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--rounds", type=int, default=5)
args = ap.parse_args()
dev = resolve_device(args.device)
rounds = args.rounds

# One orchestrator = one evaluation cache: every genome any strategy
# visits is validated and profiled at most once, process-wide.
cache = EvalCache()
orch = SearchOrchestrator(cache=cache, device=dev)
kernels = ("merge_attn_states_lse", "fused_add_rmsnorm", "silu_and_mul")

results = {k: orch.search(k, strategy="greedy", rounds=rounds)
           for k in kernels}
hifi = ProfilingAgent(reps=100 if dev.type == "cuda" else 10**6)
tester = TestingAgent(device=dev)

print(f"{'kernel':<24}{'base us':>9}{'MA us':>9}{'MA':>7}{'SA':>7}")
mas, sas = [], []
for name, log in results.items():
    space = SPACES[name]
    tests = tester.generate_tests(space)
    base = hifi.profile(space, space.baseline, tests).geomean_latency_us
    ma = hifi.profile(space, log.best().code, tests).geomean_latency_us
    sa_log = optimize_single_agent(name, rounds=rounds, device=dev)
    sa = hifi.profile(space, sa_log.final_variant, tests).geomean_latency_us
    mas.append(base / ma)
    sas.append(base / sa)
    print(f"{name:<24}{base:>9.2f}{ma:>9.2f}{base/ma:>6.2f}x{base/sa:>6.2f}x")
print(f"{'geomean':<24}{'':>9}{'':>9}"
      f"{np.exp(np.mean(np.log(mas))):>6.2f}x"
      f"{np.exp(np.mean(np.log(sas))):>6.2f}x")
print("\npaper: MA 1.26/1.25/1.46 (avg 1.32x); SA 0.73/1.18/1.48 "
      "(avg 1.08x)\n")

for name, log in results.items():
    print(f"=== trajectory: {name} ===")
    print(log.table())
    print()

# Beam search re-walks the greedy path through the cache (hits) and spends
# its width on the moves Algorithm 1 never tries.
print("=== beam search (width=4), sharing the evaluation cache ===")
for name in kernels:
    beam = orch.search(name, strategy=BeamSearch(width=4), rounds=rounds)
    best = beam.best()
    c = beam.meta["cache"]
    print(f"{name:<24} best {best.perf.geomean_latency_us:>8.2f}us  "
          f"genomes={c['misses']} cache_hits={c['hits']}")
print(f"cache: {cache.stats()}\n")

reintegrate(results)
print("tuned variants reintegrated into the serving/training framework.")
