"""Quickstart on the PyTorch port: optimize one production kernel with the
Astra multi-agent loop (Algorithm 1) and reintegrate it into the
framework.

On the card (the default device; the profiling agent times every genome
with CUDA events):
    PYTHONPATH=src python examples/torch/quickstart.py
On the CPU (the plain PyTorch versions and the analytic H100 cost model):
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu \\
        --rounds 1
"""
import argparse

import torch

from repro_torch.core import optimize, reintegrate
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--rounds", type=int, default=5)
args = ap.parse_args()
dev = resolve_device(args.device)

# 1. Run Algorithm 1 on the SwiGLU kernel (paper Kernel 3): the testing
#    agent builds a production-shape suite, the profiling agent times it
#    on the card (or evaluates the H100 cost model on the CPU), the
#    planning agent attacks the dominant roofline term, the coding agent
#    applies the knob moves.
log = optimize("silu_and_mul", rounds=args.rounds, verbose=True, device=dev)
print()
print(log.table())
print(f"\nspeedup over baseline: {log.speedup():.2f}x")

# 2. Reintegrate (paper §3.2 post-processing): the tuned variant becomes
#    the framework-wide kernel; every model's MLP now launches it.
reintegrate({"silu_and_mul": log})
print(f"installed: {ops.get_variant('silu_and_mul').describe()}")

# 3. Use it through the public op (the CUDA kernel on the card, its plain
#    version on the CPU).
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randn((8, 1024), generator=gen, device=dev).to(torch.bfloat16)
y = ops.silu_and_mul(x)
print(f"silu_and_mul({tuple(x.shape)}) -> {tuple(y.shape)} {y.dtype} "
      f"on {y.device}")
