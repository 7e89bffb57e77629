"""Serve a model through the port's layered serving API: ``LLMEngine`` over
the continuous-batching engine, one decode step (a CUDA graph replay on
the card) per token with the draw on the device, pluggable admission
scheduling, and the paged KV pool read by the paged decode kernel.

Three runs, each one JSON line of serving metrics:
1. greedy FCFS, the baseline configuration;
2. seeded sampling (temperature 0.8, top-p 0.95), still one batched host
   readback per step, reproducible per seed;
3. an oversubscribed paged pool (8 pages x 16 rows against 3 slots x 128
   positions) under priority scheduling: admission queues on free pages
   and the engine preempts and swaps the youngest occupant.

On the card (qwen2-0.5b at full width, seeded random weights):
    PYTHONPATH=src python examples/torch/serve_lm.py
On the CPU (the reduced config):
    PYTHONPATH=src python examples/torch/serve_lm.py --device cpu --smoke
"""
import argparse

from repro_torch.launch import serve

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--smoke", action="store_true",
                help="the reduced config instead of full width")
args = ap.parse_args()
common = ["--arch", "qwen2-0.5b", "--slots", "3", "--max-seq", "128",
          "--min-prompt", "4"] + (["--device", args.device]
                                  if args.device else []) \
    + (["--smoke"] if args.smoke else [])

serve.main(common + ["--requests", "6", "--max-new", "8",
                     "--max-prompt", "16"])

print("\n--- seeded sampling (temperature 0.8, top-p 0.95) ---")
serve.main(common + ["--requests", "6", "--max-new", "8",
                     "--max-prompt", "16", "--temperature", "0.8",
                     "--top-p", "0.95", "--sampling-seed", "7"])

print("\n--- oversubscribed paged pool, priority admission ---")
serve.main(common + ["--requests", "8", "--max-new", "24",
                     "--max-prompt", "48", "--num-pages", "8",
                     "--scheduler", "priority"])
