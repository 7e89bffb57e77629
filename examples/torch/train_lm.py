"""End-to-end training driver on the PyTorch port: train a reduced
qwen2-class LM with the full substrate (microbatched gradient
accumulation, AdamW, async checkpoints, the restartable data pipeline, a
straggler watchdog) and an injected mid-run failure to show
checkpoint/restart recovery. Checkpoints go to a temporary directory.

On the card (the default device):
    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300]
On the CPU:
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu \\
        --steps 4
"""
import argparse
import tempfile

from repro_torch.launch.train import run

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--arch", default="qwen2-0.5b")
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

with tempfile.TemporaryDirectory() as ckpt:
    out = run(arch=args.arch, smoke=True, steps=args.steps, batch=8,
              seq=128, microbatches=2, ckpt_dir=ckpt,
              ckpt_every=max(args.steps // 4, 1),
              fail_at=args.steps // 2,        # injected failure mid-run
              lr=1e-3, device=args.device)
losses = out["losses"]
k = max(len(losses) // 10, 1)
print(f"\nloss: first-{k}-avg {sum(losses[:k])/k:.4f} -> "
      f"last-{k}-avg {sum(losses[-k:])/k:.4f} "
      f"({len(losses)} post-restart steps, "
      f"{len(out['flagged_steps'])} straggler flags)")
print("survived one injected failure via checkpoint/restart.")
