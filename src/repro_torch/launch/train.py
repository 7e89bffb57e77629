"""Training command of the port (the JAX ``launch/train.py``): config ->
fp32 master weights -> the microbatched train step (optionally with
compressed gradients) -> the synthetic restartable pipeline -> async
checkpoints -> the straggler watchdog -> a heartbeat -> restart from the
newest commit after a failure (``--fail-at`` injects one, for drills).

On the CPU, at the reduced config:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 20 --fail-at 8
On the card (the default device), qwen2-0.5b at full width:
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 8 \
        --batch 8 --seq 1024 --microbatches 2 --fail-at 6

A step's line gives the loss, the learning rate, the gradient norm and
the step's wall time (the batch fetch, the step and its readback). The
run refuses ``cuda`` when no card is visible; it never falls back to the
CPU.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import configs
from repro_torch.data.pipeline import Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.fault_tolerance import (FailureInjector, Heartbeat,
                                                  StragglerWatchdog,
                                                  run_with_restarts)
from repro_torch.training.train_step import (TrainConfig, init_state,
                                             make_train_step)

CKPT_DIR = "build/train_ckpt"


def train_once(*, cfg, tcfg: TrainConfig, steps: int, batch: int, seq: int,
               ckpt_dir: str, ckpt_every: int = 10, seed: int = 0,
               injector: FailureInjector | None = None, log_every: int = 10,
               verbose: bool = True, device=None, history=None):
    """One training attempt on ``device`` (default ``cuda``); resumes from
    the newest committed checkpoint. ``history``, a list, gets ``(step,
    loss, seconds)`` of every step run, across attempts."""
    dev = resolve_device(device)
    ckpt = Checkpointer(ckpt_dir)
    params = registry.init_master_params(cfg, seed=seed, device=dev)
    state = init_state(cfg, tcfg, params)
    start_step = 0
    pipe_state = {"seed": seed, "step": 0}

    latest = ckpt.latest_step()
    if latest is not None:
        (params, state), extra, start_step = ckpt.restore((params, state))
        pipe_state = extra.get("pipeline", pipe_state)
        if verbose:
            print(f"[restore] resumed from step {start_step}")

    pipe = Pipeline(cfg, batch, seq, seed=pipe_state["seed"],
                    start_step=pipe_state["step"], device=dev)
    step_fn = make_train_step(cfg, tcfg)
    watchdog = StragglerWatchdog()
    heart = Heartbeat(ckpt_dir + "/heartbeat.json")
    losses, ran, step_s = [], [], []

    try:
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            data = pipe.next()
            if injector is not None:
                injector.maybe_fail(step)
            params, state, metrics = step_fn(params, state, data)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            ran.append(step)
            step_s.append(dt)
            if history is not None:
                history.append((step, loss, dt))
            slow = watchdog.observe(step, dt)
            heart.beat(step)
            if verbose and (step % log_every == 0 or slow):
                print(f"step {step:>5} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt*1e3:.0f}ms{'  [STRAGGLER]' if slow else ''}",
                      flush=True)
            if (step + 1) % ckpt_every == 0 or step + 1 == steps:
                ckpt.save(step + 1, (params, state),
                          extra={"pipeline": pipe.state_dict()})
    finally:
        pipe.close()
        ckpt.wait()
    return {"params": params, "state": state, "losses": losses,
            "steps": ran, "step_s": step_s,
            "flagged_steps": watchdog.flagged_steps}


def run(*, arch: str, smoke: bool = True, steps: int = 40, batch: int = 8,
        seq: int = 128, microbatches: int = 1, compress: bool = False,
        ckpt_dir: str = CKPT_DIR, ckpt_every: int = 10,
        fail_at: int | None = None, max_restarts: int = 2, lr: float = 3e-4,
        seed: int = 0, log_every: int = 10, verbose: bool = True,
        device=None, history=None):
    """Train ``arch`` (its reduced config with ``smoke``) for ``steps``
    steps, restarting from the newest commit after a failure. Returns the
    last attempt's ``train_once`` result."""
    dev = resolve_device(device)
    cfg = configs.smoke(arch) if smoke else configs.get(arch)
    tcfg = TrainConfig(
        microbatches=microbatches, compress_grads=compress,
        adamw=opt.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                              total_steps=steps))
    injector = FailureInjector(fail_at)

    def attempt():
        return train_once(cfg=cfg, tcfg=tcfg, steps=steps, batch=batch,
                          seq=seq, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                          injector=injector, seed=seed, log_every=log_every,
                          verbose=verbose, device=dev, history=history)

    def on_restart(n, e):
        if verbose:
            print(f"[fault-tolerance] attempt {n} after: {e} -- restarting "
                  f"from latest committed checkpoint", flush=True)

    return run_with_restarts(attempt, max_restarts=max_restarts,
                             on_restart=on_restart)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(arch=args.arch, smoke=args.smoke, steps=args.steps,
              batch=args.batch, seq=args.seq,
              microbatches=args.microbatches, compress=args.compress_grads,
              ckpt_dir=args.ckpt_dir, fail_at=args.fail_at, lr=args.lr,
              device=args.device)
    if not out["losses"]:
        print(f"nothing to run: {args.ckpt_dir} holds a commit at step "
              f"{args.steps} or later")
        return
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}) over {len(out['losses'])} steps")


if __name__ == "__main__":
    main()
