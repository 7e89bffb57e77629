"""Long-context (500k) decode on the PyTorch port: the bounded KV cache or
recurrent state of the three sub-quadratic architectures, and split-KV
decode whose per-shard partials come from the ``flash_decode`` kernel
(kernel 5) and are merged by ``merge_attn_states_lse`` (paper Kernel 1,
kernel 4).

On the card (the default device):
    PYTHONPATH=src python examples/torch/long_context_decode.py
On the CPU (the kernels' plain versions):
    PYTHONPATH=src python examples/torch/long_context_decode.py \\
        --device cpu --seq 512
"""
import argparse
import math

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import registry

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--seq", type=int, default=4096,
                help="rows of the split-KV decode's cache")
args = ap.parse_args()
dev = resolve_device(args.device)

print("== bounded decode state at seq_len=524288 ==")
for arch in ("h2o-danube-1.8b", "xlstm-1.3b", "recurrentgemma-2b"):
    cfg = configs.get(arch)
    spec, _ = registry.cache_spec(cfg, 1, 524288)
    total = sum(math.prod(shape) * dtype.itemsize
                for shape, dtype in spec.values())
    print(f"{arch:<22} cache/state = {total} B ({total / 2**30:.2f} GiB; "
          f"window={cfg.window}, family={cfg.family})")

print("\n== split-KV decode: per-shard partials merged with Kernel 1 ==")
b, hq, hkv, dh, s = 2, 8, 2, 64, args.seq
gen = torch.Generator(device=dev).manual_seed(0)
q = torch.randn((b, hq, dh), generator=gen, device=dev)
k = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
v = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
full = ops.flash_decode_attention(q, k, v)
n_shards = 8
parts = []
for i in range(n_shards):
    sl = slice(i * s // n_shards, (i + 1) * s // n_shards)
    parts.append(ops.flash_decode_attention(
        q, k[:, sl].contiguous(), v[:, sl].contiguous(), return_lse=True))
o, lse = parts[0]
for o2, lse2 in parts[1:]:
    o, lse = ops.merge_attn_states_lse(o, lse, o2, lse2)
err = float((o - full).abs().max())
print(f"{n_shards}-shard tree-merge vs monolithic decode: "
      f"max|err| = {err:.2e}")
assert err < 1e-4, err
print("sequence-parallel decode is exact: the paper's kernel is the "
      "distributed combiner.")
