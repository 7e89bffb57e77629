"""Device choice for the port's entry points.

The port serves on the GPU. A caller who wants the plain PyTorch versions
on the CPU says so with ``device="cpu"``; nothing falls back to the CPU
on its own.
"""

from __future__ import annotations

import torch

# streaming multiprocessors of the H100 SXM, and what one SM holds at once
SMS = 132
MAX_THREADS = 1024                  # per block
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
SMEM_PER_BLOCK = 232_448            # shared memory bytes a block (227 KB)
SMEM_PER_SM = 233_472               # shared memory bytes an SM (228 KB)
SMEM_RESERVED = 1_024               # of it, held back for each block


def resident_blocks_smem(threads: int, smem: int, cap: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    the card holds at once, at most ``cap`` an SM (a kernel's launch
    bounds)."""
    by_smem = SMEM_PER_SM // (smem + SMEM_RESERVED)
    return SMS * max(1, min(cap, MAX_BLOCKS_PER_SM,
                            MAX_THREADS_PER_SM // threads, by_smem))


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
