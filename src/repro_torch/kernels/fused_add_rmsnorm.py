"""Fused residual add + RMSNorm: the Hopper kernel and its wrapper.

The kernel is ``csrc/fused_add_rmsnorm.cu`` (it replaces the TPU kernel
``repro/kernels/fused_add_rmsnorm.py::fused_add_rmsnorm``); the plain
version is ``ref.fused_add_rmsnorm``. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def fused_add_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6):
    """Returns ``(y, x + residual)`` for ``x``, ``residual`` of shape
    ``[..., d]`` and ``weight`` of shape ``[d]``."""
    if x.device.type == "cpu":
        return ref.fused_add_rmsnorm(x, residual, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_add_rmsnorm runs on cpu or cuda, not "
                         f"{x.device}")
    d = x.shape[-1]
    if residual.shape != x.shape or residual.dtype != x.dtype:
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype}"
                         f" does not match x {tuple(x.shape)} {x.dtype}")
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    if not (x.is_contiguous() and residual.is_contiguous()):
        raise ValueError("fused_add_rmsnorm needs contiguous x and residual")
    if not (residual.device == weight.device == x.device):
        raise ValueError("x, residual and weight must share one device")
    w = weight.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    r_out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y, r_out
    vec = _build.vector_width(d, x, residual, y, r_out)
    n_vec = -(-d // vec)         # one vector per thread, whole warps
    threads = min(1024, -(-n_vec // 32) * 32)
    lib = _build.library()
    code = lib.repro_fused_add_rmsnorm(
        x.data_ptr(), residual.data_ptr(), w.data_ptr(), y.data_ptr(),
        r_out.data_ptr(), rows, d, float(eps), _build.dtype_code(x), vec,
        threads, _build.stream_ptr(x.device))
    _build.check(lib, code, "fused_add_rmsnorm")
    fused_add_rmsnorm.launches += 1
    return y, r_out


fused_add_rmsnorm.launches = 0
