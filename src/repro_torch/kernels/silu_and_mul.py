"""SwiGLU gate ``silu(x[..., :d]) * x[..., d:]``: the Hopper kernel and its
wrapper.

The kernel is ``csrc/silu_and_mul.cu`` (it replaces the TPU kernel
``repro/kernels/silu_and_mul.py::silu_and_mul``); the plain version is
``ref.silu_and_mul``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """``[..., 2d] -> [..., d]``."""
    if x.device.type == "cpu":
        return ref.silu_and_mul(x)
    if x.device.type != "cuda":
        raise ValueError(f"silu_and_mul runs on cpu or cuda, not {x.device}")
    if x.shape[-1] % 2:
        raise ValueError(f"last dim {x.shape[-1]} is not 2 * d")
    if not x.is_contiguous():
        raise ValueError("silu_and_mul needs a contiguous input")
    d = x.shape[-1] // 2
    out = torch.empty(*x.shape[:-1], d, dtype=x.dtype, device=x.device)
    rows = out.numel() // d if d else 0
    if rows == 0:
        return out
    vec = _build.vector_width(d, x, out)
    lib = _build.library()
    code = lib.repro_silu_and_mul(x.data_ptr(), out.data_ptr(), rows, d,
                                  _build.dtype_code(x), vec,
                                  _build.stream_ptr(x.device))
    _build.check(lib, code, "silu_and_mul")
    silu_and_mul.launches += 1
    return out


silu_and_mul.launches = 0
