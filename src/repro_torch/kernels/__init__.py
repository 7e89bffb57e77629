"""Hopper kernels of the port and their plain PyTorch versions.

Each kernel module holds the wrapper of one CUDA kernel from ``csrc/``
(with its launch count); ``ref.py`` holds the plain versions of every
kernel contract; ``ops.py`` is the dispatch the models call; ``_build.py``
builds and loads the CUDA library at first use.
"""

from repro_torch.kernels import flash_decode  # noqa: F401
from repro_torch.kernels import fused_add_rmsnorm  # noqa: F401
from repro_torch.kernels import ops  # noqa: F401
from repro_torch.kernels import ref  # noqa: F401
from repro_torch.kernels import silu_and_mul  # noqa: F401
