"""Hopper kernels of the port, their genomes and their plain versions.

Each kernel module holds the wrapper of one CUDA kernel from ``csrc/``
(with its launch count) and, where the agent loop tunes it, its genome,
its plain per-genome version, its cost and its registered search space;
``ref.py`` holds the plain versions of every kernel contract;
``registry.py`` the spaces; ``ops.py`` is the dispatch the models call;
``_build.py`` builds and loads the CUDA library at first use. Importing
the package registers every space.
"""

from repro_torch.kernels import flash_decode  # noqa: F401
from repro_torch.kernels import fused_add_rmsnorm  # noqa: F401
from repro_torch.kernels import merge_attn_states  # noqa: F401
from repro_torch.kernels import ops  # noqa: F401
from repro_torch.kernels import ref  # noqa: F401
from repro_torch.kernels import registry  # noqa: F401
from repro_torch.kernels import silu_and_mul  # noqa: F401
