"""Back-compat shim: kernel optimization spaces live with their kernels.

The counterpart of ``repro/core/variants.py``: it re-exports the registry
of ``repro_torch.kernels.registry`` under the names the agents import.
"""

from __future__ import annotations

from repro_torch.kernels.registry import (SPACES, KernelSpace, Knob,
                                          TestCase, get_space, make_inputs,
                                          register_kernel_space,
                                          registered_kernels)

__all__ = [
    "SPACES", "KernelSpace", "Knob", "TestCase", "get_space", "make_inputs",
    "register_kernel_space", "registered_kernels",
]
