"""PyTorch/CUDA port of the Astra reproduction, for an NVIDIA H100.

Mirrors the layout of the JAX package (``configs``, ``kernels``,
``models``, ``serving``) module for module, so each module here has a
counterpart of the same name there. The port imports ``torch`` only; the
kernels on its serving path are CUDA C++ written for Hopper (``sm_90a``)
under ``kernels/csrc``, built with ``nvcc`` at first use and loaded with
``ctypes``.

Entry points (``serving.LLMEngine``, ``serving.Engine``,
``models.registry.init_params``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU device they raise.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
