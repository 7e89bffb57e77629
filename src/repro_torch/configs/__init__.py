"""Configs of the architectures the port serves so far.

``get(name)`` takes the assignment id (dashes); ``smoke(name)`` returns the
reduced same-family config the CPU tests use.
"""

from repro_torch.configs import (chameleon_34b, granite_moe_3b_a800m,
                                h2o_danube_1_8b, olmoe_1b_7b, qwen2_0_5b,
                                qwen3_8b, recurrentgemma_2b, yi_34b)
from repro_torch.configs.base import ModelConfig

_MODULES = {"qwen2-0.5b": qwen2_0_5b, "h2o-danube-1.8b": h2o_danube_1_8b,
            "granite-moe-3b-a800m": granite_moe_3b_a800m,
            "olmoe-1b-7b": olmoe_1b_7b, "qwen3-8b": qwen3_8b,
            "yi-34b": yi_34b, "chameleon-34b": chameleon_34b,
            "recurrentgemma-2b": recurrentgemma_2b}

CONFIGS = {k: m.CONFIG for k, m in _MODULES.items()}


def get(name: str) -> ModelConfig:
    """Full-width config of ``name``."""
    return CONFIGS[name]


def smoke(name: str) -> ModelConfig:
    """Reduced config of ``name`` for CPU tests."""
    return _MODULES[name].smoke()
