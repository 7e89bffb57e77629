"""Configs of every architecture of the JAX package.

``get(name)`` takes the assignment id (dashes); ``smoke(name)`` returns the
reduced same-family config the CPU tests use; ``long_context_ok`` says
which run the 500k-token cell, ``cells_for`` which of the dry run's
``SHAPES`` a config runs.
"""

from repro_torch.configs import (chameleon_34b, granite_moe_3b_a800m,
                                h2o_danube_1_8b, olmoe_1b_7b, qwen2_0_5b,
                                qwen3_8b, recurrentgemma_2b,
                                seamless_m4t_large_v2, xlstm_1_3b, yi_34b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                     cells_for, long_context_ok)

_MODULES = {"qwen2-0.5b": qwen2_0_5b, "yi-34b": yi_34b,
            "qwen3-8b": qwen3_8b, "h2o-danube-1.8b": h2o_danube_1_8b,
            "xlstm-1.3b": xlstm_1_3b, "chameleon-34b": chameleon_34b,
            "granite-moe-3b-a800m": granite_moe_3b_a800m,
            "olmoe-1b-7b": olmoe_1b_7b,
            "seamless-m4t-large-v2": seamless_m4t_large_v2,
            "recurrentgemma-2b": recurrentgemma_2b}

ARCH_IDS = tuple(_MODULES)
CONFIGS = {k: m.CONFIG for k, m in _MODULES.items()}

def get(name: str) -> ModelConfig:
    """Full-width config of ``name``."""
    return CONFIGS[name]


def smoke(name: str) -> ModelConfig:
    """Reduced config of ``name`` for CPU tests."""
    return _MODULES[name].smoke()
