"""Logical-axis partitioning rules and the tensor-parallel serving plan
(``repro_torch.sharding.tp``) over ``torch.distributed``."""
from repro_torch.sharding import tp
from repro_torch.sharding.rules import (batch_spec, sharding_for, spec_for,
                                        tree_shardings)

__all__ = ["batch_spec", "sharding_for", "spec_for", "tp", "tree_shardings"]
