"""Algorithm 1: multi-agent kernel optimization.

The counterpart of ``repro/core/loop.py``. The loop wires the four agents
as the paper's pseudocode does:

    T      <- TestingAgent.GenerateTests(S0)
    perf0  <- ProfilingAgent.Profile(S0, T)
    Log    <- [(0, S0, True, perf0)]
    for r in 1..R:
        sugg     <- PlanningAgent.Suggest(S_prev, pass_prev, perf_prev)
        S_new    <- CodingAgent.Apply(S_prev, sugg)
        pass_new <- TestingAgent.Validate(S_new, T)
        perf_new <- ProfilingAgent.Profile(S_new, T)
        Log.append((r, S_new, pass_new, perf_new))
        S_prev, pass_prev, perf_prev <- S_new, pass_new, perf_new

The implementation lives in ``repro_torch.search``: ``optimize`` with
``strategy="greedy"`` is this loop. This module delegates lazily, so that
importing ``repro_torch.core`` does not import ``repro_torch.search``.
"""

from __future__ import annotations

from repro_torch.core.oplog import Log
from repro_torch.core.variants import KernelSpace


def optimize(kernel: str | KernelSpace, **kwargs) -> Log:
    """Run one search on one kernel (default: Algorithm 1's greedy chain);
    see ``repro_torch.search.optimize``."""
    from repro_torch.search.orchestrator import optimize as _optimize
    return _optimize(kernel, **kwargs)


def optimize_all(**kwargs) -> dict[str, Log]:
    """Optimize the paper's three kernels; returns {kernel: Log}."""
    from repro_torch.search.orchestrator import optimize_all as _optimize_all
    return _optimize_all(**kwargs)


def reintegrate(results: dict[str, Log]) -> None:
    """Post-processing (paper §3.2): install each kernel's best correct
    genome process-wide, so the serving path launches it."""
    from repro_torch.search.orchestrator import reintegrate as _reintegrate
    return _reintegrate(results)
