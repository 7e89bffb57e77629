"""Astra core on PyTorch: the four agents, the planning policy, the H100
cost model, the optimization log and the loop's entry points.

The counterpart of ``repro.core``; the search machinery (strategies,
evaluation cache, orchestrator) lives in ``repro_torch.search``.
"""

from repro_torch.core.agents import (CodingAgent, PlanningAgent,
                                     ProfilingAgent, Suggestion,
                                     TestingAgent)
from repro_torch.core.loop import optimize, optimize_all, reintegrate
from repro_torch.core.oplog import Log, LogEntry
from repro_torch.core.single_agent import optimize_single_agent
from repro_torch.core.variants import (SPACES, KernelSpace, Knob, TestCase,
                                       get_space, make_inputs,
                                       register_kernel_space,
                                       registered_kernels)

__all__ = [
    "CodingAgent", "PlanningAgent", "ProfilingAgent", "TestingAgent",
    "Suggestion", "optimize", "optimize_all", "reintegrate",
    "Log", "LogEntry", "optimize_single_agent",
    "SPACES", "KernelSpace", "Knob", "TestCase", "get_space", "make_inputs",
    "register_kernel_space", "registered_kernels",
]
