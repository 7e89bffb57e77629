"""Single-agent baseline (paper §5.2, Table 3).

The counterpart of ``repro/core/single_agent.py``. One agent, one shared
context, the same round budget R and the same tools, but none of the role
specialization. The paper traces its loss on Kernel 1 to "unrepresentative
test inputs generated during test construction, which biased the
profiling results". The baseline reproduces that structurally:

* test construction: ONE quick case at the round dims the agent reaches
  for first (for Kernel 1 it takes a model's hidden size, 4096, for the
  head dim), not the testing agent's production-shape suite;
* profiling: reps=1 (on the card: one timed launch after the warm-ups;
  on the analytic model: ~4% noise);
* planning: no per-term breakdown; it walks a fixed checklist and keeps
  any change that does not look more than 5% worse on its own quick test.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core.agents import ProfilingAgent, Suggestion, TestingAgent
from repro_torch.core.oplog import Log, LogEntry
from repro_torch.kernels.registry import KernelSpace, get_space, make_inputs

_QUICK_SHAPES = {
    "silu_and_mul": {"batch": 8, "hidden": 4096},
    "fused_add_rmsnorm": {"batch": 8, "hidden": 4096},
    "merge_attn_states_lse": {"seq": 256, "heads": 4, "head_dim": 4096},
}

# fixed transformation checklist (no profile-driven targeting): intrinsics
# first, then structure, then tiles
_CHECKLIST = ("use_reciprocal", "use_rsqrt", "fast_exp", "fuse_s_out",
              "two_pass", "fused_split", "hoist", "block_rows", "block_cols")


def optimize_single_agent(kernel: str | KernelSpace, *, rounds: int = 5,
                          verbose: bool = False, device=None) -> Log:
    """Run the single-agent loop on ``device`` (the card unless ``"cpu"``).
    Returns a Log comparable to Algorithm 1's; ``log.final_variant`` is
    the genome it ships."""
    space = get_space(kernel) if isinstance(kernel, str) else kernel
    tester = TestingAgent(device=device)      # same tool access
    quick = [make_inputs(space.name, _QUICK_SHAPES[space.name], seed=7,
                         device=tester.device)]
    profiler = ProfilingAgent(reps=1)         # sloppy single-rep measurement

    s_prev = space.baseline
    perf_prev = profiler.profile(space, s_prev, quick)
    log = Log()
    log.append(LogEntry(0, s_prev, True, perf_prev, rationale="baseline"))
    accepted_lat = perf_prev.geomean_latency_us

    knob_by_name = {k.name: k for k in space.knobs}
    todo = deque(n for n in _CHECKLIST if n in knob_by_name)
    for r in range(1, rounds + 1):
        if not todo:
            log.append(LogEntry(r, s_prev, True, perf_prev,
                                rationale="checklist exhausted; hold"))
            continue
        name = todo.popleft()
        knob = knob_by_name[name]
        if knob.kind == "bool":
            # the generalist flips switches to see what happens: it has no
            # catalog telling it the good direction
            value = not getattr(s_prev, name)
        else:
            value = min(knob.hi, getattr(s_prev, name) * 2)
        sugg = Suggestion(name, value, f"checklist: try {name}={value}")
        s_new = space.mutate(s_prev, knob, value)
        perf_new = profiler.profile(space, s_new, quick)
        # a genome that cannot launch fails unrun, as the loop's evaluator
        # screens it (on the card its wrapper would raise)
        pass_new, max_err = (False, 0.0) \
            if perf_new.signals["infeasible"] \
            else tester.validate(space, s_new, quick)
        log.append(LogEntry(r, s_new, pass_new, perf_new,
                            rationale=sugg.rationale, max_err=max_err))
        # accept unless it looks clearly worse on the (noisy) quick test
        if pass_new and perf_new.geomean_latency_us <= accepted_lat * 1.05:
            s_prev, perf_prev = s_new, perf_new
            accepted_lat = perf_new.geomean_latency_us
        if verbose:
            print(f"[SA {space.name}] r{r} {sugg.rationale} -> "
                  f"{'kept' if s_prev is s_new else 'rejected'} "
                  f"({perf_new.geomean_latency_us:.2f}us)")

    # the single agent ships its last accepted kernel: it has no
    # independent log review (the planning agent's job in the loop)
    final = dataclasses.replace(s_prev, name=f"{space.name}_single_agent")
    log.entries[-1].code = final
    log.final_variant = final
    return log
