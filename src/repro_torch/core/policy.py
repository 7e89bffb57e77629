"""Planning backends (the counterpart of ``repro/core/policy.py``).

``PolicyBackend`` is the shipped deterministic planner: it encodes, as an
explicit decision procedure, the optimization reasoning the paper's LLM
verbalizes — read the profile, identify the dominant roofline term, pick
the transformation family that attacks it, never repeat a move that
regressed, revert when a round made things worse. It sees ONLY what the
paper's planning agent sees: profile signals and the optimization history
— never the oracle's implementation or the cost model's internals.

``LLMBackend`` is the interface where OpenAI o4-mini (paper §4) would slot
in; no LLM endpoint is wired in, so it raises.
"""

from __future__ import annotations

from repro_torch.core.agents import Profile, Suggestion
from repro_torch.core.variants import KernelSpace, Knob

# term priority when the dominant term has no remaining moves
_FALLBACK = {"memory": ("compute", "overhead"),
             "compute": ("overhead", "memory"),
             "overhead": ("memory", "compute")}


class PolicyBackend:
    """Deterministic profile-driven hill-climbing planner."""

    def plan(self, space: KernelSpace, variant, passed: bool,
             profile: Profile, history: list) -> Suggestion:
        # explore=False: Algorithm 1 holds position when the catalog is
        # exhausted; exploratory resizes are beam-only breadth.
        suggs = self.plan_many(space, variant, passed, profile, history,
                               k=1, explore=False)
        if suggs:
            return suggs[0]
        # Nothing left: hold position (no-op move on the first knob).
        k = space.knobs[0]
        return Suggestion(k.name, getattr(variant, k.name),
                          "no profitable moves left; hold")

    def plan_many(self, space: KernelSpace, variant, passed: bool,
                  profile: Profile, history: list,
                  k: int = 4, explore: bool = True) -> list[Suggestion]:
        """Up to ``k`` distinct proposals, best-first.

        Proposal #1 is exactly what ``plan`` would pick (the greedy chain's
        move); the rest are the remaining catalog moves in term-priority
        order, then (``explore=True``) exploratory tile resizes — the extra
        breadth that multi-candidate strategies (beam search) spend their
        width on.
        """
        out: list[Suggestion] = []
        proposed: set = set()

        def add(sug: Suggestion | None) -> None:
            if sug is None or len(out) >= k:
                return
            move = (sug.knob, sug.value)
            if move in proposed or move in banned:
                return
            if sug.value == getattr(variant, sug.knob):
                return                  # no-op move
            proposed.add(move)
            out.append(sug)

        banned = self._banned_moves(space, history)
        best = self._best(history)
        noise = 2.0 * profile.noise_scale

        # 1. Regression / failure handling: revert the last move.
        if best is not None:
            best_var, best_lat = best
            cur_lat = profile.geomean_latency_us
            if (not passed) or cur_lat > best_lat * (1.0 + noise):
                diff = self._diff(variant, best_var, space)
                if diff is not None:
                    knob, val = diff
                    # a revert is never banned — it restores the best state
                    banned = banned - {(knob.name, val)}
                    add(Suggestion(
                        knob.name, val,
                        f"revert {knob.name}: round regressed "
                        f"({cur_lat:.1f}us vs best {best_lat:.1f}us)"
                        + ("" if passed else " and FAILED tests")))

        # 2. Attack the dominant term, then fallbacks.
        order = (profile.dominant,) + _FALLBACK[profile.dominant]
        for term in order:
            for knob in space.knobs:
                if term not in knob.attacks:
                    continue
                add(self._move(space, variant, knob, profile))

        # 3. Exploratory tile resizes (both directions) for extra beam width.
        if not explore:
            return out
        for term in order:
            for knob in space.knobs:
                if knob.kind != "pow2" or term not in knob.attacks:
                    continue
                cur = getattr(variant, knob.name)
                for val, why in ((cur * 2, "grow"), (cur // 2, "shrink")):
                    if knob.lo <= val <= knob.hi:
                        add(Suggestion(knob.name, val,
                                       f"explore: {why} {knob.name} to {val}"))
        return out

    # -- helpers -----------------------------------------------------------

    def _move(self, space, variant, knob: Knob, profile: Profile):
        cur = getattr(variant, knob.name)
        if knob.kind == "bool":
            # Only move toward the catalog-optimized direction; a knob whose
            # current value already sits at the target offers no move.
            if knob.target is not None and cur != knob.target:
                return Suggestion(knob.name, knob.target,
                                  f"{knob.name}→{knob.target}: attacks "
                                  f"{'/'.join(knob.attacks)} ({knob.note})")
            return None
        # pow2 tile knob
        # smem_frac: the block's largest share of the SM's shared memory,
        # registers or threads (> 1: it cannot launch)
        pressure = profile.signals["smem_frac"]
        if profile.signals.get("infeasible") or pressure > 1.0:
            if cur > knob.lo:
                return Suggestion(knob.name, cur // 2,
                                  f"halve {knob.name}: the block exceeds "
                                  f"the SM's shared memory, registers or "
                                  f"threads")
            return None
        if pressure < 0.25 and cur < knob.hi:
            return Suggestion(knob.name, cur * 2,
                              f"double {knob.name}: fewer, fuller blocks "
                              f"amortize per-block overhead (occupancy "
                              f"pressure {pressure:.0%})")
        return None

    def _best(self, history):
        ok = [(h["variant"], h["profile"].geomean_latency_us)
              for h in history if h["passed"]]
        return min(ok, key=lambda t: t[1]) if ok else None

    def _diff(self, cur, target, space):
        for knob in space.knobs:
            if getattr(cur, knob.name) != getattr(target, knob.name):
                return knob, getattr(target, knob.name)
        return None

    def _banned_moves(self, space, history) -> set:
        """Moves that were tried and led to failure or regression."""
        banned = set()
        for i in range(1, len(history)):
            h, prev = history[i], history[i - 1]
            sug = h.get("suggestion")
            if sug is None:
                continue
            regressed = (not h["passed"]) or (
                prev["passed"]
                and h["profile"].geomean_latency_us
                > prev["profile"].geomean_latency_us
                * (1.0 + 2.0 * h["profile"].noise_scale))
            if regressed:
                banned.add((sug.knob, sug.value))
        return banned


class LLMBackend:
    """Where the paper's o4-mini planning agent would plug in.

    The prompt contract mirrors the paper: the model receives the current
    kernel (genome + its CUDA source), the correctness verdict, the
    profile, and the history log; it must answer with a single knob move.
    No endpoint is wired in, so instantiation fails loudly rather than
    silently degrading.
    """

    def __init__(self, model: str = "o4-mini", endpoint: str | None = None):
        raise NotImplementedError(
            "No LLM endpoint is wired in. "
            "Use PolicyBackend (default), or provide an endpoint and "
            "implement .plan() with your client.")
