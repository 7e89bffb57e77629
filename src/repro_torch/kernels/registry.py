"""Kernel registry: each kernel module declares its own optimization space.

The counterpart of ``repro/kernels/registry.py``. A kernel module
registers its space next to the kernel it describes::

    from repro_torch.kernels.registry import (KernelSpace, Knob,
                                              register_kernel_space)

    @register_kernel_space
    def _space() -> KernelSpace:
        return KernelSpace(name="my_kernel", baseline=BASELINE, ...)

``repro_torch.kernels`` imports every kernel module, so importing the
package fills the registry; ``get_space`` / ``SPACES`` / ``registered_kernels``
import it lazily, so a caller never sees an empty registry.

A space's ``run(variant, *args)`` follows the tensors: on CUDA tensors it
launches the genome's Hopper kernel, on CPU tensors it takes that genome's
plain PyTorch version (the stand-in for Pallas ``interpret=True``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterator, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class Knob:
    """One legal move in the optimization space."""
    name: str
    kind: str                       # "pow2" | "bool"
    lo: int = 8                     # pow2 bounds
    hi: int = 1024
    # which roofline terms this knob attacks; the planning agent matches
    # knobs against the dominant term of the profile
    attacks: tuple = ("memory",)    # of "memory" | "compute" | "overhead"
    # for bool knobs: the catalog-optimized direction; the planner only
    # ever moves toward it
    target: Any = None
    note: str = ""


@dataclasses.dataclass(frozen=True)
class TestCase:
    """One element of the test suite T (paper §3.1)."""
    name: str
    args: tuple                     # positional args to run / oracle
    shape_info: dict                # kwargs for the cost function


TestCase.__test__ = False           # keep pytest from collecting it


@dataclasses.dataclass(frozen=True)
class KernelSpace:
    """A kernel's genome space: how to run, check, cost and perturb it."""
    name: str
    baseline: Any
    run: Callable[..., Any]         # run(variant, *args)
    oracle: Callable[..., Any]
    cost: Callable[..., Any]        # cost(variant, **shape_info)
    knobs: tuple[Knob, ...]
    # shapes the testing agent draws the suite from (generator kwargs)
    suite_shapes: tuple[dict, ...]
    # materializes one TestCase: make_inputs(shape, *, dtype, seed, device)
    make_inputs: Callable[..., TestCase] | None = None
    # the shipped tuned variant (the ``ops`` default); ``baseline`` if None
    default: Any = None
    # launch_key(variant, **shape_info): what the genome launches on one
    # test (launch shape and template flags); genomes with equal keys on
    # every test share one evaluation. None: every genome is distinct
    launch_key: Callable[..., Any] | None = None

    def mutate(self, variant, knob: Knob, value) -> Any:
        """``variant`` with one knob moved; the name records the move."""
        new = dataclasses.replace(variant, **{knob.name: value})
        return dataclasses.replace(new, name=f"{self.name}@{knob.name}={value}")

    @property
    def shipped(self) -> Any:
        """The genome ``ops`` runs when nothing was reintegrated."""
        return self.default if self.default is not None else self.baseline


_REGISTRY: dict[str, KernelSpace] = {}


def register_kernel_space(obj):
    """Register a ``KernelSpace`` (or a zero-argument factory of one) and
    return it. Duplicate names raise ValueError."""
    space = obj if isinstance(obj, KernelSpace) else obj()
    if not isinstance(space, KernelSpace):
        raise TypeError(f"register_kernel_space expected a KernelSpace or a "
                        f"factory returning one, got {type(space).__name__}")
    if space.name in _REGISTRY:
        raise ValueError(f"kernel space {space.name!r} is already registered")
    _REGISTRY[space.name] = space
    return space


def _populate() -> None:
    # importing the package imports every kernel module, each of which
    # registers its space
    import repro_torch.kernels  # noqa: F401


def get_space(name: str) -> KernelSpace:
    """The registered space called ``name``; KeyError if there is none."""
    _populate()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel space named {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_kernels() -> tuple[str, ...]:
    """Names of every registered space, sorted."""
    _populate()
    return tuple(sorted(_REGISTRY))


class _SpacesView(Mapping):
    """Read-only dict view of the registry."""

    def __getitem__(self, name: str) -> KernelSpace:
        return get_space(name)

    def __iter__(self) -> Iterator[str]:
        _populate()
        return iter(_REGISTRY)

    def __len__(self) -> int:
        _populate()
        return len(_REGISTRY)

    def __repr__(self) -> str:
        _populate()
        return f"SPACES({sorted(_REGISTRY)})"


SPACES: Mapping[str, KernelSpace] = _SpacesView()


def make_inputs(kernel: str, shape: dict, *, dtype=torch.float32,
                seed: int = 0, device=None) -> TestCase:
    """One test case of a registered kernel, drawn with numpy from ``seed``
    and placed on ``device`` (the card unless ``"cpu"`` is asked for)."""
    from repro_torch.device import resolve_device
    space = get_space(kernel)
    if space.make_inputs is None:
        raise NotImplementedError(f"kernel {kernel!r} registered no "
                                  "make_inputs generator")
    return space.make_inputs(shape, dtype=dtype, seed=seed,
                             device=resolve_device(device))


# -- suite / oracle memoization ----------------------------------------------
#
# Suites and oracle outputs depend only on (kernel, suite shapes, seed,
# dtypes, device), never on the genome under evaluation, so they are made
# once per suite and shared by every candidate of every search.

_SUITE_MEMO: dict[tuple, tuple] = {}
_ORACLE_MEMO: dict[tuple, tuple] = {}
_MEMO_LOCK = threading.Lock()          # guards the memo/lock dicts only
_ORACLE_KEY_LOCKS: dict[tuple, threading.Lock] = {}


def suite_key(space: KernelSpace, testing) -> tuple:
    """Identity of a generated suite: kernel, shape spec, the testing
    agent's class, data seed, dtypes and device."""
    cls = type(testing)
    return (space.name, repr(space.suite_shapes),
            f"{cls.__module__}.{cls.__qualname__}",
            getattr(testing, "seed", None),
            tuple(str(d) for d in getattr(testing, "dtypes", ())),
            str(getattr(testing, "device", None)))


def suite_tests(space: KernelSpace, testing) -> list[TestCase]:
    """Memoized ``testing.generate_tests(space)``."""
    key = suite_key(space, testing)
    with _MEMO_LOCK:
        hit = _SUITE_MEMO.get(key)
    if hit is not None:
        return list(hit)
    tests = testing.generate_tests(space)
    with _MEMO_LOCK:
        _SUITE_MEMO.setdefault(key, tuple(tests))
    return list(tests)


def oracle_outputs(space: KernelSpace, tests, *,
                   digest: str) -> tuple[tuple, bool]:
    """Memoized oracle outputs aligned with ``tests``, keyed by (kernel,
    suite digest). Returns ``(outputs, computed)``; ``computed`` is True
    when this call ran the oracle. The lock is per key: racing callers of
    one suite compute it once, callers of different suites do not wait on
    each other."""
    key = (space.name, digest)
    with _MEMO_LOCK:
        hit = _ORACLE_MEMO.get(key)
        if hit is not None:
            return hit, False
        key_lock = _ORACLE_KEY_LOCKS.setdefault(key, threading.Lock())
    with key_lock:
        with _MEMO_LOCK:
            hit = _ORACLE_MEMO.get(key)
        if hit is not None:
            return hit, False
        outs = tuple(space.oracle(*t.args) for t in tests)
        with _MEMO_LOCK:
            _ORACLE_MEMO[key] = outs
        return outs, True


def clear_suite_memos() -> None:
    """Drop all memoized suites and oracle outputs (frees the tensors)."""
    with _MEMO_LOCK:
        _SUITE_MEMO.clear()
        _ORACLE_MEMO.clear()
        _ORACLE_KEY_LOCKS.clear()
