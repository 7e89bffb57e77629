"""Sandboxed evaluation workers (the counterpart of
``repro/search/workers.py``): crash isolation for the search's hot path.

Candidate kernels are the code to assume will hang, fault or corrupt what
it reports: the coding agent writes them and the testing agent runs them.
On the card one bad launch does more than fail its own test: an illegal
address leaves the CUDA context in a sticky error state, and every later
launch in that process fails, the rest of the search included. This
module moves the profile and the validation into spawn-mode worker
processes, so a broken candidate costs one child:

  start-up    Each child imports torch and the port and, for a pool on
              the card, creates its CUDA context and loads the kernel
              library (built once by the parent before any child starts),
              then reports ready. A pool waits for that before a child's
              first task, so start-up never counts against a deadline.
  deadline    ``conn.poll(deadline_s)`` in the parent; a worker past its
              deadline is killed and replaced, so a launch that never
              returns cannot hang the search.
  retry       Infra faults (a worker died, a deadline, a corrupt payload,
              an evaluation that raised) are retried with exponential
              backoff; none is raised to the caller.
  quarantine  A genome that faults ``quarantine_after`` times is written
              off: the evaluator records a final ``finish_reason="crashed"``
              verdict, so it never runs again, not even in a later process.
  integrity   The child sends ``(payload, sha256(payload))``; the parent
              checks the digest before unpickling, so a corrupted result
              is an infra fault, not a wrong verdict.
  recycling   Workers retire after ``recycle_after`` tasks and are
              replaced.

On the card two more rules hold. A worker whose evaluation raised is
replaced before the next task, since its context may hold a sticky error
(the JAX pool keeps it). And the pool keeps one task on the device at a
time: the workers are separate CUDA contexts that time-slice the card, and
one worker's kernels would land inside another's CUDA-event timings. The
gate is a lock in the parent, held from a task's dispatch to its reply
(and across a replacement's start-up): a worker killed at its deadline
holds nothing.

Determinism: a child runs the thread path's ``TieredEvaluator`` cascade
against the batch's frozen thresholds, on a suite regenerated from the
seeded testing agent, with the parent's PyTorch thread count and TF32
flags, so a well-behaved genome's ``EvalResult`` is bit-identical to the
one the parent would compute. Tasks name the kernel and its suite shapes
(a ``KernelSpace`` holds callables that do not pickle), so only
registered kernels run in workers.

Each reply carries the child's launch counts over the task, which the
pool adds to ``ops.launch_counts()`` here, and the task's start and end on
the host's monotonic clock (``spans``).

Chaos: a ``reliability.SearchChaosInjector`` attached to the pool arms
per-attempt directives (``kill_worker``, ``hang_eval``,
``corrupt_result``) that the child carries out on itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import multiprocessing as mp
import os
import pickle
import queue
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.search.types import EvalResult

_SENTINEL = None                    # shutdown message to a worker
STARTUP_S = 600.0                   # longest a child may take to get ready


# -- the child ---------------------------------------------------------------

class _TimeoutTesting:
    """Delegating wrapper that applies the pool's cooperative per-task
    budget to every ``validate`` call in the worker (the parent's kill at
    the deadline stays the hard guarantee)."""

    def __init__(self, testing, timeout_s):
        self._testing = testing
        self._timeout_s = timeout_s

    def validate(self, space, variant, tests, *, oracle=None):
        return self._testing.validate(space, variant, tests, oracle=oracle,
                                      timeout_s=self._timeout_s)

    def __getattr__(self, name):
        return getattr(self._testing, name)


def _parent_state() -> dict:
    """What a child must share with this process to compute what it would:
    the CPU thread count (a CPU reduction's order) and the TF32 flags (the
    card's oracle products)."""
    return {"threads": torch.get_num_threads(),
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32}


def _apply_state(state: dict) -> None:
    if torch.get_num_threads() != state["threads"]:
        torch.set_num_threads(state["threads"])
    torch.backends.cuda.matmul.allow_tf32 = state["tf32_matmul"]
    torch.backends.cudnn.allow_tf32 = state["tf32_cudnn"]


def _run_task(task: dict) -> tuple[EvalResult, dict]:
    """Evaluate one genome as the thread path would: a fresh evaluator and
    cache, the parent's frozen thresholds."""
    from repro_torch.kernels.registry import get_space, suite_tests
    from repro_torch.search.cache import EvalCache
    from repro_torch.search.evaluator import _UNSET, TieredEvaluator

    _apply_state(task["state"])
    space = get_space(task["kernel"])
    if tuple(task["suite_shapes"]) != tuple(space.suite_shapes):
        space = dataclasses.replace(
            space, suite_shapes=tuple(task["suite_shapes"]))
    testing = task["testing"]
    tests = suite_tests(space, testing)
    if task.get("soft_timeout_s"):
        testing = _TimeoutTesting(testing, task["soft_timeout_s"])
    cfg = task["config"]
    ev = TieredEvaluator(screen=cfg["screen"], smoke=cfg["smoke"],
                         share_oracle=cfg["share_oracle"],
                         dominate_factor=cfg["dominate_factor"])
    cache = EvalCache()
    if task["prior"] is not None:
        cache.put(cache.key(space.name, task["variant"], tests,
                            tests_digest=task["tests_digest"],
                            launch_key=space.launch_key), task["prior"])
    frozen = task["frozen"]
    result = ev.evaluate(
        space, task["variant"], tests, testing=testing,
        profiling=task["profiling"], cache=cache,
        validate=task["validate"], tests_digest=task["tests_digest"],
        _frozen=_UNSET if frozen is None else tuple(frozen))
    # the delivery flags are the parent's business
    result = dataclasses.replace(result, cached=False, replayed=False)
    return result, ev.stats.as_dict()


def _start_up(device_type: str) -> None:
    """Everything before a child's first task: the imports and, on the
    card, its CUDA context and the kernel library (which the parent built;
    a child that cannot load it fails here, never falls back)."""
    import repro_torch.kernels  # noqa: F401  (fills the registry)
    import repro_torch.search.evaluator  # noqa: F401
    if device_type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


def _worker_main(conn, device_type: str) -> None:
    """Child process loop: start up and report ready, then recv a task,
    evaluate it, send a checksummed payload; until the sentinel (or until
    the parent kills it)."""
    try:
        _start_up(device_type)
    except Exception:               # noqa: BLE001 — reported to the parent
        conn.send(("failed", traceback.format_exc(limit=8)))
        return
    conn.send(("ready", os.getpid(), time.monotonic()))
    from repro_torch.kernels import ops
    while True:
        try:
            task = conn.recv()
        except (EOFError, OSError):
            return
        if task is _SENTINEL:
            conn.close()
            return
        chaos = task.get("chaos")
        if chaos and chaos["kind"] == "kill_worker":
            os._exit(17)            # a simulated fault or OOM kill
        if chaos and chaos["kind"] == "hang_eval":
            time.sleep(chaos.get("seconds") or 3600.0)
        before = ops.launch_counts()
        start = time.monotonic()
        try:
            result, stats = _run_task(task)
            if device_type == "cuda":
                torch.cuda.synchronize()    # the task's kernels are done
            status, body = "ok", (result, stats)
        except Exception:           # noqa: BLE001 — the child must not die
            status, body = "error", (traceback.format_exc(limit=8),)
        info = {"pid": os.getpid(), "start": start, "end": time.monotonic(),
                "launches": {k: n - before[k]
                             for k, n in ops.launch_counts().items()}}
        payload = pickle.dumps((status,) + body + (info,))
        digest = hashlib.sha256(payload).hexdigest()
        if chaos and chaos["kind"] == "corrupt_result":
            # bit rot in transit: the digest describes the true payload
            payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
        try:
            conn.send((payload, digest))
        except (BrokenPipeError, OSError):
            return


# -- the parent --------------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """What ``EvalWorkerPool.submit`` learned about one task. ``ok=False``
    means the genome spent its fault budget and is to be quarantined;
    infra faults never raise."""
    ok: bool
    result: Optional[EvalResult] = None
    stats: Optional[dict] = None    # worker-side EvalStats deltas
    error: Optional[str] = None     # last fault detail when not ok
    attempts: int = 1


class _Worker:
    """One spawned child plus its parent-side pipe end."""

    def __init__(self, ctx, env_path: str, device_type: str):
        parent, child = ctx.Pipe()
        self.conn = parent
        self.tasks_done = 0
        self.pid: Optional[int] = None
        self.started = time.monotonic()
        self.startup_s: Optional[float] = None
        # the spawned interpreter must be able to import repro_torch: splice
        # the package root into PYTHONPATH around start()
        old = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [env_path] + ([old] if old else []))
        try:
            self.proc = ctx.Process(target=_worker_main,
                                    args=(child, device_type), daemon=True)
            self.proc.start()
        finally:
            if old is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = old
        child.close()

    def wait_ready(self, timeout_s: float) -> None:
        """Block until the child reports ready; RuntimeError if it fails
        to start, dies or is not ready within ``timeout_s``."""
        try:
            msg = self.conn.recv() if self.conn.poll(timeout_s) else None
        except (EOFError, OSError):
            msg = ("failed", f"died during start-up (exit code "
                             f"{self.proc.exitcode})")
        if msg is None:
            msg = ("failed", f"not ready within {timeout_s}s")
        if msg[0] != "ready":
            self.shoot()
            raise RuntimeError(f"evaluation worker failed to start: "
                               f"{msg[1]}")
        # from the child's own ready stamp (the host's monotonic clock is
        # shared by processes), so a worker read late counts only its own
        self.pid, self.startup_s = msg[1], msg[2] - self.started

    def shoot(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5.0)
        self.conn.close()

    def retire(self) -> None:
        try:
            self.conn.send(_SENTINEL)
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=5.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=5.0)
        self.conn.close()


class EvalWorkerPool:
    """Pool of spawn-mode evaluation workers with deadlines, bounded
    retries, quarantine and recycling, for suites on ``device`` (the card
    unless ``"cpu"`` is asked for). Thread-safe: ``submit`` may be called
    concurrently (``evaluate_many`` does, one thread per genome); each
    submit checks a worker out for the task's duration, and on the card
    also holds the pool's gate, so one task at a time is on the device.

    ``on_stat(name, n)`` reports infra events (``worker_crashes``,
    ``eval_timeouts``, ``corrupt_results``, ``retries``, ``recoveries``,
    ``workers_recycled``; ``quarantined`` is the evaluator's to count):
    wire it to ``TieredEvaluator.bump``.
    """

    def __init__(self, *, workers: int = 1, deadline_s: float = 60.0,
                 max_retries: int = 2, quarantine_after: int = 2,
                 recycle_after: int = 50, backoff_s: float = 0.05,
                 chaos=None,
                 on_stat: Optional[Callable[..., Any]] = None,
                 device=None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        self.device = resolve_device(device)
        self.workers = workers
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.quarantine_after = quarantine_after
        self.recycle_after = recycle_after
        self.backoff_s = backoff_s
        self.chaos = chaos
        self._on_stat = on_stat or (lambda name, n=1: None)
        self._ctx = mp.get_context("spawn")
        import repro_torch
        self._env_path = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        self._idle: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._gate = threading.Lock() if self.device.type == "cuda" \
            else contextlib.nullcontext()
        self._dispatched = 0        # global attempt counter (chaos step)
        self._strikes: dict[str, int] = {}
        self._strike_errors: dict[str, str] = {}
        self._closed = False
        # one reply a dict: the child's pid, the task's start and end on
        # the host's monotonic clock, "ok" or "error", and its launches
        self.spans: list[dict] = []
        self.startups: list[float] = []     # seconds to ready, per worker
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.library()        # build once, before any child loads it
        started = [self._start() for _ in range(workers)]
        try:
            for w in started:
                w.wait_ready(STARTUP_S)
        except RuntimeError:
            for w in started:
                w.shoot()
            raise
        for w in started:
            self.startups.append(w.startup_s)
            self._idle.put(w)

    # -- lifecycle -----------------------------------------------------------

    def _start(self) -> _Worker:
        return _Worker(self._ctx, self._env_path, self.device.type)

    def _spawn(self) -> _Worker:
        worker = self._start()
        worker.wait_ready(STARTUP_S)
        with self._lock:
            self.startups.append(worker.startup_s)
        return worker

    def close(self) -> None:
        """Retire the idle workers (a task in flight keeps its own)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        drained = []
        while True:
            try:
                drained.append(self._idle.get_nowait())
            except queue.Empty:
                break
        for w in drained:
            w.retire()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the submit path -----------------------------------------------------

    def submit(self, task: dict, *, digest: str) -> Outcome:
        """Run one task to an outcome: a verdict, or quarantine once the
        genome's fault budget is spent. Blocks while every worker is busy
        (on the card: while another task is on the device)."""
        on_card = torch.device(task["testing"].device).type == "cuda"
        if on_card and self.device.type != "cuda":
            raise ValueError("a suite on the card needs a pool made for the "
                             "card (device='cuda')")
        with self._lock:
            strikes = self._strikes.get(digest, 0)
            if strikes >= self.quarantine_after:
                return Outcome(ok=False, attempts=0,
                               error=self._strike_errors.get(
                                   digest, "previously quarantined"))
        attempts = 0
        faults = 0
        while True:
            attempts += 1
            status, value = self._attempt(task, digest)
            if status == "ok":
                result, stats = value
                if faults:
                    self._on_stat("recoveries")
                return Outcome(ok=True, result=result, stats=stats,
                               attempts=attempts)
            faults += 1
            with self._lock:
                self._strikes[digest] = self._strikes.get(digest, 0) + 1
                self._strike_errors[digest] = value
                quarantine = self._strikes[digest] >= self.quarantine_after
            if quarantine or attempts > self.max_retries:
                return Outcome(ok=False, error=value, attempts=attempts)
            self._on_stat("retries")
            time.sleep(self.backoff_s * (2 ** (attempts - 1)))

    def _attempt(self, task: dict, digest: str) -> tuple[str, Any]:
        """One dispatch to one worker. Returns ("ok", (result, stats)) or
        ("fault", error string); a faulted worker is already replaced."""
        with self._lock:
            index = self._dispatched
            self._dispatched += 1
        shipped = dict(task, soft_timeout_s=self.deadline_s,
                       state=_parent_state())
        if self.chaos is not None:
            fault = self.chaos.directive_for(digest, index)
            if fault is not None:
                shipped["chaos"] = {"kind": fault.kind,
                                    "seconds": fault.seconds}
        with self._gate:
            worker = self._idle.get()
            try:
                return self._exchange(worker, shipped)
            except _WorkerLost as lost:
                worker = None
                return "fault", str(lost)
            finally:
                if worker is None or not worker.proc.is_alive() \
                        or worker.conn.closed:
                    worker = self._spawn()
                elif worker.tasks_done >= self.recycle_after:
                    self._on_stat("workers_recycled")
                    worker.retire()
                    worker = self._spawn()
                self._idle.put(worker)

    def _exchange(self, worker: _Worker, shipped: dict) -> tuple[str, Any]:
        """Send one task to ``worker`` and read its reply. A worker that
        cannot be trusted afterwards is shot or retired before this
        returns, and a lost one raises ``_WorkerLost``."""
        try:
            worker.conn.send(shipped)
        except (BrokenPipeError, OSError):
            self._on_stat("worker_crashes")
            worker.shoot()
            raise _WorkerLost("worker dead at dispatch") from None
        if not worker.conn.poll(self.deadline_s):
            self._on_stat("eval_timeouts")
            worker.shoot()
            raise _WorkerLost(
                f"evaluation exceeded deadline ({self.deadline_s}s)")
        try:
            payload, sent_digest = worker.conn.recv()
        except (EOFError, OSError):
            self._on_stat("worker_crashes")
            worker.shoot()
            raise _WorkerLost("worker died mid-task") from None
        if hashlib.sha256(payload).hexdigest() != sent_digest:
            self._on_stat("corrupt_results")
            worker.shoot()              # its stream state is not trusted
            raise _WorkerLost("result checksum mismatch")
        msg = pickle.loads(payload)
        self._note(msg[0], msg[-1])
        if msg[0] == "error":
            # the evaluation raised in the child: one strike for the
            # genome, and a fresh worker for the next task (on the card
            # the context may hold a sticky error)
            self._on_stat("worker_crashes")
            worker.retire()
            return "fault", f"evaluation raised in worker:\n{msg[1]}"
        worker.tasks_done += 1
        return "ok", (msg[1], msg[2])

    def _note(self, status: str, info: dict) -> None:
        """Record a reply's span, and add the child's launches to this
        process's counts (the launches the device ran on its behalf)."""
        from repro_torch.kernels import ops
        launched = {k: n for k, n in info["launches"].items() if n}
        with self._lock:
            self.spans.append({"pid": info["pid"], "start": info["start"],
                               "end": info["end"], "status": status,
                               "launches": launched})
            if launched:
                ops.add_launch_counts(launched)

    # -- introspection -------------------------------------------------------

    def strikes(self, digest: str) -> int:
        """The faults charged to ``digest`` so far."""
        with self._lock:
            return self._strikes.get(digest, 0)


class _WorkerLost(Exception):
    """A worker died, hung past its deadline or sent a corrupt payload,
    and has been shot."""
