"""The benchmark harness: one run of one cell of ``BENCHMARK.json``.

A run builds the program's serving engine (``repro_torch.serving.api.
LLMEngine``) on seeded weights, warms up every prefill shape its traffic
uses, fills the engine (closed loops) or offers arrivals for a lead-in
(open loops), then measures a window of ``--seconds`` on the host clock,
driving ``LLMEngine.engine``'s ``submit`` and ``step`` as
``LLMEngine.stream`` does, with requests arriving while it runs. After
the window it reads the peak memory, frees the engine, and holds a
sample of the finished requests to the plain reference
(``bench/check.py``).

Everything that belongs to one configuration, one mix or one metric is a
file found by its name: ``configs/`` (sizes, serving settings and the
``family`` whose ``families/<family>.py`` draws the weights, runs the
reference and counts the work), ``mixes/<traffic>.json`` (the traffic,
its slots, and the check's sample and limit), ``metrics/<metric>.py``
(or ``metrics/<name before the first dot>.py``: a ``read(ctx)`` that
returns a number or None), ``kernels/<role>/*.txt`` (kernel-name
patterns of a roofline role, one per line) and ``peaks.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from bench import check
from bench.accounting import Rec, itls, percentile, ttfts
from bench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 8.0          # the traced part: the window's last seconds
FILL_LIMIT_S = 120.0         # closed loops: the longest wait for full slots
DRAIN_LIMIT_S = 60.0         # open loops: the longest wait past the close


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One cell and the files it names."""
    root: Path
    spec: dict
    name: str
    workload: dict
    config_name: str
    config: dict
    mix: dict
    family: object

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        spec = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        w = cells[name]
        entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
        config = load_json(root / entry["file"])
        mix = load_json(root / "bench" / "mixes" / f"{w['traffic']}.json")
        fam = load_module(root / "bench" / "families"
                          / f"{config['family']}.py",
                          f"bench_family_{config['family']}")
        return cls(root, spec, name, w, w["config"], config, mix, fam)

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports: with ``trace`` its per-layer
        ones, else its end-to-end ones. A metric with ``workloads`` is
        reported in those cells; a per-layer one without, wherever the
        end-to-end metric it moves is."""
        e2e = [m for m in self.spec["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if self.name in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in mine)]

    def reader(self, metric: str):
        d = self.root / "bench" / "metrics"
        for stem in (metric, metric.split(".")[0]):
            if (d / f"{stem}.py").exists():
                return load_module(d / f"{stem}.py",
                                   f"bench_metric_{stem}").read
        raise FileNotFoundError(f"no reader for metric {metric!r} in {d}")

    def kernel_roles(self) -> dict:
        """{role: [kernel-name patterns]} from ``kernels/<role>/*.txt``."""
        out: dict = {}
        base = self.root / "bench" / "kernels"
        for f in sorted(base.glob("*/*.txt")):
            pats = [ln.strip() for ln in f.read_text().splitlines()
                    if ln.strip() and not ln.startswith("#")]
            out.setdefault(f.parent.name, []).extend(pats)
        return out

    def peaks(self, kind: str) -> Optional[dict]:
        """The peak rates of the device ``kind`` names, or None."""
        for entry in load_json(self.root / "bench" / "peaks.json"):
            if entry["match"] in kind:
                return entry
        return None

    def serving(self) -> dict:
        """The engine's settings: the configuration's, then the mix's."""
        return {**self.config.get("serving", {}), **self.mix.get("serving",
                                                                  {})}


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads."""
    cfg: dict
    family: object
    seconds: float
    t_open: float
    t_close: float
    t_end: float
    setup_s: float
    recs: list
    steps: list            # (t0, t1, admitted, occupied) in the window
    slots: int
    trace: object = None   # a bench.trace.Trace, or None
    peaks: Optional[dict] = None
    kernel_roles: dict = dataclasses.field(default_factory=dict)


def card() -> dict:
    """The card's name, power limit and clocks from ``nvidia-smi``."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    return dict(zip(q.split(","), out.splitlines()[0].split(", "))) \
        if out else {}


class Run:
    """One run of a cell: set-up, window, metrics, check."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str):
        import torch
        from repro_torch.configs.base import ModelConfig
        from repro_torch.serving.api import LLMEngine
        from repro_torch.serving.engine import Request
        self.torch, self.Request = torch, Request
        self.cell, self.seconds = cell, float(seconds)
        self.trace_on = trace
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        c, self.fam = cell.config, cell.family
        srv = self.srv = cell.serving()
        self.phase = {}
        t = self.t_built = time.perf_counter()
        self.weights = self.fam.draw_weights(c, seed, self.dev)
        self._sync()
        self.phase["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        mc = ModelConfig(**self.fam.port_config(c, cell.config_name))
        self.llm = LLMEngine(
            self.weights, mc, slots=int(srv["slots"]),
            max_seq=int(srv["max_seq"]), paged=srv.get("paged"),
            page_size=int(srv.get("page_size", 16)),
            num_pages=srv.get("num_pages"),
            prefix_cache=bool(srv.get("prefix_cache", True)),
            device=self.dev)
        self.eng = self.llm.engine
        self._sync()
        self.phase["engine_s"] = time.perf_counter() - t
        self.traffic = Traffic(cell.mix, seed, self.fam.dims(c)["vocab"],
                               int(srv["max_seq"]))
        self.recs: dict = {}            # rid -> Rec, the run's requests
        self.live: dict = {}            # rid -> Rec, not yet finished
        self.steps: list = []
        self.waits: list = []           # (t0, t1): no work, arrivals due
        self.late: list = []            # open loops: submit - due
        self._next_rid = 0

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    # -- requests -----------------------------------------------------------

    def _submit(self, it, due: Optional[float] = None) -> Rec:
        rid = self._next_rid
        self._next_rid += 1
        req = self.Request(rid=rid, prompt=self.traffic.prompt(it),
                           max_new_tokens=it.max_new)
        now = time.perf_counter()
        rec = Rec(rid, it.prompt_len, it.max_new,
                  now if due is None else due, client=it.client, req=req)
        self.eng.submit(req)
        rec.submitted = time.perf_counter()
        if due is not None:
            self.late.append(rec.submitted - due)
        self.recs[rid] = rec
        self.live[rid] = rec
        return rec

    def _step(self, record: bool) -> None:
        """One engine step; stamps the tokens that landed and resubmits for
        closed-loop clients whose request ended."""
        t0 = time.perf_counter()
        self.eng.step()
        t1 = time.perf_counter()
        admitted = 0
        for rid, rec in list(self.live.items()):
            out = rec.req.out_tokens
            if len(out) > len(rec.tokens):
                admitted += not rec.tokens
                rec.tokens.extend([t1] * (len(out) - len(rec.tokens)))
            if rec.req.done:
                rec.done, rec.reason = t1, rec.req.finish_reason
                del self.live[rid]
                if self.traffic.closed and self._feed:
                    self._submit(self.traffic.item(self._next_item,
                                                   rec.client))
                    self._next_item += 1
        if record:
            occ = sum(s.req is not None for s in self.eng.slots)
            self.steps.append((t0, t1, admitted, occ))

    # -- phases -------------------------------------------------------------

    def warm(self) -> None:
        """One short request at each prefill length the traffic touches,
        run to its end: every prefill shape and the decode graph are
        warm before the window."""
        t = time.perf_counter()
        self._feed = False
        for n in self.traffic.warm_lengths():
            it = dataclasses.replace(self.traffic.item(0), prompt_len=n,
                                     max_new=2, index=2**40 + n)
            self._submit(it)
        while self.eng.has_work():
            self._step(False)
        self.eng.flush()
        self.warm_rids = set(self.recs)
        self._sync()
        self.phase["warm_s"] = time.perf_counter() - t

    def measure(self) -> None:
        """The lead-in or the fill, then the window (traced at its end
        under ``--trace 1``), then for open loops the drain."""
        torch = self.torch
        prof = None
        if self.trace_on:
            t = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            # the profiler's first start is slow: pay it in set-up
            with torch.profiler.profile(activities=acts):
                self._sync()
            prof = torch.profiler.profile(activities=acts)
            self.phase["profiler_s"] = time.perf_counter() - t
        mix = self.cell.mix
        self._feed, self._next_item = True, 0
        t = time.perf_counter()
        if self.traffic.closed:
            for it in self.traffic.first_wave():
                self._submit(it)
            self._next_item = int(mix["clients"])
            while (not all(s.req is not None for s in self.eng.slots)
                   and time.perf_counter() - t < FILL_LIMIT_S):
                self._step(False)
            self.t_open = time.perf_counter()
        else:
            self.t_open = t + float(mix["lead_s"])
        self.t_close = self.t_open + self.seconds
        self.phase["fill_s"] = self.t_open - t
        t_trace = max(self.t_open, self.t_close - TRACE_SECONDS)
        rf = None

        def start_trace(now: float) -> None:
            nonlocal rf
            if prof is not None and rf is None and now >= t_trace:
                prof.start()
                rf = torch.profiler.record_function("bench.traced")
                rf.__enter__()
                self.anchor = time.perf_counter()
        self.serve(t, self.t_open, self.t_close, start_trace)
        self.trace = None
        if rf is not None:
            rf.__exit__(None, None, None)
            self._sync()
            prof.stop()
            from bench.trace import from_profiler
            self.trace = from_profiler(prof, self.anchor)
            del prof
        self._feed = False
        if not self.traffic.closed:
            t_stop = time.perf_counter() + DRAIN_LIMIT_S

            def waiting():
                return any(self.t_open <= r.due < self.t_close
                           and not r.tokens and r.reason is None
                           for r in self.recs.values())
            while waiting() and self.eng.has_work() \
                    and time.perf_counter() < t_stop:
                self._step(False)
        self.eng.flush()
        for rec in self.live.values():
            out = rec.req.out_tokens
            if len(out) > len(rec.tokens):
                rec.tokens.extend([time.perf_counter()]
                                  * (len(out) - len(rec.tokens)))
            if rec.req.done:
                rec.reason = rec.req.finish_reason
        self.t_end = time.perf_counter()
        self._sync()
        self.memory_peak = int(torch.cuda.max_memory_allocated(self.dev)) \
            if self.cuda else 0
        self.stats = self.eng.stats()

    def serve(self, t0: float, t_open: float, t_close: float,
              tick=None) -> None:
        """Step the engine until ``t_close``; an open loop's arrivals are
        due at ``t0`` plus their time. Steps from ``t_open`` on are the
        window's; ``tick(now)`` is called before each step."""
        pending = None if self.traffic.closed \
            else self.traffic.item(self._next_item)
        while (now := time.perf_counter()) < t_close:
            if tick is not None:
                tick(now)
            while pending is not None and t0 + pending.due <= now:
                self._submit(pending, due=t0 + pending.due)
                self._next_item += 1
                pending = self.traffic.item(self._next_item)
            if self.eng.has_work():
                self._step(now >= t_open)
            elif pending is not None:
                time.sleep(max(0.0, min(t0 + pending.due, t_close) - now))
                if now >= t_open:
                    self.waits.append((now, time.perf_counter()))

    def label_at(self, t: float) -> str:
        """The harness's host span at ``t``."""
        for t0, t1, adm, _ in self.steps:
            if t0 <= t < t1:
                return "admitting step" if adm else "decode step"
        for t0, t1 in self.waits:
            if t0 <= t < t1:
                return "waiting for arrivals"
        return "harness between steps"

    def window_recs(self) -> list:
        return [r for rid, r in self.recs.items()
                if rid not in self.warm_rids]

    def free_program(self) -> None:
        """Drop the engine and everything it holds (the cache, graphs,
        pinned buffers); the weights are the harness's and stay."""
        self.eng = self.llm = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)
            self.torch.cuda.empty_cache()


def result_metrics(cell: Cell, ctx: Ctx, trace: bool) -> dict:
    out = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        device: str, t_proc0: float, *, fault=None) -> dict:
    """One run; returns the result object. ``fault(run)``, for the tests
    only, is called after the engine is built to break its timed path."""
    t_wall0 = time.perf_counter()
    cell = Cell.load(root, cell_name)
    r = Run(cell, seed, seconds, trace, device)
    r.phase = {"start_s": t_wall0 - t_proc0,
               "imports_s": r.t_built - t_wall0, **r.phase}
    if fault is not None:
        fault(r)
    r.warm()
    r.measure()
    crd = card() if r.cuda else {}
    setup_s = r.t_open - t_proc0
    recs = r.window_recs()
    steps = [s for s in r.steps if r.t_open <= s[0] < r.t_close]
    kind = r.torch.cuda.get_device_name(r.dev) if r.cuda else "cpu"
    ctx = Ctx(cell.config, cell.family, r.seconds, r.t_open,
              r.t_close, r.t_end, setup_s, recs, steps,
              int(r.srv["slots"]), r.trace,
              cell.peaks(kind) if r.cuda else None, cell.kernel_roles())
    metrics = result_metrics(cell, ctx, trace)
    attempted = [x for x in recs if x.submitted < r.t_close]
    failed = [x for x in attempted if x.reason not in (None, "done")]
    done = [x for x in attempted if x.reason == "done"]
    st = r.stats
    log(f"cell {cell_name} seed {seed} seconds {seconds} trace {int(trace)}"
        f" device {kind}")
    log("card", json.dumps(crd))
    log("setup", json.dumps({k: round(v, 3) for k, v in r.phase.items()}),
        f"setup_s {setup_s:.3f}")
    log(f"requests attempted {len(attempted)} succeeded {len(done)} "
        f"failed {len(failed)} in flight "
        f"{len(attempted) - len(done) - len(failed)}")
    if r.late:
        log(f"generator submitted {len(r.late)} late_max_ms "
            f"{max(r.late) * 1e3:.3f} late_p99_ms "
            f"{percentile(r.late, 99) * 1e3:.3f}")
    log(f"engine steps {st['steps']} readbacks {st['readbacks']} "
        f"graph_replays {st['graph_replays']} decode_captures "
        f"{st['decode_captures']} preemptions {st['preemptions']} "
        f"swapped_out_pages {st['swapped_out_pages']} "
        f"decode_step_s {st['decode_step_s']} "
        f"readbacks==steps==graph_replays "
        f"{st['readbacks'] == st['steps'] == st['graph_replays']}")
    occ = [s[3] for s in steps]
    if occ:
        log(f"slots {int(r.srv['slots'])} occupied mean "
            f"{sum(occ) / len(occ):.3f} max {max(occ)} over {len(occ)} "
            f"steps")
    tt = ttfts(recs, r.t_open, r.t_close, r.t_end)
    it = itls(recs, r.t_open, r.t_close)
    log("tails", json.dumps({
        "ttft_n": len(tt), "itl_n": len(it),
        **{f"ttft_p{p}_ms": percentile(tt, p) * 1e3 for p in (50, 90, 99)
           if tt},
        **{f"itl_p{p}_ms": percentile(it, p) * 1e3
           for p in (50, 90, 95, 99, 99.9) if it}}))
    log("metrics", json.dumps(metrics))
    device_out = {"platform": "gpu" if r.cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": r.memory_peak}
    out = {}
    if trace and r.trace is not None:
        device_out["busy_s"] = r.trace.busy_s()
        device_out["window_s"] = r.trace.window_s
        from bench.trace import breakdown
        out["breakdown"] = breakdown(r.trace, r.label_at)
        write_spans(root, cell_name, seed, r)
    r.free_program()
    t_chk = time.perf_counter()
    checks = check.run_check(cell, r.weights, done, failed, seed,
                             r.dev)
    log(f"check_s {time.perf_counter() - t_chk:.3f} run_s "
        f"{time.perf_counter() - t_wall0:.3f}")
    correct = all(c["ok"] for c in checks.values())
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']} "
            f"({c['holds']}) {'ok' if c['ok'] else 'FAILED'}")
    res = {"correct": correct, "attempted": len(attempted),
           "failed": len(failed), "metrics": metrics, "device": device_out,
           **out,
           "checks": {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}}
    return res


def write_spans(root: Path, cell_name: str, seed: int, r: Run) -> None:
    """The traced run's host spans and request records, under
    ``build/bench/``."""
    d = root / "build" / "bench"
    d.mkdir(parents=True, exist_ok=True)
    t0 = r.t_open
    doc = {"cell": cell_name, "seed": seed, "t_open": 0.0,
           "t_close": r.t_close - t0,
           "traced": [r.trace.t0 - t0, r.trace.t1 - t0],
           "steps": [[a - t0, b - t0, adm, occ]
                     for a, b, adm, occ in r.steps],
           "waits": [[a - t0, b - t0] for a, b in r.waits],
           "requests": [{"rid": x.rid, "prompt": x.prompt_len,
                         "max_new": x.max_new, "due": x.due - t0,
                         "submitted": x.submitted - t0,
                         "first": (x.tokens[0] - t0) if x.tokens else None,
                         "tokens": len(x.tokens),
                         "done": (x.done - t0) if x.done else None,
                         "reason": x.reason} for x in r.window_recs()]}
    with open(d / f"{cell_name}-{seed}-spans.json", "w") as f:
        json.dump(doc, f)

