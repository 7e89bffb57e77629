"""How a run's ``correct`` is decided: a sample of the requests the window
finished, held to the plain reference.

The sample is drawn from the seed among the requests that finished: the
one with the longest sequence first, then others in a seeded order, until
it holds ``check.min_tokens`` served tokens or ``check.requests``
requests. The reference (``families/<family>.py``, float32 on the
harness's own weights) runs once over each prompt followed by its served
tokens, and each served token is judged by how far its logit lies below
the reference's best at that position. Served greedily by a sound
program, a token is the reference's best or a near tie; the widest gap
over the sample is compared with the mix's ``check.max_logit_gap``.

Beside it: the tokens checked (at least ``check.min_tokens``), the
requests that ended other than ``done`` (none), and the finished streams
whose length is not the request's budget (none).

``control_gaps`` reads the control: the same reference computed with its
matrix products in float8 (e4m3), the precision a lower step would take,
at the same positions; each position's gap is that of the token the
control puts first.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(done: list, spec: dict, seed: int) -> list:
    """The checked requests (see the module docstring)."""
    if not done:
        return []
    order = sorted(done, key=lambda r: -(r.prompt_len + len(r.tokens)))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) % 2**64, 5])
    picked = [order[0]] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for r in picked:
        if n >= spec["min_tokens"] or len(out) >= spec["requests"]:
            break
        out.append(r)
        n += len(r.req.out_tokens)
    return out


def _inputs(recs, device):
    seqs, starts, served = [], [], []
    for r in recs:
        out = np.asarray(r.req.out_tokens, np.int64)
        toks = np.concatenate([np.asarray(r.req.prompt, np.int64), out[:-1]])
        seqs.append(torch.from_numpy(toks).to(device))
        starts.append(r.prompt_len - 1)
        served.append(torch.from_numpy(out).to(device))
    return seqs, starts, served


def _gap(ref, tokens):
    """How far each ``tokens[t]``'s logit lies below ``ref[t]``'s best."""
    return ref.max(-1).values - ref.gather(1, tokens[:, None])[:, 0]


def served_gaps(fam, cfg: dict, weights, recs, device) -> list:
    """Per request, the gaps of its served tokens under the reference."""
    seqs, starts, served = _inputs(recs, device)
    ref = fam.reference_logits(weights, cfg, seqs, starts)
    return [_gap(lg, s).cpu() for lg, s in zip(ref, served)]


def control_gaps(fam, cfg: dict, weights, recs, device) -> list:
    """Per request, at each served position, the gap of the control's
    first token under the reference."""
    seqs, starts, _ = _inputs(recs, device)
    ref = fam.reference_logits(weights, cfg, seqs, starts)
    ctl = fam.reference_logits(weights, cfg, seqs, starts, quant="fp8")
    return [_gap(r, c.argmax(-1)).cpu() for r, c in zip(ref, ctl)]


def run_check(cell, weights, done: list, failed: list, seed: int,
              device) -> dict:
    """The compared numbers: ``{name: {value, limit, holds, ok}}``."""
    spec = cell.mix["check"]
    recs = sample(done, spec, seed)
    gaps = served_gaps(cell.family, cell.config, weights, recs, device) \
        if recs else []
    n_tok = sum(len(g) for g in gaps)
    widest = max(float(g.max()) for g in gaps) if gaps else None
    short = sum(len(r.req.out_tokens) != r.max_new for r in done)
    out = {}

    def put(name, value, limit, holds):
        ok = value is not None and (value <= limit if holds == "<="
                                    else value >= limit)
        out[name] = {"value": value, "limit": limit, "holds": holds,
                     "ok": ok}

    put("max_logit_gap", widest, spec["max_logit_gap"], "<=")
    put("tokens_checked", n_tok, spec["min_tokens"], ">=")
    put("failed_requests", len(failed), 0, "<=")
    put("short_streams", short, 0, "<=")
    return out
