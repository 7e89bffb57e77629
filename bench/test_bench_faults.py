"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference with its products in float8) fails where
the sound program passes. Both on the CPU at a size a test run holds;
the harness's look for a card is skipped (``device="cpu"``)."""

import time

import pytest
import torch

from bench import check, harness
from bench.conftest import make_root


def alter_decoded_tokens(run):
    """A token altered where it is produced: after every third decode
    step, each active slot's emitted token is replaced by its successor
    in the vocabulary."""
    eng = run.eng
    body, calls = eng._run_step, [0]
    vocab = eng.cfg.vocab

    def broken():
        body()
        calls[0] += 1
        tok = eng._emit[0]
        if calls[0] % 3 == 0:
            tok.copy_(torch.where(tok >= 0, (tok + 1) % vocab, tok))
    eng._run_step = broken


@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_an_altered_token_makes_the_run_incorrect(tiny_root, cell):
    ok = harness.run(tiny_root, cell, 2**31 + 1, 2.0, False, "cpu",
                     time.perf_counter())
    assert ok["correct"], ok["checks"]
    bad = harness.run(tiny_root, cell, 2**31 + 1, 2.0, False, "cpu",
                      time.perf_counter(), fault=alter_decoded_tokens)
    assert not bad["correct"]
    assert bad["checks"]["max_logit_gap"]["value"] > 1e-2


@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_the_control_fails_where_the_program_passes(tmp_path, cell,
                                                    monkeypatch):
    """bf16 program against the float8 control, both judged by the float32
    reference on the same sample (up to 80 served tokens): the control's
    widest gap is over three times the program's and over the limit 0.04
    that the program keeps."""
    root = make_root(tmp_path, dtype="bfloat16", limit=0.04, min_tokens=80)
    seen = {}
    real = check.run_check

    def spy(cell_, weights, done, failed, seed, dev):
        recs = check.sample(done, cell_.mix["check"], seed)
        seen["control"] = max(float(g.max()) for g in check.control_gaps(
            cell_.family, cell_.config, weights, recs, dev))
        return real(cell_, weights, done, failed, seed, dev)
    monkeypatch.setattr(check, "run_check", spy)
    for seed in (1, 2, 3):
        res = harness.run(root, cell, seed, 2.0, False, "cpu",
                          time.perf_counter())
        prog = res["checks"]["max_logit_gap"]["value"]
        assert res["checks"]["tokens_checked"]["value"] >= 30
        assert prog <= 0.04
        assert seen["control"] > max(3 * prog, 0.04), (prog, seen)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(64, 256)
    from bench.harness import load_module
    from pathlib import Path
    fam = load_module(Path(check.__file__).parent / "families" / "dense.py",
                      "bench_family_dense")
    e8 = (fam._fp8(x, -1) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 4 * e16
