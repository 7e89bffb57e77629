"""The plain reference against the port on the CPU, at the port's smoke
configurations in float32: the port's prefill logits, and greedy streams
served through ``LLMEngine`` from the paged pool (yi-34b's smoke config)
and from the ring (h2o-danube-1.8b's, prompts past its window)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import check
from bench.accounting import Rec
from bench.harness import load_module

BENCH = Path(__file__).resolve().parent
dense = load_module(BENCH / "families" / "dense.py", "bench_family_dense")


def as_file(mc) -> dict:
    """The configuration file of a port ``ModelConfig``."""
    return {"family": "dense", "hidden_size": mc.d_model,
            "intermediate_size": mc.d_ff, "num_hidden_layers": mc.n_layers,
            "num_attention_heads": mc.n_heads,
            "num_key_value_heads": mc.n_kv_heads, "vocab_size": mc.vocab,
            "sliding_window": mc.window, "rms_norm_eps": 1e-5,
            "rope_theta": mc.rope_theta, "torch_dtype": "float32"}


def smoke(arch):
    from repro_torch import configs
    from repro_torch.configs.base import ModelConfig
    c = as_file(configs.smoke(arch))
    return c, ModelConfig(**dense.port_config(c, arch))


@pytest.mark.parametrize("arch,n", [("yi-34b", 40), ("h2o-danube-1.8b", 150)])
def test_port_prefill_logits_match_the_reference(arch, n):
    from repro_torch.models import registry
    c, mc = smoke(arch)
    w = dense.draw_weights(c, 7, "cpu")
    tok = torch.randint(0, mc.vocab, (n,), generator=torch.Generator()
                        .manual_seed(1))
    logits, _ = registry.prefill(w, mc, tok[None])
    ref = dense.reference_logits(w, c, [tok], [n - 1])[0]
    assert torch.allclose(logits[0, :mc.vocab].float(), ref[0], atol=1e-4,
                          rtol=1e-4)
    # the windowed config: the last position's logits move with a token
    # inside the window and not with one before it
    if mc.window:
        far, near = tok.clone(), tok.clone()
        far[0] = (far[0] + 1) % mc.vocab
        near[n - 2] = (near[n - 2] + 1) % mc.vocab
        base = ref[0]
        assert torch.equal(dense.reference_logits(w, c, [far], [n - 1])[0][0],
                           base)
        assert not torch.allclose(
            dense.reference_logits(w, c, [near], [n - 1])[0][0], base)


@pytest.mark.parametrize("arch,paged", [("yi-34b", True),
                                        ("h2o-danube-1.8b", False)])
def test_served_streams_match_the_reference(arch, paged):
    from repro_torch.serving.api import LLMEngine
    c, mc = smoke(arch)
    w = dense.draw_weights(c, 2**32 + 9, "cpu")
    rng = np.random.default_rng(3)
    lens = [20, 70, 100, 140] if mc.window else [20, 33, 48, 64]
    prompts = [rng.integers(0, mc.vocab, n) for n in lens]
    llm = LLMEngine(w, mc, slots=2, max_seq=256, paged=paged, device="cpu")
    outs = llm.generate(prompts, max_new_tokens=24)
    recs = []
    for p, o in zip(prompts, outs):
        assert o.finish_reason == "done" and len(o.tokens) == 24
        req = dataclasses.make_dataclass("R", ["prompt", "out_tokens"])(
            p, o.tokens)
        recs.append(Rec(o.rid, len(p), 24, 0.0, tokens=[0.0] * 24,
                        reason="done", req=req))
    gaps = check.served_gaps(dense, c, w, recs, "cpu")
    assert sum(len(g) for g in gaps) == 96
    assert max(float(g.max()) for g in gaps) < 1e-4
    # an altered token is caught
    recs[1].req.out_tokens = list(recs[1].req.out_tokens)
    recs[1].req.out_tokens[5] = (recs[1].req.out_tokens[5] + 1) % mc.vocab
    assert float(check.served_gaps(dense, c, w, recs[1:2], "cpu")[0].max()) \
        > 1e-2
