"""The family's byte and FLOP counts against hand numbers."""

import json
from pathlib import Path

import pytest
import torch

from bench.harness import load_module

BENCH = Path(__file__).resolve().parent
dense = load_module(BENCH / "families" / "dense.py", "bench_family_dense")


def cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_yi_34b_bytes():
    c = cfg("yi-34b")
    # 60 x 557.8 M in the layers, 2 x 64,000 x 7,168 in the embedding and
    # the head, bf16; the norms in fp32
    assert dense.layer_matmul_params(c) == 557_842_432
    assert dense.weight_bytes(c) == 60 * 557_842_432 * 2 \
        + 2 * 64000 * 7168 * 2 + 121 * 7168 * 4
    assert dense.weight_bytes(c) / 1e9 == pytest.approx(68.78, abs=0.005)
    assert dense.kv_row_bytes(c) == 245_760


def test_danube_bytes_and_window():
    c = cfg("h2o-danube-1.8b")
    assert dense.kv_row_bytes(c) == 61_440
    assert dense.weight_bytes(c) / 1e9 == pytest.approx(3.66, abs=0.01)
    assert dense.attended_rows(c, 100) == 101
    assert dense.attended_rows(c, 5000) == 4096


def test_flops_add_up():
    c = cfg("h2o-danube-1.8b")
    for n in (10, 4096, 5000):
        by_token = sum(dense.token_flops(c, dense.attended_rows(c, i),
                                         head=False) for i in range(n))
        head = 2 * 2560 * 32000
        assert dense.prefill_flops(c, n) == pytest.approx(by_token + head)
    f, b = dense.decode_attn_work(c, 4096)
    assert f == 4 * 24 * 32 * 80 * 4096
    assert b == 4096 * 61_440 + 24 * 2 * 32 * 80 * 2


def test_drawn_weights_have_the_served_layout():
    c = dict(cfg("yi-34b"), num_hidden_layers=2, hidden_size=256,
             num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=64, vocab_size=300)
    w = dense.draw_weights(c, 2**33 + 1, "cpu")
    w2 = dense.draw_weights(c, 2**33 + 1, "cpu")
    lay = w["layers"][1]
    assert lay["attn"]["wq"].shape == (256, 2, 128)
    assert lay["attn"]["wk"].shape == (256, 1, 128)
    assert lay["mlp"]["w_gateup"].shape == (256, 128)
    assert lay["attn"]["wq"].dtype == torch.bfloat16
    assert lay["attn_norm"].dtype == torch.float32
    assert w["embed"].shape == (512, 256) and w["lm_head"].shape == (256, 512)
    assert lay["mlp"]["w_down"].is_contiguous()
    assert torch.equal(w["lm_head"], w2["lm_head"])
    total = sum(t.numel() * t.element_size() for t in (
        w["embed"], w["lm_head"], w["final_norm"])) + sum(
        t.numel() * t.element_size() for lay in w["layers"]
        for t in (*lay["attn"].values(), *lay["mlp"].values(),
                  lay["attn_norm"], lay["mlp_norm"]))
    assert total == dense.weight_bytes(c)
