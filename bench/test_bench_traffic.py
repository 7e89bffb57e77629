"""The traffic generator: a mix repeats per seed, keeps its clips, gives
every seed the same block of lengths and gaps, started at another place
and with other token ids, and ages a closed loop's first wave, the same
for every seed."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench.traffic import BLOCK, Traffic, lognormal_lengths

MIXES = Path(__file__).resolve().parent / "mixes"
SEEDS = (0, 2**31 + 7, 2**40 + 3, -5)


def mixes():
    return sorted(p.stem for p in MIXES.glob("*.json"))


@pytest.mark.parametrize("name", mixes())
def test_mix_repeats_per_seed_and_keeps_clips(name):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    for seed in SEEDS:
        a, b = (Traffic(mix, seed, 1000, 8192) for _ in range(2))
        items = [a.item(i) for i in range(200)]
        assert items == [b.item(i) for i in range(200)]
        assert all(np.array_equal(a.prompt(it), b.prompt(it))
                   for it in items[:5])
        for it in items:
            assert mix["prompt"]["min"] <= it.prompt_len \
                <= mix["prompt"]["max"]
            assert mix["output"]["min"] <= it.max_new \
                <= mix["output"]["max"]
        ids = a.prompt(items[0])
        assert ids.min() >= 0 and ids.max() < 1000
        if mix["loop"] == "open":
            due = [it.due for it in items]
            assert all(x < y for x, y in zip(due, due[1:]))
    one, two = Traffic(mix, 1, 1000, 8192), Traffic(mix, 2, 1000, 8192)
    assert not np.array_equal(one.prompt(one.item(0)),
                              two.prompt(two.item(0)))


@pytest.mark.parametrize("name", mixes())
def test_every_seed_gets_the_same_block_rotated(name):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    block = BLOCK
    streams, offsets = [], set()
    for seed in range(40):
        tr = Traffic(mix, seed, 1000, 8192)
        offsets.add(tr.offset)
        its = [tr.item(i) for i in range(3 * block)]
        gaps = np.diff([0.0] + [it.due for it in its])
        rows = [(it.prompt_len, it.max_new, round(g, 9))
                for it, g in zip(its, gaps)]
        # the stream repeats its block, and the block is the same
        assert rows[:block] == rows[block:2 * block]
        k = rows.index(streams[0][0]) if streams else 0
        streams.append(rows[k:k + block] if streams else rows[:block])
        if mix["loop"] == "open":
            # the mean gap of a block is the mix's rate
            assert abs(gaps[:block].mean() * mix["rate_per_s"] - 1) < 0.05
    assert all(s == streams[0] for s in streams)
    assert len(offsets) > 1


def test_lognormal_block_has_the_median_and_clips():
    spec = {"median": 512, "sigma": 0.9, "min": 64, "max": 1536}
    x = lognormal_lengths(spec, 64)
    assert np.median(x) == pytest.approx(512, rel=0.05)
    assert x.min() >= 64 and x.max() == 1536


def test_first_wave_is_aged_and_fits():
    mix = json.loads((MIXES / "danube-reasoning-backlog.json").read_text())
    tr = Traffic(mix, 11, 32000, 8192)
    wave = tr.first_wave()
    assert len(wave) == mix["clients"]
    grown = [w.prompt_len - tr.item(w.index, offset=0).prompt_len
             for w in wave]
    assert min(grown) < 50 and max(grown) > 1000
    for w, g in zip(wave, grown):
        assert w.max_new + g == tr.item(w.index, offset=0).max_new
        assert w.max_new >= 2 and w.prompt_len + w.max_new <= 8191
    assert max(tr.warm_lengths()) == max(w.prompt_len for w in wave)


@pytest.mark.parametrize("name", [n for n in mixes() if json.loads(
    (MIXES / f"{n}.json").read_text())["loop"] == "closed"])
def test_first_wave_is_the_same_for_every_seed(name):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    waves, offsets = set(), set()
    for seed in SEEDS + tuple(range(20)):
        tr = Traffic(mix, seed, 1000, 8192)
        offsets.add(tr.offset)
        waves.add(tuple((w.prompt_len, w.max_new, w.client)
                        for w in tr.first_wave()))
    assert len(waves) == 1 and len(offsets) > 1
