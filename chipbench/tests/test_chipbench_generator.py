"""The traffic generator: deterministic in the seed, the same work for
every seed in its own order, and each mix file's parameters met."""
import collections
import json
import math
import pathlib

import numpy as np
import pytest

import tiny_chipbench  # noqa: F401  (puts the repo on sys.path)
from chipbench import generator

MIXES = sorted((pathlib.Path(__file__).resolve().parents[1] / "traffic")
               .glob("*.json"))
SEEDS = (1, 2 ** 31 + 17, 2 ** 40 + 3)


def _mix(path):
    return json.loads(path.read_text())


def _summary(reqs):
    return (sorted(len(r.prompt) for r in reqs), sorted(r.max_new for r in reqs),
            collections.Counter(r.tier for r in reqs))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = _mix(path)
    a = generator.generate(mix, SEEDS[1], 20.0, 151936)
    b = generator.generate(mix, SEEDS[1], 20.0, 151936)
    assert [(r.rid, r.tier, r.due, r.max_new) for r in a] == \
        [(r.rid, r.tier, r.due, r.max_new) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seeds_share_the_work_in_another_order(path):
    mix = _mix(path)
    runs = [generator.generate(mix, s, 20.0, 151936) for s in SEEDS]
    sums = [_summary(r) for r in runs]
    assert sums[0] == sums[1] == sums[2]
    gaps = [sorted(np.round(np.diff([0.0] + [r.due for r in reqs]), 9))
            for reqs in runs]
    assert gaps[0] == gaps[1] == gaps[2]
    order = [[(r.due, r.tier, len(r.prompt), r.max_new) for r in reqs]
             for reqs in runs]
    # each seed deals its own order
    assert order[0] != order[1] and order[1] != order[2]
    assert not np.array_equal(runs[0][0].prompt[:8], runs[1][0].prompt[:8])


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_mix_parameters_are_met(path):
    mix = _mix(path)
    seconds, vocab = 30.0, 151936
    reqs = generator.generate(mix, 5, seconds, vocab)
    n = len(reqs)
    for key, get in (("prompt_tokens", lambda r: len(r.prompt)),
                     ("output_tokens", lambda r: r.max_new)):
        spec = mix[key]
        v = np.array([get(r) for r in reqs])
        assert v.min() >= spec["min"] and v.max() <= spec["max"]
        assert abs(np.median(v) - spec["median"]) <= 0.05 * spec["median"] + 1
    assert all(0 <= r.prompt.min() and r.prompt.max() < vocab for r in reqs)
    eng = mix["engine"]
    assert max(len(r.prompt) + r.max_new - 1 for r in reqs) <= eng["max_len"]
    arr = mix["arrival"]
    tiers = collections.Counter(r.tier for r in reqs)
    if arr["kind"] == "poisson":
        span = arr["load_in_s"] + seconds
        assert n == round(arr["rate_rps"] * arr["load_in_s"]) + \
            round(arr["rate_rps"] * seconds)
        for t, share in mix["tiers"].items():
            assert abs(tiers[t] - share * n) <= 2
        dues = np.array([r.due for r in reqs])
        assert dues[0] > 0.0 and np.all(np.diff(dues) >= 0)
        assert dues[-1] == pytest.approx(span)
        # the window's own set: exactly rate x seconds requests in it
        inside = dues > arr["load_in_s"] + 1e-9
        assert inside.sum() == round(arr["rate_rps"] * seconds)
    else:
        assert all(r.due == 0.0 for r in reqs)
        assert all(c == arr["per_tier"] for c in tiers.values())
        assert set(tiers) == set(mix["tiers"])


@pytest.mark.parametrize("path", [p for p in MIXES if _mix(p)["arrival"]
                                  ["kind"] == "poisson"], ids=lambda p: p.stem)
def test_every_seed_offers_the_window_the_same_work(path):
    mix = _mix(path)
    t0 = mix["arrival"]["load_in_s"]
    sets = [_summary([r for r in generator.generate(mix, s, 30.0, 1000)
                      if r.due > t0 + 1e-9]) for s in SEEDS]
    assert sets[0] == sets[1] == sets[2]


def test_deal_is_a_plain_seeded_permutation():
    items = list(range(100))
    a = generator.deal(items, np.random.default_rng(0))
    assert sorted(a) == items
    assert a == [items[i] for i in np.random.default_rng(0).permutation(100)]
    assert a != generator.deal(items, np.random.default_rng(1))
