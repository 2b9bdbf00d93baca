"""The port's serving layer: paged KV cache, scheduler and engine.

- the page scatter/gather replays ``tests/golden/kvcache_golden.json`` (an
  independent dense-numpy reference) and must match it exactly;
- the port engine's tokens equal the port's solo ``Session.generate`` for
  mixed tiers, scripted late arrivals and a chunked long prompt;
- on the committed tiny qwen3-4b fixture, the port engine's tokens equal
  the JAX engine's for the same requests.
"""
import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.serving import (FakeClock, PageAllocator, ServingError,
                                 SlotAllocator, TierSpec, gather_state,
                                 pages_for, scatter_chunk, scatter_token,
                                 write_state, zero_pages)
from repro_torch.session import Session

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
POLICY = {t.name: t.policy for t in TIERS}


# ---------------------------------------------------------------------------
# paged scatter/gather vs the hand-indirected dense reference (golden)
# ---------------------------------------------------------------------------

def _leaf(path, shape, seed):
    # the generator's input recipe (content keyed by path + seed)
    rng = np.random.default_rng(zlib.crc32(path.encode()) + seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _tree(flat):
    layers = {}
    for path, arr in flat.items():
        _, i, phase, name = path.split(".")
        layers.setdefault(int(i), {}).setdefault(int(phase), {})[name] = arr
    return {"layers": [layers[i] for i in sorted(layers)]}


def _flat(tree):
    return {f"layers.{i}.{phase}.{name}": leaf
            for i, seg in enumerate(tree["layers"])
            for phase, leaves in seg.items() for name, leaf in leaves.items()}


def _golden_replay():
    with open(os.path.join(GOLDEN, "kvcache_golden.json")) as f:
        g = json.load(f)
    n_seg = 1 + max(int(p.split(".")[1]) for p in g["leaves"])
    paged = [set() for _ in range(n_seg)]
    for p in g["paged"]:
        paged[int(p.split(".")[1])].add(int(p.split(".")[2]))
    layout = tuple(frozenset(s) for s in paged)
    ps = g["page_size"]
    pool = _tree({p: _leaf(p, tuple(s), 0) for p, s in g["leaves"].items()})
    for op in g["script"]:
        if op["op"] == "zero_pages":
            zero_pages(pool, layout, op["pages"])
            continue
        dense = _tree({p: _leaf(p, tuple(s), op["seed"])
                       for p, s in op["dense"].items()})
        if op["op"] == "write_state":
            write_state(pool, layout, dense, op["slot"],
                        torch.tensor(op["table"]), ps)
        elif op["op"] == "scatter_chunk":
            scatter_chunk(pool, layout, dense, torch.tensor(op["table"]),
                          op["start"], op["length"], ps)
        elif op["op"] == "scatter_token":
            scatter_token(pool, layout, dense, torch.tensor(op["tables"]),
                          torch.tensor(op["pos"]), ps)
        else:
            raise AssertionError(f"unknown golden op {op['op']!r}")
    return g, layout, pool


def test_paged_script_and_gathers_match_golden():
    g, layout, pool = _golden_replay()
    flat = _flat(pool)
    assert set(flat) == set(g["pool"])
    for p, want in g["pool"].items():
        np.testing.assert_array_equal(flat[p].numpy(),
                                      np.asarray(want, np.float32), err_msg=p)
    for tables, want in zip(g["gathers"], g["gather"]):
        got = _flat(gather_state(pool, layout, torch.tensor(tables)))
        for p in g["paged"]:
            np.testing.assert_array_equal(got[p].numpy(),
                                          np.asarray(want[p], np.float32))
        for p in set(g["leaves"]) - set(g["paged"]):   # per-slot pass through
            assert torch.equal(got[p], flat[p])


def test_page_and_slot_allocators():
    a = SlotAllocator(2)
    assert [a.alloc("r0"), a.alloc("r1")] == [0, 1]
    with pytest.raises(ServingError, match="exhausted"):
        a.alloc("r2")
    a.free(0)
    assert a.alloc("r2") == 0
    pages = PageAllocator(4)
    pages.reserve("a", 3)
    assert not pages.can_reserve(2) and pages.can_reserve(1)
    assert [pages.take_page("a"), pages.take_page("a")] == [0, 1]
    with pytest.raises(ServingError, match="exhausted"):
        pages.reserve("b", 2)
    assert pages.release("a") == [0, 1] and pages.n_unreserved == 4
    assert pages_for(17, 16) == 2 and pages_for(16, 16) == 1


# ---------------------------------------------------------------------------
# engine vs solo generate (the port's own seeded tiny model)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_session():
    return Session("qwen3-4b", device="cpu")


def _check_against_solo(session, reqs):
    for req in reqs:
        solo = session.replace(policy=POLICY[req.tier]).generate(
            prompts=req.prompt[None], gen_len=req.max_new_tokens)
        np.testing.assert_array_equal(
            req.result(), solo.tokens[0],
            err_msg=f"{req.id} ({req.tier}) diverged from solo generate")


def _run_scripted(eng, clock, script):
    reqs = []
    for arrivals in script:
        reqs += [eng.submit(**a) for a in arrivals]
        eng.step()
        clock.advance(1.0)
    eng.run()
    return reqs


def test_mixed_tiers_and_late_arrivals_equal_solo(port_session, rng):
    clock = FakeClock()
    eng = port_session.serving_engine(TIERS, slots=2, max_len=16, clock=clock)
    script = [
        [dict(prompt=rng.integers(0, 256, 5), tier="premium", max_new_tokens=4),
         dict(prompt=rng.integers(0, 256, 6), tier="bulk", max_new_tokens=5)],
        [],
        [dict(prompt=rng.integers(0, 256, 7), tier="premium", max_new_tokens=3),
         dict(prompt=rng.integers(0, 256, 4), tier="standard", max_new_tokens=6)],
        [dict(prompt=rng.integers(0, 256, 3), tier="premium", max_new_tokens=5),
         dict(prompt=rng.integers(0, 256, 4), tier="bulk", max_new_tokens=4)],
    ]
    reqs = _run_scripted(eng, clock, script)
    assert all(r.done for r in reqs)
    _check_against_solo(port_session, reqs)


def test_chunked_long_prompt_equals_solo(port_session, rng):
    clock = FakeClock()
    eng = port_session.serving_engine(TIERS, slots=2, max_len=32, page_size=4,
                                      prefill_chunk=5, clock=clock)
    script = [
        [dict(prompt=rng.integers(0, 256, 4), tier="premium", max_new_tokens=8)],
        [dict(prompt=rng.integers(0, 256, 13), tier="premium",
              max_new_tokens=4),
         dict(prompt=rng.integers(0, 256, 11), tier="standard",
              max_new_tokens=3)],
    ]
    reqs = _run_scripted(eng, clock, script)
    _check_against_solo(port_session, reqs)
    prem = eng.lane_stats()["premium"]
    assert prem.n_prefill_chunks >= 1 + 3      # short (1) + long (ceil 13/5)
    assert prem.n_interleave_steps >= 1        # chunks ran beside decode
    assert prem.n_decode_stall_steps == 0
    assert reqs[0].n_reserved_pages == pages_for(4 + 8 - 1, 4)


# ---------------------------------------------------------------------------
# port engine vs JAX engine on the committed fixture
# ---------------------------------------------------------------------------

def test_port_engine_tokens_equal_jax_engine(rng):
    from repro.serving import TierSpec as JaxTier
    from repro.session import Session as JaxSession

    js = JaxSession.from_pretrained(
        "qwen3-4b", os.path.join(GOLDEN, "compat", "qwen3-4b"))
    params = params_from_numpy(jax.tree.map(np.asarray, js.params),
                               get_arch("qwen3-4b").reduced(), "cpu")
    ts = Session("qwen3-4b", params=params, device="cpu")
    reqs = [(rng.integers(0, 256, n), tier, k) for n, tier, k in
            [(9, "premium", 4), (4, "standard", 5), (6, "bulk", 3),
             (7, "standard", 4)]]
    tiers_j = tuple(JaxTier(t.name, t.policy, t.priority) for t in TIERS)
    eng_j = js.serving_engine(tiers_j, slots=2, max_len=16, page_size=4,
                              prefill_chunk=5)
    eng_t = ts.serving_engine(TIERS, slots=2, max_len=16, page_size=4,
                              prefill_chunk=5)
    out_j = [eng_j.submit(p, tier=t, max_new_tokens=k) for p, t, k in reqs]
    out_t = [eng_t.submit(p, tier=t, max_new_tokens=k) for p, t, k in reqs]
    eng_j.run()
    eng_t.run()
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.result(), b.result(), err_msg=a.id)
