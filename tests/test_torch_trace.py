"""The port's serving spans (``repro_torch.serving.trace``).

On the reduced qwen3-4b engine: the engine and the lane runner record
exactly ``serve.step`` / ``serve.prefill`` / ``serve.decode`` /
``serve.sync``, nested as the calls are; the decode spans' counts equal
the requests' positions worked out by hand, and no layer takes the fused
decode kernel on the CPU; ``TierStats`` holds the same
readings as the spans; no ``record_function`` is entered unless a
profiler runs, and under one the profiler's events carry the spans; the
ring keeps its last ``CAPACITY`` spans; a callee's counts land on the
innermost open span.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.serving import FakeClock, TierSpec, trace
from repro_torch.session import Session

TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
NAMES = {"serve.step", "serve.prefill", "serve.decode", "serve.sync"}


@pytest.fixture(scope="module")
def port_session():
    return Session("qwen3-4b", device="cpu")


def _engine(session, **kw):
    return session.serving_engine(TIERS, slots=2, max_len=16, page_size=4,
                                  clock=FakeClock(), **kw)


def _serve(eng, rng, reqs):
    """Submit ``(tier, prompt length, max_new)`` and run to the end; the
    spans recorded meanwhile."""
    trace.clear()
    handles = [eng.submit(rng.integers(0, 256, n), tier=tier,
                          max_new_tokens=k) for tier, n, k in reqs]
    eng.run()
    assert all(h.done for h in handles)
    return trace.spans()


def test_steps_record_the_four_spans_nested(port_session, rng):
    # a 13-token prompt in chunks of 5: two chunks with no token, one with
    eng = _engine(port_session, prefill_chunk=5)
    got = _serve(eng, rng, [("premium", 13, 3), ("bulk", 4, 2)])
    assert {s.name for s in got} == NAMES
    by_index = {s.index: s for s in got}
    for s in got:
        parent = by_index.get(s.parent)
        if s.name == "serve.step":
            assert s.parent is None
        elif s.name == "serve.sync":
            assert parent.name in ("serve.decode", "serve.prefill")
        else:
            assert parent.name == "serve.step"
        if parent is not None:
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    prefills = [s for s in got if s.name == "serve.prefill"]
    synced = {s.parent for s in got if s.name == "serve.sync"}
    # a prefill syncs only where the prompt completes: premium's chunks
    # [0, 5), [5, 10), [10, 13) in steps 1-3, bulk's whole prompt in step 1
    assert [(s.attrs["tier"], s.index in synced) for s in prefills] == [
        ("premium", False), ("bulk", True), ("premium", False),
        ("premium", True)]
    assert all(s.index in synced for s in got if s.name == "serve.decode")
    steps = [s for s in got if s.name == "serve.step"]
    assert [by_index[p.parent] for p in prefills] == \
        [steps[0], steps[0], steps[1], steps[2]]


def test_decode_counts_equal_the_positions_by_hand(port_session, rng):
    eng = _engine(port_session)
    got = _serve(eng, rng, [("premium", 5, 3), ("premium", 3, 2),
                            ("bulk", 4, 3)])
    dec = [(s.attrs["tier"], s.attrs["ctx_used"], s.attrs["ctx_attended"])
           for s in got if s.name == "serve.decode"]
    # step 1: both premium prompts land their first token, then one decode
    # at positions 5 and 3 (6 + 4 attended); the 2-token request retires;
    # step 2: position 6 alone.  bulk: positions 4, then 5.  Every call
    # gathers 2 rows x 4 pages x 4 positions.
    assert dec == [("premium", 10, 32), ("bulk", 5, 32),
                   ("premium", 7, 32), ("bulk", 6, 32)]
    # the runner counts the view it gathers, not the engine's sizing: a
    # table of 2 pages a row attends 2 x 2 x 4 positions
    runner = eng._lanes["premium"].runner
    tables = np.full((2, 2), runner.n_pages, np.int32)
    with trace.span("outer") as sp:
        runner.decode(np.zeros(2, np.int32), np.zeros(2, np.int32), tables)
    assert sp.attrs == {"ctx_attended": 16, "attn_kernel_layers": 0}


def test_no_decode_layer_takes_the_fused_kernel_on_the_cpu(port_session,
                                                           rng):
    # the runner counts the layers whose attention core took the fused
    # decode kernel: on the card every attention layer of a decode call,
    # here none (the plain chain runs on CPU tensors)
    eng = _engine(port_session)
    got = _serve(eng, rng, [("premium", 5, 3), ("bulk", 4, 3)])
    dec = [s.attrs["attn_kernel_layers"] for s in got
           if s.name == "serve.decode"]
    assert dec == [0, 0, 0, 0]
    assert all("attn_kernel_layers" not in s.attrs for s in got
               if s.name != "serve.decode")


def test_tier_stats_hold_the_spans_durations(port_session, rng):
    eng = _engine(port_session, prefill_chunk=5)
    got = _serve(eng, rng, [("premium", 13, 4), ("standard", 7, 3),
                            ("bulk", 9, 2)])
    want = collections.defaultdict(lambda: [0.0, 0.0])
    for s in got:
        if s.name in ("serve.decode", "serve.prefill"):
            want[s.attrs["tier"]][s.name == "serve.prefill"] += s.t1 - s.t0
    stats = eng.lane_stats()
    assert {t: [st.decode_s, st.prefill_s] for t, st in stats.items()} \
        == dict(want)
    assert sum(s.name == "serve.decode" for s in got) == \
        sum(st.n_decode_steps for st in stats.values())
    assert sum(s.name == "serve.prefill" for s in got) == \
        sum(st.n_prefill_chunks for st in stats.values())


class _Counting:
    calls = 0

    def __init__(self, name):
        type(self).calls += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_record_function_without_a_profiler(port_session, rng,
                                               monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(_Counting, "calls", 0)
    eng = _engine(port_session)
    assert not trace.profiling()
    got = _serve(eng, rng, [("premium", 5, 3), ("bulk", 4, 2)])
    assert got and _Counting.calls == 0
    # the same path with the flag up enters one per span: the count above
    # watches the call the spans make
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    got = _serve(eng, rng, [("premium", 5, 3)])
    assert _Counting.calls == len(got) > 0


def test_the_profiler_holds_the_spans_nested(port_session, rng):
    eng = _engine(port_session)
    eng.submit(rng.integers(0, 256, 5), tier="premium", max_new_tokens=3)
    assert not trace.profiling()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.profiling()
        eng.step()
        eng.step()
    assert not trace.profiling()
    assert not torch.autograd.profiler._is_profiler_enabled
    ev = [e for e in prof.events() if e.name.startswith("serve.")]
    parent = {e.name: collections.Counter() for e in ev}
    for e in ev:
        parent[e.name][e.cpu_parent.name if e.cpu_parent else None] += 1
    assert parent == {
        "serve.step": {None: 2},
        "serve.prefill": {"serve.step": 1},
        "serve.decode": {"serve.step": 2},
        "serve.sync": {"serve.prefill": 1, "serve.decode": 2}}


def test_the_ring_drops_its_oldest_and_keeps_counting():
    trace.clear()
    n = trace.CAPACITY + 5
    for i in range(n):
        with trace.span("t", i=i):
            pass
    got = trace.spans()
    assert len(got) == trace.CAPACITY
    assert [s.attrs["i"] for s in (got[0], got[-1])] == [5, n - 1]
    # the spans' index counts on past the bound
    assert np.all(np.diff([s.index for s in got]) == 1)
    trace.clear()
    assert trace.spans() == []


def test_counts_land_on_the_innermost_open_span():
    trace.clear()
    trace.count(n=1)             # no span open: nothing recorded
    with trace.span("outer", a=1):
        with trace.span("inner"):
            trace.count(n=2)
        trace.count(m=3)
    assert [(s.name, s.attrs) for s in trace.spans()] == [
        ("inner", {"n": 2}), ("outer", {"a": 1, "m": 3})]
