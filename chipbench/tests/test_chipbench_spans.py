"""The readers of the program's own spans (``chipbench/spans.py``) on the
CPU's tiny batch-short cell, held against the harness's outside log of
the same runner calls."""
import math

import pytest

import tiny_chipbench as tiny
from chipbench import harness, spans

READERS = ("engine_self_ms.batch", "decode_issue_ms.batch",
           "decode_sync_ms.batch", "prefill_issue_ms.batch",
           "prefill_sync_ms.batch", "decode_ctx_used_pct.batch")


@pytest.fixture(scope="module")
def tiny_run():
    """One window of the tiny cell, with what the readers read of it taken
    at once (a later test clears the program's ring)."""
    setup, run = tiny.run_tiny("qwen3-4b.batch-short", seconds=1.0)
    got = {n: harness.load_reader("metrics", n)(run) for n in READERS}
    got["engine_host_ms.batch"] = harness.load_reader(
        "metrics", "engine_host_ms.batch")(run)
    return setup, run, spans.in_window(run), got


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_number(tiny_run, name):
    v = tiny_run[3][name]
    assert isinstance(v, float) and math.isfinite(v) and v >= 0.0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_the_spans_enclose_the_harness_calls_one_for_one(tiny_run, kind):
    _, run, window, _ = tiny_run
    steps = run.host_steps
    calls = [c for c in run.calls if c["kind"] == kind and c["step"] in steps]
    got = [s for s in window if s.name == f"serve.{kind}"]
    assert calls and len(got) == len(calls)
    for s, c in zip(got, calls):
        assert s.attrs["tier"] == c["tier"]
        assert s.t0 <= c["t0"] <= c["t1"] <= s.t1


def test_decode_counts_equal_the_harness_positions(tiny_run):
    setup, run, window, _ = tiny_run
    steps = run.host_steps
    calls = [c for c in run.calls if c["kind"] == "decode"
             and c["step"] in steps]
    got = [s.attrs for s in window if s.name == "serve.decode"]
    assert sum(a["ctx_used"] for a in got) == sum(c["ctx"] for c in calls)
    # every logged row attends its lane's whole gathered view
    runners = {t: lane.runner for t, lane in setup.engine._lanes.items()}
    for a, c in zip(got, calls):
        r = runners[c["tier"]]
        assert a["ctx_attended"] == c["rows"] * r.max_pages * r.page_size


def test_engine_self_time_lies_inside_the_harness_reading(tiny_run):
    got = tiny_run[3]
    assert got["engine_self_ms.batch"] <= got["engine_host_ms.batch"] + 0.5


def test_nothing_is_read_once_the_ring_lost_the_window(tiny_run):
    from repro_torch.serving import trace

    setup, run, _, _ = tiny_run
    trace.clear()
    setup.engine.step()          # the ring's first span is now after t_open
    for name in READERS:
        assert harness.load_reader("metrics", name)(run) is None, name
