"""The end-to-end and per-layer arithmetic on a synthetic event log."""
import math

import pytest

import tiny_chipbench as tiny
from chipbench import harness, stats


def _run(reqs, steps=(), calls=()):
    cell = tiny.cell("qwen3-4b.rag-long")
    run = harness.Run(cell=cell, seconds=10.0, t_start=0.0)
    run.t_open, run.t_end, run.t_close = 100.0, 110.0, 110.5
    for i, (due, toks, finish, max_new) in enumerate(reqs):
        r = harness.Req(f"q{i}", "standard", due, 8, max_new, submit=due,
                        admit=due + 0.1 if toks else math.nan,
                        tokens=list(toks), finish=finish)
        run.reqs[r.rid] = r
    run.steps = list(steps)
    run.calls = list(calls)
    return run


def test_percentile_is_linear_between_ranks():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([5], 90) == 5
    assert stats.percentile(range(11), 90) == pytest.approx(9.0)


def test_ttft_counts_from_due_and_keeps_the_unserved():
    run = _run([(99.0, [101.0], 101.5, 2),          # due before: not counted
                (100.0, [101.0, 101.2], 101.2, 2),  # 1.0 s
                (105.0, [], math.nan, 2),           # unserved: 110.5 - 105
                (109.0, [111.0], math.nan, 4)])     # first token after close
    assert sorted(stats.ttft_s(run)) == pytest.approx([1.0, 1.5, 5.5])
    read = harness.load_reader("e2e", "ttft_p90_ms")
    assert read(run) == pytest.approx(1e3 * stats.percentile([1.0, 1.5, 5.5],
                                                             90))


def test_itl_counts_gaps_landing_in_the_window_and_open_ones():
    run = _run([(90.0, [99.0, 99.5, 100.4, 100.6], 100.6, 4),
                (101.0, [102.0, 102.3], math.nan, 5),
                (108.0, [110.2], 110.2, 1)])
    got = sorted(stats.gaps_s(run))
    # 99.5 -> 100.4 lands in the window, 99.0 -> 99.5 does not; the
    # second request's gap at the close is 110.5 - 102.3
    assert got == pytest.approx(sorted([0.9, 0.2, 0.3, 8.2]))


def test_out_tok_s_counts_tokens_in_the_window():
    run = _run([(90.0, [99.0, 100.4, 100.6], 100.6, 3),
                (101.0, [102.0, 110.4, 110.6], math.nan, 5)])
    read = harness.load_reader("e2e", "out_tok_s")
    assert read(run) == pytest.approx(4 / 10.5)


def test_setup_engine_and_call_readers():
    steps = [dict(t0=99.0, t1=100.2, runner_s=1.0, traced=False),
             dict(t0=100.2, t1=100.7, runner_s=0.4, traced=False),
             dict(t0=100.7, t1=101.0, runner_s=0.2, traced=False)]
    calls = [dict(kind="decode", tier="premium", step=1, t0=100.2, t1=100.4,
                  rows=16, tokens=3, ctx=30, traced=False),
             dict(kind="prefill", tier="bulk", step=1, t0=100.4, t1=100.6,
                  rows=512, tokens=512, ctx=512 * 513 // 2, traced=False),
             dict(kind="decode", tier="premium", step=2, t0=100.7, t1=100.9,
                  rows=16, tokens=3, ctx=33, traced=False),
             dict(kind="decode", tier="premium", step=0, t0=99.0, t1=99.9,
                  rows=16, tokens=3, ctx=27, traced=False)]
    run = _run([(100.0, [100.5], 100.5, 1)], steps, calls)
    run.t_start = 70.0
    assert harness.load_reader("e2e", "setup_s")(run) == pytest.approx(30.0)
    assert harness.load_reader("metrics", "engine_host_ms.rag")(run) == \
        pytest.approx(1e3 * (0.1 + 0.1) / 2)
    assert harness.load_reader("metrics", "decode_call_ms.batch")(run) == \
        pytest.approx(200.0)
    assert harness.load_reader("metrics", "prefill_call_ms.rag")(run) == \
        pytest.approx(200.0)
    assert harness.load_reader("metrics", "admit_wait_p90_ms.rag")(run) == \
        pytest.approx(100.0)
    run.peaks = (989e12, 67e12, 3.35e12)
    from chipbench.work import model_flops

    want = model_flops(run.cell.config, 518, 30 + 33 + 512 * 513 // 2)
    assert harness.load_reader("metrics", "step_mfu_pct.rag")(run) == \
        pytest.approx(100 * want / (0.8 * 989e12))


def test_trace_readers_need_a_trace():
    run = _run([])
    for name in ("k1_roofline_pct.rag", "device_idle_pct.batch"):
        assert harness.load_reader("metrics", name)(run) is None
    run.trace = {"busy_s": 3.0, "window_s": 4.0, "k1_kernels": 0, "k1_s": 0}
    assert harness.load_reader("metrics", "device_idle_pct.rag")(run) == 25.0


def test_a_whole_prefill_is_logged_as_a_prefill():
    class Runner:
        n_slots, n_pages = 2, 8

        def decode(self, tokens, pos, tables):
            return tokens

        def prefill_chunk_step(self, prompt, start, end, table_row):
            return None

        def prefill_full(self, slot, prompt, table_row):
            return 7

    runner = Runner()
    run = _run([])
    harness._wrap(runner, "bulk", [run], {"tracing": False, "step": 3})
    assert runner.prefill_full(1, list(range(5)), [0]) == 7
    (rec,) = run.calls
    assert (rec["kind"], rec["tier"], rec["step"], rec["rows"],
            rec["tokens"], rec["ctx"]) == ("prefill", "bulk", 3, 5, 5, 15)
