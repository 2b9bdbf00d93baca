"""The K1 reckoning (calls, shapes, passes) against the launches of a run
of the tiny cell on the CPU, with K1's entry swapped for a counting plain
version (the kernel route's calls, as on the card)."""
import collections

import pytest
import torch

import tiny_chipbench as tiny
from chipbench import work


@pytest.fixture
def counted_k1(monkeypatch):
    from repro_torch.kernels import afpm_matmul as k1mod
    from repro_torch.kernels import custom_ops, dispatch, ref

    seen = []

    def plain(x, w, passes=3, tile=None):
        rows = x.shape[:-1].numel()
        seen.append((rows, w.shape[0], w.shape[1], passes,
                     2 if x.dtype == torch.bfloat16 else 4))
        k1mod.afpm_matmul.launches += 1
        return ref.afpm_matmul_ref(x, w, passes)

    monkeypatch.setattr(dispatch, "resolve_backend",
                        lambda backend, x: "hopper")
    monkeypatch.setattr(custom_ops, "afpm_matmul", plain)
    return seen


@pytest.mark.parametrize("name", ["qwen3-4b.rag-long",
                                  "qwen3-4b.batch-short"])
def test_k1_reckoning_matches_the_launches(counted_k1, name):
    from repro_torch.kernels.afpm_matmul import afpm_matmul

    cell, arch = tiny.tiny(name)
    from chipbench import harness
    import time

    setup = harness.open_setup(cell, 11, 1.0, device="cpu", arch=arch)
    harness.warm_up(setup)
    run = harness.Run(cell=cell, seconds=1.0, t_start=time.perf_counter())
    start = len(counted_k1)
    n0 = afpm_matmul.launches
    harness.run_window(setup, run, trace=False)
    passes = cell.config["numerics"]["tiers"]
    want = [k for c in run.calls
            for k in work.k1_calls(cell.config, c["rows"], passes[c["tier"]])]
    got = counted_k1[start:]
    assert len(want) == afpm_matmul.launches - n0 == len(got) > 0
    assert collections.Counter(want) == collections.Counter(got)


def test_k1_bound_takes_the_larger_term():
    peaks = (1e12, 0, 1e9)
    # (M, K, N, passes, x bytes): 2 * 4 * 8 * 16 * 3 ops, bytes
    call = (4, 8, 16, 3, 2)
    ops, nbytes = 2 * 4 * 8 * 16 * 3, 4 * 8 * 2 + 8 * 16 * 4 + 4 * 16 * 4
    assert work.k1_bound_s(call, peaks) == max(ops / 1e12, nbytes / 1e9)


def test_model_flops_counts_parameters_and_attention():
    cfg = tiny.tiny("qwen3-4b.rag-long")[0].config
    d, ff, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    per_layer = d * H * hd * 2 + 2 * d * KH * hd + 3 * d * ff
    params = per_layer * cfg["num_hidden_layers"] + V * d
    got = work.model_flops(cfg, 3, 10)
    assert got == 2 * params * 3 + 4 * cfg["num_hidden_layers"] * H * hd * 10


def test_peaks_are_the_data_sheet_h100():
    assert work.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 67e12, 3.35e12)
    with pytest.raises(KeyError):
        work.peaks_for("cpu")
