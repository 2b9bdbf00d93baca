"""A run with the timed path broken underneath, driven through the
harness's whole run (``execute``; only the look for a card is skipped),
comes out not correct: once for each fault a serving cell can have."""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

import tiny_chipbench as tiny
from chipbench import harness


def _execute(name):
    cell, arch = tiny.tiny(name)
    return harness.execute(cell, 5, 1.0, False, torch.device("cpu"),
                           time.perf_counter(), arch=arch)


@pytest.mark.parametrize("name", ["qwen3-4b.rag-long",
                                  "qwen3-4b.batch-short"])
def test_sound_run_is_correct(name):
    res = _execute(name)
    assert res["correct"] is True
    assert list(res)[-1] == "compared"


def _token_altered(monkeypatch):
    from repro_torch.serving.engine import TransformerRunner

    orig = TransformerRunner.decode

    def decode(self, tokens, pos, tables):
        out = orig(self, tokens, pos, tables)
        return (out + 1) % self.cfg.vocab
    monkeypatch.setattr(TransformerRunner, "decode", decode)


def _state_unchanged(monkeypatch):
    from repro_torch.serving import kvcache

    monkeypatch.setattr(kvcache, "scatter_token", lambda *a, **k: None)


def _half_the_batch(monkeypatch):
    from repro_torch.serving.engine import TransformerRunner

    orig = TransformerRunner.decode

    def decode(self, tokens, pos, tables):
        n = self.n_slots // 2
        keep = np.full_like(np.asarray(tables), self.n_pages)
        keep[:n] = np.asarray(tables)[:n]
        out = orig(self, tokens, pos, keep)
        out[n:] = np.asarray(tokens)[n:]
        return out
    monkeypatch.setattr(TransformerRunner, "decode", decode)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_the_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_the_batch"])
@pytest.mark.parametrize("name", ["qwen3-4b.rag-long",
                                  "qwen3-4b.batch-short"])
def test_fault_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    res = _execute(name)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


def test_a_lane_off_its_stated_passes_stops_the_set_up():
    cell, arch = tiny.tiny("qwen3-4b.batch-short")
    cfg = copy.deepcopy(cell.config)
    cfg["numerics"]["tiers"]["standard"] = 1
    with pytest.raises(ValueError, match="standard lane"):
        harness.open_setup(dataclasses.replace(cell, config=cfg), 5, 1.0,
                           device="cpu", arch=arch)
