"""The plain reference against the port's plain route (the CPU's) on the
tiny cells: the program's readings are the rounding of two fp64 sums, the
control's one precision step lower are not."""
import dataclasses
import json
import pathlib

import pytest
import torch

import tiny_chipbench as tiny
from chipbench import harness, weights
from chipbench.reference import dense


@pytest.mark.parametrize("name", ["qwen3-4b.rag-long",
                                  "qwen3-4b.batch-short"])
def test_served_tokens_match_the_reference_and_the_control_does_not(name):
    setup, run = tiny.run_tiny(name, seed=3, seconds=1.0)
    prog, ctl = harness.check(setup, run, control=True)
    assert set(prog) == set(ctl) == {"gap"}
    assert prog["gap"] <= 1e-6
    assert ctl["gap"] > 1e-4 and ctl["gap"] >= 3 * max(prog["gap"], 1e-7)


def test_reference_logits_equal_the_port_prefill_and_decode():
    from repro_torch.models import transformer
    from repro_torch.session import Session

    cell, arch = tiny.tiny("qwen3-4b.rag-long", layers=3)
    shapes = {k: v[0] for k, v in transformer.param_shapes(arch).items()}
    params = weights.draw(shapes, cell.config["weights"], 9, "cpu")
    ref = dense.Reference(params, cell.config)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, arch.vocab, (70,), generator=g)
    for policy, passes in (("exact", 1), ("segmented3", 3),
                           ("segmented1", 1)):
        cfg = Session(arch, policy=policy, params=params,
                      device="cpu").config
        logits, state = transformer.prefill(
            params, cfg, {"tokens": prompt[None]}, max_len=96)
        served = [int(logits[0, -1].argmax())]
        rows = [logits[0, -1]]
        for j in range(4):
            lg, state = transformer.decode_step(
                params, cfg, {"token": torch.tensor([[served[-1]]])}, state,
                70 + j)
            rows.append(lg[0, -1])
            served.append(int(lg[0, -1].argmax()))
        want = ref.logits(prompt, served, passes)
        assert torch.allclose(torch.stack(rows), want, rtol=0, atol=1e-7)


def test_fp8_control_rounds_to_e4m3_under_a_scale():
    x = torch.tensor([[1.0, 0.3, -448.0 * 2]])
    q = dense._fp8(x, -1)
    assert q[0, 2] == -896.0
    assert abs(q[0, 1] - 0.3) / 0.3 > 1e-3
