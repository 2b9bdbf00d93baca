"""Hygiene of the port: it stands alone, and it never hides the device.

- no module under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of the JAX package ``repro``;
- the entry points run on CUDA unless asked for the CPU: without CUDA,
  ``Session`` (and ``Session.from_resnet`` / ``from_pretrained``), the
  engine's runner, ``serve``, the trainer and the Table II, III and IV
  benchmarks (Table IV's training too) raise instead of carrying on on
  the CPU.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch.bench import table3_image
    from repro_torch.launch.serve import serve
    from repro_torch.serving import TransformerRunner
    from repro_torch.session import Session

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session("qwen3-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(batch=1, prompt_len=4, gen_len=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table3_image.run(n_images=1, size=8)
    cpu = Session("qwen3-4b", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerRunner(cpu.config, cpu.params, 1, 8)
    # asked for the CPU, each of them runs there
    assert TransformerRunner(cpu.config, cpu.params, 1, 8,
                             device="cpu").device.type == "cpu"
    out = serve(batch=1, prompt_len=4, gen_len=2, device="cpu")
    assert out.shape == (1, 2)
    t = table3_image.run(n_images=1, size=8, device="cpu")
    assert sorted(t.psnr) == sorted(table3_image.MULTS)


def test_resnet_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch.bench import table2_ppa, table4_resnet
    from repro_torch.models import resnet
    from repro_torch.session import Session

    cfg = resnet.ResNetConfig(widths=(4, 8), blocks=(1, 1))
    params, state = resnet.init(cfg, 0, "cpu")
    fixture = ROOT / "tests" / "golden" / "compat" / "resnet18"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Session.from_resnet(cfg, params, state),
                 lambda: Session.from_pretrained("resnet18", fixture),
                 lambda: table2_ppa.run(n_samples=10),
                 lambda: table4_resnet.run(eval_n=1, cfg=cfg, designs=[]),
                 lambda: table4_resnet.run_auto(calib_n=1, cfg=cfg),
                 lambda: table4_resnet.train_resnet(1, 2, cfg=cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for the CPU, each of them runs there
    sess = Session.from_resnet(cfg, params, state, device="cpu")
    assert sess.apply(np.zeros((1, 8, 8, 3), np.float32)).shape == (1, 10)
    assert Session.from_pretrained("resnet18", fixture,
                                   device="cpu").device.type == "cpu"
    table2_ppa.run(device="cpu", n_samples=10)
    rows = table4_resnet.run(device="cpu", eval_n=1, cfg=cfg, designs=[],
                             train_steps=1)
    assert set(rows) == {"Exact"}
    assert len(table4_resnet.train_resnet(1, 2, device="cpu", cfg=cfg)[3]) == 1


def test_sweep_refuses_the_cpu_unless_asked(monkeypatch):
    """The emulated sweep (and the auto-configurer's default candidates,
    drawn from it) runs on the card unless the caller asks for the CPU."""
    from repro_torch.core import sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: sweep.sweep(n_samples=10),
                 lambda: sweep.recommend(1.0, n_samples=10),
                 lambda: sweep.pareto_candidates(n_samples=10),
                 lambda: sweep.auto_configure(lambda p: 0.0, ["a"], 1e-3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert len(sweep.sweep(n_samples=10, device="cpu")) == \
        len(sweep.SWEEPABLE)
    assert sweep.recommend(1.0, n_samples=10, device="cpu").mred <= 1.0


def test_trainer_refuses_the_cpu_unless_asked(monkeypatch, tmp_path):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train("qwen3-4b", steps=1, seq_len=4, batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--seq-len", "4", "--batch", "1"])
    params, _, losses = train.train("qwen3-4b", steps=1, seq_len=4, batch=1,
                                    device="cpu")
    assert len(losses) == 1 and params["embed"].device.type == "cpu"


def test_dryrun_entry_points_refuse_the_cpu_unless_asked(monkeypatch, capsys,
                                                         tmp_path):
    """The dryrun CLI, the session CLI's ``dryrun`` and ``Session.dryrun``
    run on the card unless asked for the CPU (the count itself allocates
    nothing on either)."""
    from repro_torch.launch import dryrun
    from repro_torch.session import Session, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "qwen3-4b", "--shape", "long_500k"]
    assert dryrun.main(args + ["--out-dir", str(tmp_path)]) == 2
    assert main(["dryrun"] + args) == 2
    err = capsys.readouterr().err
    assert err.count("device='cpu'") == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session("qwen3-4b", reduced=False).dryrun("long_500k")
    # asked for the CPU, each of them runs there
    assert dryrun.main(args + ["--device", "cpu", "--out-dir",
                               str(tmp_path)]) == 0
    assert main(["dryrun", "--device", "cpu"] + args) == 0
    rec = Session("qwen3-4b", reduced=False, device="cpu").dryrun("long_500k")
    assert rec["status"].startswith("skipped")
