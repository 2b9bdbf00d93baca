"""Hygiene of the port: it stands alone, and it never hides the device.

- no module under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of the JAX package ``repro``;
- the entry points run on CUDA unless asked for the CPU: without CUDA,
  ``Session``, the engine's runner, ``serve`` and the Table III driver
  raise instead of carrying on on the CPU.
"""
import ast
import pathlib

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
