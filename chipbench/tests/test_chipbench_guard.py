"""The import check, and the contract's static rules on BENCHMARK.json."""
import ast
import json
import pathlib
import re
import sys

import pytest

import tiny_chipbench as tiny
from chipbench import guard, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_guard_compares_top_level_names_whole():
    assert guard.banned_modules(["repro_torch", "repro_torch.models",
                                 "reproducible", "torch"]) == []
    assert guard.banned_modules(["repro", "repro.core", "jax.numpy",
                                 "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_no_banned_module_after_a_run():
    tiny.run_tiny("qwen3-4b.batch-short", seconds=0.5)
    assert guard.banned_modules() == [], guard.banned_modules()
    assert "repro_torch" in sys.modules


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "chipbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_the_reference_no_program(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & guard.BANNED
    if "reference" in path.parts:
        assert not tops & {"repro_torch", "chipbench"}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        harness.load_reader("e2e", m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        harness.load_reader("metrics", m["name"])
        for w in m["workloads"]:
            e = e2e[m["moves"]]
            assert "workloads" not in e or w in e["workloads"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.Cell.load(w["name"])
        kinds = {m["name"] for m in harness.metrics_for(cell, "end_to_end")}
        assert "setup_s" in kinds and len(kinds) >= 2
        assert harness.metrics_for(cell, "per_layer")
        assert set(cell.checks["limits"]) == {"gap"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("chipbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size"))
