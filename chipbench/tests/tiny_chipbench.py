"""A cell of the real benchmark cut to a size the CPU runs in seconds:
the port's reduced qwen3-4b (bf16 activations, as served), short prompts,
a fast arrival rate, few slots."""
from __future__ import annotations

import copy
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from chipbench import harness  # noqa: E402

KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "head_dim": "resolved_head_dim", "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads", "num_hidden_layers": "n_layers",
        "vocab_size": "vocab"}


#: a mix kept for a later cell (``PERF.md``), run here as ``<config>.<mix>``
KEPT = {"qwen3-4b.rag-long": ("qwen3-4b", "rag-long")}


def cell(name: str):
    """A cell of ``BENCHMARK.json``, or a kept mix under the checks of the
    benchmark's cell of the same configuration."""
    if name not in KEPT:
        return harness.Cell.load(name)
    config, traffic = KEPT[name]
    bench = harness._json(ROOT / "BENCHMARK.json")
    twin = next(w["name"] for w in bench["workloads"]
                if w["config"] == config)
    return harness.Cell.of(name, config, traffic, bench,
                           checks=harness.Cell.load(twin).checks)


def tiny(cell_name: str, layers: int = 2, vocab: int = 512):
    """(cell, arch): the named cell with the reduced config's sizes."""
    from repro_torch.configs import get_arch

    cell = globals()["cell"](cell_name)
    base = get_arch(cell.config["port"]["arch"]).reduced()
    arch = dataclasses.replace(
        base, segments=((layers, base.segments[0][1]),), vocab=vocab,
        dtype="bfloat16")
    cfg = copy.deepcopy(cell.config)
    for key, attr in KEYS.items():
        cfg[key] = getattr(arch, attr)
    cfg["weights"]["std"]["embed"] = 0.1 * arch.d_model ** -0.5
    tr = copy.deepcopy(cell.traffic)
    if tr["arrival"]["kind"] == "poisson":
        tr["arrival"].update(rate_rps=40.0, load_in_s=0.3)
    else:
        tr["arrival"]["per_tier"] = 12
    tr["prompt_tokens"].update(median=40, min=16, max=96)
    tr["output_tokens"].update(median=6, min=2, max=12)
    tr["engine"].update(slots=4, max_len=112, prefill_chunk=32)
    checks = dict(cell.checks, sample_tokens_per_tier=40)
    return dataclasses.replace(cell, config=cfg, traffic=tr,
                               checks=checks), arch


def run_tiny(cell_name: str, seed: int = 7, seconds: float = 1.0,
             control: bool = False, layers: int = 2):
    """Set-up, warm-up, window and check of the tiny cell on the CPU."""
    import time

    cell, arch = tiny(cell_name, layers=layers)
    setup = harness.open_setup(cell, seed, seconds, device="cpu", arch=arch)
    harness.warm_up(setup)
    run = harness.Run(cell=cell, seconds=seconds, t_start=time.perf_counter())
    harness.run_window(setup, run, trace=False)
    return setup, run
