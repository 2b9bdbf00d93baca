"""The sharded dry-run at full width against the JAX package's: qwen3-4b
train_4k on the 16 x 16 and 2 x 16 x 16 production meshes.

- The JAX side runs in a subprocess (the file runs itself as that
  script): ``repro.launch.dryrun.lower_cell`` for both meshes (about 7 s
  each).  That module sets 512 host devices when it is imported, so it
  needs a process of its own; ``run_cell`` and ``main`` are not called
  (they write records into the repo).  Besides the record's per-chip
  FLOPs and peak it reads two products off the compiled module that the
  port does not run: the part of the loss gradient's product over the
  whole vocabulary that XLA computes beyond the rows the forward's logits
  have on a chip (the compile logs an "involuntary full
  rematerialization"), and the reference attention VJP's recompute of
  the scores (the port's autograd keeps them from the forward).
- The port's side, in a subprocess too, is
  ``launch.dryrun.lower_session_cell`` over a fake group of CUDA-type
  ranks: the count a card's session gives (over CPU-type ranks DTensor
  gathers and chunks where NCCL ranks exchange by an all-to-all, which
  prices another peak).  Both sides run at once, about 30 s.
"""
import collections
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, SHAPE = "qwen3-4b", "train_4k"
MESHES = {"16x16": False, "2x16x16": True}
#: the card's memory (NVIDIA H100 80GB HBM3): a chip's peak must fit
CARD_BYTES = 80e9
#: the port's per-chip FLOPs over JAX's hlo_flops_per_chip: at most 10%
#: above; below, by the two products the port does not run (about 12% and
#: 3% of JAX's count)
FLOPS_RATIO = (0.80, 1.10)
#: the port's FLOPs against JAX's less those two products.  On 2 x 16 x 16
#: a third remains: XLA contracts the embedding's gradient over the rows
#: of both pods (K 8192 where a chip's share is 4096), 1.6e12 FLOPs, 1.9%
REST_RTOL = 0.02


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def _dots(hlo: str):
    """Every ``dot`` of a compiled module: ``(flops, times it runs, output
    dims, contracted extent, op_name)``, a dot in a ``while`` body counted
    by the loop's trip count (as ``loop_aware_cost`` counts it)."""
    comp, shapes = None, {}
    found, calls = collections.defaultdict(list), collections.defaultdict(list)

    def dims(s):
        return [int(d) for d in re.match(r"\w+\[([\d,]*)\]", s).group(1)
                .split(",") if d]

    for line in hlo.splitlines():
        if line.rstrip().endswith("{") and "->" in line and \
                not line.startswith(" "):
            comp = "ENTRY" if line.startswith("ENTRY") else line.split()[0]
            continue
        m = re.match(r"\s*(?:ROOT )?(%[\w.\-]+) = (\w+\[[\d,]*\])", line)
        if m:
            shapes[m.group(1)] = m.group(2)
        w = re.search(r" while\(.*?body=(%[\w.\-]+)", line)
        if w:
            n = re.search(r'known_trip_count":\{"n":"(\d+)"', line)
            calls[comp].append((w.group(1), int(n.group(1)) if n else 1))
        for c in re.finditer(r"(?:to_apply|calls|branch_computations)="
                             r"\{?(%[\w.\-]+(?:, *%[\w.\-]+)*)\}?", line):
            calls[comp] += [(n.strip(), 1) for n in c.group(1).split(",")]
        d = re.search(r"= (\w+\[[\d,]*\])\S* dot\(([^)]*)\)", line)
        if d:
            lhs = dims(shapes[d.group(2).split(",")[0].strip().split()[-1]])
            k = 1
            for i in re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                               line).group(1).split(","):
                k *= lhs[int(i)]
            out = dims(d.group(1))
            name = re.search(r'op_name="([^"]*)"', line)
            found[comp].append((2 * k * _prod(out), out, k,
                                name.group(1) if name else ""))
    times = collections.Counter({"ENTRY": 1})
    order = ["ENTRY"]
    for c in order:
        for callee, n in calls.get(c, ()):
            if callee not in times:
                order.append(callee)
            times[callee] += times[c] * n
    return [(f, times[c], out, k, name) for c, ds in found.items()
            for f, out, k, name in ds]


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _not_run_by_the_port(hlo: str, vocab: int) -> dict:
    dots = _dots(hlo)
    # the logits' rows on a chip in the forward (T, V) products
    rows = max(out[0] for _, _, out, k, _ in dots if out[-1] == vocab)
    vocab_excess = sum(f * n * (1 - rows / out[0])
                       for f, n, out, k, _ in dots if k == vocab)
    # the VJP's backward runs two products of this equation a block (the
    # scores again, and do·vᵀ), the forward and its remat one each
    scores = sum(f * n for f, n, _, _, name in dots
                 if "transpose(jvp" in name and "rematted" not in name
                 and name.endswith("bqhd,bkhd->bhqk/dot_general"))
    return {"vocab_excess": vocab_excess, "attn_recompute": scores / 2}


def _jax_main(out_path):
    from repro.launch import dryrun, hlo_analysis   # first: 512 devices
    from repro.configs import get_arch

    texts = []
    count = hlo_analysis.loop_aware_cost

    def keep(hlo):
        texts.append(hlo)
        return count(hlo)

    hlo_analysis.loop_aware_cost = keep
    out = {}
    for tag, multi_pod in MESHES.items():
        rec = dryrun.lower_cell(ARCH, SHAPE, multi_pod)
        assert rec["status"] == "ok" and rec["mesh"] == tag, rec
        out[tag] = {"flops": rec["roofline"]["hlo_flops_per_chip"],
                    "peak": rec["memory"]["peak_estimate_bytes"],
                    **_not_run_by_the_port(texts[-1], get_arch(ARCH).vocab)}
    with open(out_path, "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# the port's side (run as a script: its fake process group is the
# process's default group while it counts)
# ---------------------------------------------------------------------------

def _port_main(out_path):
    """The placed step counted over fake CUDA-type ranks: a session
    stand-in whose device is the card's (``lower_session_cell`` reads its
    ``arch_id``, ``config`` and ``device``; nothing is allocated)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    card = types.SimpleNamespace(arch_id=ARCH, config=get_arch(ARCH),
                                 device=torch.device("cuda"))
    out = {}
    for tag, multi_pod in MESHES.items():
        rec = dryrun.lower_session_cell(card, SHAPE, multi_pod)
        assert rec["status"] == "ok" and rec["sharded"], rec
        assert rec["ranks"] == "cuda" and rec["mesh"] == tag, rec
        out[tag] = {"flops": rec["roofline"]["hlo_flops_per_chip"],
                    "peak": rec["memory"]["peak_estimate_bytes"]}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """``{"jax": ..., "port": ...}``, each side in a process of its own,
    both at once."""
    tmp = tmp_path_factory.mktemp("counts")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(tmp / f"{side}.json")], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for side in ("jax", "port")}
    try:
        errs = {side: p.communicate(timeout=300)[1]
                for side, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for side, p in procs.items():
        assert p.returncode == 0, errs[side][-4000:]
    return {side: json.loads((tmp / f"{side}.json").read_text())
            for side in procs}


@pytest.mark.parametrize("tag", list(MESHES))
def test_per_chip_flops_against_the_jax_dry_run(counts, tag):
    jax, port = counts["jax"][tag], counts["port"][tag]["flops"]
    ratio = port / jax["flops"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], (port, jax)
    rest = jax["flops"] - jax["vocab_excess"] - jax["attn_recompute"]
    assert jax["vocab_excess"] > 0 and jax["attn_recompute"] > 0
    assert port == pytest.approx(rest, rel=REST_RTOL), (port, jax)


def test_per_chip_flops_halve_with_the_data_axis(counts):
    port, jax = counts["port"], counts["jax"]
    half = port["2x16x16"]["flops"] / port["16x16"]["flops"]
    assert half == pytest.approx(0.5, rel=0.10)
    want = jax["2x16x16"]["flops"] / jax["16x16"]["flops"]
    assert want == pytest.approx(0.5, rel=0.10)


@pytest.mark.parametrize("tag", list(MESHES))
def test_per_chip_peak_fits_the_card(counts, tag):
    assert 0 < counts["port"][tag]["peak"] < CARD_BYTES


# ---------------------------------------------------------------------------
# product by product (a tool, not a test):
#   python tests/test_torch_dryrun_vs_jax.py split ARCH SHAPE [2x16x16]
# lists every product of both counts of one cell, FLOPs a chip summed by
# output shape and contracted extent, beside where it was called
# ---------------------------------------------------------------------------

def _jax_products(arch, shape, multi_pod, out_path):
    from repro.launch import dryrun, hlo_analysis   # first: 512 devices

    texts = []
    count = hlo_analysis.loop_aware_cost

    def keep(hlo):
        texts.append(hlo)
        return count(hlo)

    hlo_analysis.loop_aware_cost = keep
    assert dryrun.lower_cell(arch, shape, multi_pod)["status"] == "ok"
    with open(out_path, "w") as f:
        json.dump([(fl * n, n, out, k, name.split("/")[-2:])
                   for fl, n, out, k, name in _dots(texts[-1])], f)


def _port_products(arch, shape, multi_pod, out_path):
    import traceback

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, hlo_analysis

    found = collections.Counter()
    count = hlo_analysis._dot_flops

    def keep(func, args, out):
        fl = count(func, args, out)
        if fl:
            # the innermost model-side caller (none in autograd's backward)
            site = next((f"{fr.name}:{fr.lineno}" for fr in
                         reversed(traceback.extract_stack())
                         if "repro_torch" in fr.filename
                         and "launch" not in fr.filename), "backward")
            found[(fl, tuple(out.shape), args[0].shape[-1], site)] += 1
        return fl

    hlo_analysis._dot_flops = keep
    card = types.SimpleNamespace(arch_id=arch, config=get_arch(arch),
                                 device=torch.device("cuda"))
    assert dryrun.lower_session_cell(card, shape, multi_pod)["sharded"]
    with open(out_path, "w") as f:
        json.dump([(fl * n, n, list(out), k, site)
                   for (fl, out, k, site), n in found.items()], f)


def _split(arch, shape, mesh="16x16"):
    import tempfile

    tmp = pathlib.Path(tempfile.mkdtemp())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, f"products-{side}", arch, shape, mesh,
         str(tmp / f"{side}.json")], env=env, stdout=subprocess.DEVNULL)
        for side in ("jax", "port")}
    for p in procs.values():
        assert p.wait() == 0
    for side in procs:
        rows = json.loads((tmp / f"{side}.json").read_text())
        print(f"{side}: {sum(r[0] for r in rows):.6e} FLOP/chip")
        for fl, n, out, k, where in sorted(rows, key=lambda r: -r[0]):
            print(f"  {fl:.4e}  {n:6d} x out {out} K {k}  {where}")


if __name__ == "__main__":
    if sys.argv[1] == "split":
        _split(*sys.argv[2:])
    elif sys.argv[1].startswith("products-"):
        arch, shape, mesh, out = sys.argv[2:]
        {"products-jax": _jax_products, "products-port": _port_products}[
            sys.argv[1]](arch, shape, mesh == "2x16x16", out)
    else:
        {"jax": _jax_main, "port": _port_main}[sys.argv[1]](sys.argv[2])
