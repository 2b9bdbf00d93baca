"""Dry-run: count every (arch x shape x mesh) cell (``repro.launch.dryrun``
counterpart).

For each cell this builds the production mesh (abstract:
:mod:`repro_torch.launch.mesh`), abstract params, optimizer state, serving
state and batch on ``meta`` tensors (:mod:`repro_torch.launch.specs`), and
runs the real step function (:mod:`repro_torch.launch.steps`) once under
the counter (:func:`repro_torch.launch.hlo_analysis.step_cost`).  Nothing
is allocated on any device and no weight is drawn.  On a mesh of more
than one chip the step runs placed, as the reference's ``jit`` runs it
under ``in_shardings``: the arguments become DTensors over a fake process
group of the mesh's size (:func:`~repro_torch.launch.mesh.fake_mesh`,
this process rank 0; the ranks of the session's device type, whose
collectives DTensor picks), each holding its meta block by the sharding
rules (:func:`~repro_torch.distributed.sharding.place`), and the counter
sees one chip's local ops and collectives, the reference's per-device
module.
A process that already has a process group of its own cannot count a
sharded cell (a one-line error; run it in a process of its own).  It
records:

- ``memory``: ``argument_bytes``, the bytes one chip holds of the step's
  arguments (params, with the optimizer state for a train step, the
  serving state, the batch; a decode step's position as the reference's
  0-d int32) under the sharding rules (``distributed.sharding.spec_for``);
  ``output_bytes`` and ``alias_bytes`` (what the step writes, and what of
  it updates an argument in place, as the reference donates it);
  ``temp_bytes``, the counter's peak of one chip's live intermediates;
  and ``peak_estimate_bytes`` = arguments + temp + outputs - aliases;
- ``roofline``: one chip's counted FLOPs and bytes (on one chip, the
  step's), against the data-sheet peaks of one card
  (:func:`~repro_torch.launch.hlo_analysis.roofline_terms`), with the
  collective term of the bytes one chip's collectives receive, by kind
  (none on one chip);
- ``sharded`` (counted placed) and ``ranks`` (the fake ranks' device
  type, or None), ``param_count``, ``active_param_count``, ``status``
  (``ok``, ``skipped(...)`` or ``error``) and ``count_s``.

Artifacts go to ``build/repro_torch/dryrun/``.  A step is counted once a
process for each mesh.

Usage (``--device`` defaults to ``cuda``, as every entry point of the
port; ``--device cpu`` on a host without a card):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k --both-meshes
  python -m repro_torch.launch.dryrun --all --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import traceback

import torch

from repro_torch.configs import list_archs
from repro_torch.distributed.sharding import (local_bytes, place, rules_for,
                                              use_mesh_rules)
from repro_torch.launch import hlo_analysis, specs, steps
from repro_torch.launch.mesh import Mesh, fake_mesh, make_production_mesh

ARTIFACT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
                / "repro_torch" / "dryrun")

_COUNTS: dict = {}   # (config, shape, mesh or None) -> the step's cost


def _cell(cfg, shape):
    """``(kind, step fn, args, arg specs, out specs fn)`` of one cell on
    meta tensors; ``out specs fn(result)`` gives the result's specs and
    which of its leaves update an argument in place."""
    sh = specs.shape_of(shape)
    if sh["kind"] == "train":
        params, pspecs = specs.abstract_params(cfg, cfg.param_dtype)
        opt_cfg, opt_init, opt_apply = steps.make_optimizer(cfg)
        opt = opt_init(params, opt_cfg)
        ospecs = specs.opt_state_specs(opt, pspecs)
        batch = specs.batch_specs(cfg, sh)
        fn = steps.make_train_step(cfg, opt_cfg, opt_apply)
        args = (params, opt, batch)
        arg_specs = (pspecs, ospecs, specs.batch_axes_tree(batch))

        def out_specs(result):
            _, _, metrics = result
            mspecs = {k: (None,) * v.dim() for k, v in metrics.items()
                      if isinstance(v, torch.Tensor)}
            tensors = {k: v for k, v in metrics.items()
                       if isinstance(v, torch.Tensor)}
            # params and moments are updated in place (the reference
            # donates them): written, and aliased
            return ((result[0], result[1], tensors), (pspecs, ospecs, mspecs),
                    ((result[0], result[1]), (pspecs, ospecs)))
        return "train", fn, args, arg_specs, out_specs

    params, pspecs = specs.abstract_params(cfg, torch.bfloat16)
    if sh["kind"] == "prefill":
        batch = specs.batch_specs(cfg, sh)
        s_dec = cfg.decoder_len if cfg.frontend == "audio_stub" else sh["seq"]
        fn = steps.make_prefill_step(cfg, max_len=s_dec)
        args = (params, batch)
        arg_specs = (pspecs, specs.batch_axes_tree(batch))

        def out_specs(result):
            logits, state = result
            return ((logits, state),
                    (specs.LOGITS_AXES, specs.state_axes_tree(state)),
                    ({}, {}))
        return "prefill", fn, args, arg_specs, out_specs

    B, S = sh["batch"], sh["seq"]
    max_len = min(S, 4096) if cfg.frontend == "audio_stub" else S
    state = specs.abstract_state(cfg, B, max_len)
    token = torch.empty((B, 1), dtype=torch.int32, device=specs.META)
    step = steps.make_decode_step(cfg)

    def fn(params, state, token, pos):
        # the step takes its position as a Python int (a host read of a
        # meta tensor fails): the cache's last one
        return step(params, state, token, max_len - 1)

    # the position's bytes count as the reference's 0-d int32 argument
    pos = torch.empty((), dtype=torch.int32, device=specs.META)
    args = (params, state, token, pos)
    arg_specs = (pspecs, specs.state_axes_tree(state), specs.BATCH_AXES["token"],
                 ())

    def out_specs(result):
        logits, new_state = result
        st_specs = specs.state_axes_tree(new_state)
        return ((logits, new_state), (specs.LOGITS_AXES, st_specs),
                ((new_state,), (st_specs,)))
    return "decode", fn, args, arg_specs, out_specs


def _token_spec_axes(mesh, B):
    """The reference's token sharding: the batch over ('pod', 'data') when
    it divides by the data axis, else replicated."""
    if B % mesh.shape.get("data", 1) == 0:
        return ("batch", None)
    return (None, None)


def cell_memory(cfg, shape, mesh) -> dict:
    """``argument_bytes`` of one cell: the bytes one chip holds of the
    step's arguments under the rules (pure arithmetic on meta tensors)."""
    kind, _, args, arg_specs, _ = _cell(cfg, shape)
    rules = rules_for(cfg, "train" if kind == "train" else "serve")
    arg_specs = _with_token_spec(kind, args, arg_specs, mesh)
    return {"argument_bytes": local_bytes(arg_specs, args, mesh, rules)}


def _with_token_spec(kind, args, arg_specs, mesh):
    if kind != "decode":
        return arg_specs
    return arg_specs[:2] + (_token_spec_axes(mesh, args[2].shape[0]),
                            arg_specs[3])


def _compute_scale(cfg) -> float:
    from repro_torch.core.policy import is_policy

    if is_policy(cfg.numerics):
        from repro_torch.models import transformer

        return hlo_analysis.policy_compute_scale(
            cfg.numerics, transformer.layer_paths(cfg),
            counts=transformer.layer_path_counts(cfg))
    if getattr(cfg.numerics, "mode", "exact") == "segmented":
        return cfg.numerics.seg_passes / hlo_analysis.EXACT_PASSES
    return 1.0


def _count(fn, args, arg_specs, mesh, rules, placed: bool,
           device_type: str) -> dict:
    """One chip's cost of ``fn(*args)``: unplaced, or placed over a fake
    process group of ``mesh``'s shape whose ranks are of ``device_type``."""
    if not placed:
        return hlo_analysis.step_cost(fn, *args)
    # the rules name 'pod' only beside 'data': one DeviceMesh dim for both
    with fake_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                   merge=(("pod", "data"),), device_type=device_type) \
            as fake, use_mesh_rules(fake, rules):
        return hlo_analysis.step_cost(fn, *place(args, arg_specs, fake,
                                                 rules))


def lower_session_cell(session, shape, multi_pod: bool = False, *,
                       mesh: Mesh | None = None,
                       place_one_chip: bool = False) -> dict:
    """Count one (session x shape x mesh) cell: the engine behind
    ``Session.dryrun`` and the dryrun CLI.  ``shape`` is a name of
    :data:`specs.SHAPES` or a ``{kind, seq, batch}`` dict; ``mesh``
    overrides the production mesh (e.g. ``Mesh((1, 1), ("data",
    "model"))`` for one card).  The step runs the plain versions of the
    kernels (meta tensors reach no kernel): the same products, summed as
    :func:`~repro_torch.kernels.dispatch._plain_sums` says (over CUDA
    ranks in fp32, as K1 sums).  On a mesh
    of more than one chip it runs placed, over fake ranks of the
    session's device type: a card's session counts what NCCL ranks run,
    a CPU session what gloo ranks run (DTensor gathers and chunks there
    where NCCL ranks exchange by an all-to-all).  ``place_one_chip``
    places a one-chip mesh too, which counts what the unplaced step
    counts."""
    from repro_torch.session import _with_backend

    arch = session.arch_id
    shape_name = shape if isinstance(shape, str) else "custom"
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = specs.cell_config(session.config, shape)
    if isinstance(shape, str):
        ok, reason = specs.shape_applicable(cfg, shape)
        if not ok:
            return {"arch": arch, "shape": shape_name, "mesh": mesh.tag,
                    "status": reason}
    placed = mesh.size > 1 or place_one_chip
    device_type = torch.device(session.device).type
    count_cfg = dataclasses.replace(
        cfg, numerics=_with_backend(cfg.numerics, "torch"))
    kind, fn, args, arg_specs, out_specs = _cell(count_cfg, shape)
    rules = rules_for(cfg, "train" if kind == "train" else "serve")
    arg_specs = _with_token_spec(kind, args, arg_specs, mesh)
    key = (repr(count_cfg), repr(specs.shape_of(shape)),
           (mesh.tag, device_type) if placed else None)
    if key not in _COUNTS:
        cost = _count(fn, args, arg_specs, mesh, rules, placed, device_type)
        result = cost.pop("result")
        outs, ospecs, (aliased, aspecs) = out_specs(result)
        cost["outputs"] = (outs, ospecs, aliased, aspecs)
        _COUNTS[key] = cost
    cost = _COUNTS[key]
    outs, ospecs, aliased, aspecs = cost["outputs"]
    with use_mesh_rules(mesh, rules):
        arg_bytes = local_bytes(arg_specs, args, mesh, rules)
        out_bytes = local_bytes(ospecs, outs, mesh, rules)
        alias_bytes = local_bytes(aspecs, aliased, mesh, rules)
    temp = max(0, int(cost["peak_bytes"] - cost["new_output_bytes"]))
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "alias_bytes": alias_bytes, "temp_bytes": temp,
              "peak_estimate_bytes": arg_bytes + temp + out_bytes
              - alias_bytes}
    per_chip = {"flops": cost["flops"], "bytes_stream": cost["bytes_stream"],
                "bytes_fused": float(arg_bytes + out_bytes)}
    terms = hlo_analysis.roofline_terms(
        per_chip, mesh.size, model_flops=specs.model_flops(cfg, shape),
        compute_scale=_compute_scale(cfg),
        coll=cost["collectives"] if placed else None)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh.tag,
        "status": "ok",
        "sharded": placed,
        "ranks": device_type if placed else None,
        "count_s": round(cost["count_s"], 1),
        "counted_ops": cost["ops"],
        "memory": memory,
        "roofline": terms,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, device=None):
    """One full-size cell: a :class:`repro_torch.session.Session` of the
    arch (its weights never drawn) through :func:`lower_session_cell`."""
    from repro_torch.session import Session

    return lower_session_cell(Session(arch, reduced=False, device=device),
                              shape_name, multi_pod)


def run_cell(arch, shape_name, multi_pod, out_dir=ARTIFACT_DIR, device=None):
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = make_production_mesh(multi_pod=multi_pod).tag
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    try:
        rec = lower_cell(arch, shape_name, multi_pod, device=device)
    except Exception as e:  # failures ARE the signal the dry-run exists for
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r, m = rec["roofline"], rec["memory"]
        extra = (f" dominant={r['dominant']}"
                 f" frac={r.get('roofline_fraction', 0):.3f}"
                 f" args/chip={m['argument_bytes'] / 2**30:.2f}GiB"
                 f" count={rec['count_s']:.0f}s")
    print(f"[dryrun] {arch} {shape_name} {mesh_tag}: {status}{extra}",
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(specs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the session's device (default cuda; cpu on a "
                         "host without a card); the count allocates "
                         "nothing on it")
    ap.add_argument("--out-dir", default=str(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    from repro_torch._device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no card: a one-line error
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.all:
        cells = [(a, s, mp) for a in list_archs() for s in specs.SHAPES
                 for mp in (False, True)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        cells = [(args.arch, args.shape, mp) for mp in meshes]
    failures = 0
    for arch, shape_name, mp in cells:
        rec = run_cell(arch, shape_name, mp, args.out_dir, device)
        if rec["status"] != "ok" and not rec["status"].startswith("skipped"):
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
