"""Counted cost of a step, the roofline terms, and the modeled cost of a
numerics policy (``repro.launch.hlo_analysis`` counterpart).

The reference reads XLA's compiled module; the port has no compiler
module to read, so it counts the step itself: :func:`step_cost` runs one
step function on ``meta`` tensors (shapes and dtypes, no data, no device
memory) under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
that sees every ATen op the step runs, autograd's backward included.
:func:`roofline_terms` turns a per-chip cost into the compute and memory
times against one card's data-sheet peaks (:data:`CARD_PEAKS`), and,
given a :class:`CollectiveStats`, the collective time over the card's
links.  :func:`collective_bytes` reads those stats off a run of a
function over ranks: the bytes each collective of the port
(:mod:`repro_torch.distributed.collectives`: expert-parallel MoE, the
pipeline, the gradient reduce, and DTensor's redistributions of a placed
step) delivers to this rank, by kind.  A placed step counted on meta
tensors over a fake process group (the dry-run's sharded cells) is one
rank's local ops and collectives: the per-chip module the reference
reads.

:func:`policy_compute_scale` and :func:`policy_ppa_summary` are pure
arithmetic over a policy and its call sites, what ``Session.ppa_report``
returns.
"""
from __future__ import annotations

import time
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch import tree as tree_util
from repro_torch.distributed.collectives import (CollectiveStats,
                                                 count_collectives,
                                                 functional_kind)

# Passes of the exact split-float product (paper Eq. 6: the full 6-term
# hi/lo expansion); segmented seg_passes=k keeps k of them, so a site's
# modeled compute time scales by k/6 against exact.
EXACT_PASSES = 6


def policy_compute_scale(policy, layer_paths, counts=None) -> float:
    """Modeled pass scale of a policy against the all-exact baseline.

    Per site: exact -> 1.0; ``segmented`` -> ``seg_passes / 6`` (term
    skipping drops whole passes, the paper's latency lever on the
    multiplier datapath); ``emulated`` -> 1.0 (the bit-level emulation
    models accuracy, not a faster datapath).  Returns the mean over
    ``layer_paths``, weighted by ``counts`` multiplicity where given.
    """
    counts = counts or {}
    num = den = 0.0
    for p in layer_paths:
        cfg = policy.lookup(p)
        k = counts.get(p, 1)
        scale = (cfg.seg_passes / EXACT_PASSES
                 if cfg.mode == "segmented" else 1.0)
        num += scale * k
        den += k
    return num / max(den, 1.0)


def policy_ppa_summary(policy, layer_paths, counts=None) -> dict:
    """Modeled area / power / compute scale of a per-layer policy: the
    Table II roll-up (:func:`repro_torch.core.sweep.policy_ppa`, one
    multiplier instance per call-site path) with the pass scale and the
    reductions against the all-exact baseline."""
    from repro_torch.core import sweep

    out = dict(sweep.policy_ppa(policy, layer_paths, counts))
    out["compute_scale"] = policy_compute_scale(policy, layer_paths, counts)
    out["area_reduction"] = 1.0 - out["area_um2"] / max(
        out["baseline_area_um2"], 1e-30)
    out["power_reduction"] = 1.0 - out["power_w"] / max(
        out["baseline_power_w"], 1e-30)
    return out


# ---------------------------------------------------------------------------
# the card's data-sheet peaks
# ---------------------------------------------------------------------------

#: (name fragments, card, HBM bytes/s, dense bf16 FLOP/s, fp32 FLOP/s
#: outside the tensor cores, NVLink bytes/s a direction) from NVIDIA's
#: data sheets (NVLink: half the bidirectional figure; the PCIe card's
#: through its bridge); the first row whose fragments all occur in the
#: device name applies
CARD_PEAKS = (
    (("H200",), "H200 SXM", 4.8e12, 989e12, 67e12, 450e9),
    (("H100", "PCIe"), "H100 PCIe", 2.0e12, 756e12, 51e12, 300e9),
    (("H100", "NVL"), "H100 NVL", 3.9e12, 835e12, 60e12, 300e9),
    (("H100",), "H100 SXM", 3.35e12, 989e12, 67e12, 450e9),
)
#: the card a dry-run prices when it is given none (what it is written for)
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def card_peaks(name: str):
    """``(bytes/s, dense bf16 FLOP/s, fp32 FLOP/s)`` of the card named
    ``name`` (``torch.cuda.get_device_name``); raises for a card with no
    row in :data:`CARD_PEAKS`."""
    return _card_row(name)[2:5]


def _card_row(name: str):
    for frags, *row in CARD_PEAKS:
        if all(f in name for f in frags):
            return (frags, *row)
    raise RuntimeError(f"no published peaks known for {name!r}")


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    """The distinct tensors of a tree (nested dicts, lists and tuples), a
    DTensor as its block on this rank."""
    seen = {}
    for t in tree_util.leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            seen.setdefault(id(t), t)
    return list(seen.values())


def nbytes(tree) -> int:
    """Bytes of the distinct tensors of a tree (each counted once)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _dot_flops(func, args, out):
    """2 x output elements x contracted extent for a product op (as the
    reference counts HLO ``dot`` and ``convolution``), else 0."""
    aten = torch.ops.aten
    pkt = func.overloadpacket
    if pkt in (aten.mm, aten.bmm, aten.mv):
        return 2 * out.numel() * args[0].shape[-1]
    if pkt in (aten.addmm, aten.baddbmm, aten.addmv, aten.addmm_,
               aten.baddbmm_, aten.addmv_):
        return 2 * out.numel() * args[1].shape[-1]
    if pkt in (aten.dot, aten.vdot):
        return 2 * args[0].numel()
    if pkt in (aten.convolution, aten._convolution):
        w = args[1]
        return 2 * out.numel() * (w.numel() // max(w.shape[0], 1))
    return 0


def step_cost(fn, *abstract_args, **kwargs) -> dict:
    """Count one call ``fn(*abstract_args, **kwargs)`` on meta tensors.

    Returns (for the whole step, or one chip's share of a placed one):

    - ``flops``: 2 x output elements x contracted extent of every product
      (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv`` and their
      in-place forms, ``dot``, ``convolution``; what ``matmul`` and
      ``einsum`` lower to), as the
      reference's ``loop_aware_cost`` counts ``dot`` and ``convolution``;
    - ``bytes_stream``: the bytes each op reads and writes (its tensor
      inputs and outputs), views excluded: memory traffic with no fusion;
    - ``bytes_fused``: the bytes of the step's arguments and results (its
      weights read once, its state read and written): the traffic of a
      step whose every op keeps its intermediates on chip;
    - ``peak_bytes``: the most bytes that tensors allocated during the
      step held at once (each op's fresh outputs, freed when the last
      reference goes), and ``new_output_bytes``: the bytes of the step's
      results that it allocated (not updated in place);
    - ``ops``: the ATen ops counted, ``count_s``, and ``result``: what
      the step returned (meta tensors).

    - ``collectives``: the :class:`CollectiveStats` of the step's
      collectives, by kind: this module's (``count_collectives``) and
      DTensor's ``_c10d_functional`` ones, backward included.

    On DTensor arguments (a placed step over a fake process group) the
    counter sees one rank's local ops and counts them alone: DTensor's
    own shape inference (the op at global shapes on fake tensors) is left
    out, and every figure is per chip.

    A step that reads a tensor's value on the host (``.item()``,
    ``int(t)``) fails on meta tensors: the counted steps take Python ints
    for positions.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    state = {"flops": 0, "bytes_stream": 0, "ops": 0, "live": 0, "peak": 0}
    fresh = set()       # ids of live tensors allocated during the step
    known: dict = {}    # op signature -> its outputs' (shape, stride, dtype)

    def freed(key, n):
        fresh.discard(key)
        state["live"] -= n

    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
        if isinstance(x, (list, tuple)):
            return tuple(sig(e) for e in x)
        return x

    def flat(x, acc):
        if isinstance(x, torch.Tensor):
            acc.append(x)
        elif isinstance(x, (list, tuple)):
            for e in x:
                flat(e, acc)
        elif isinstance(x, dict):
            for e in x.values():
                flat(e, acc)
        return acc

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor runs the local ops
            if any(isinstance(m, FakeTensorMode)
                   for m in _get_current_dispatch_mode_stack()):
                return func(*args, **kwargs)   # DTensor's shape inference
            state["ops"] += 1
            if func.is_view:
                return func(*args, **kwargs)
            # an out-of-place op on meta tensors: its outputs depend on its
            # inputs' shapes, strides and dtypes alone, so a signature met
            # before (every repeat of a layer) makes them without the meta
            # kernel
            key = None
            # a collective always runs (count_collectives below sees it)
            if not (func._schema.is_mutable
                    or func.namespace.startswith(("c10d", "_c10d"))
                    or functional_kind(func)):
                try:
                    key = (func, sig(args), sig(tuple(sorted(kwargs.items()))))
                    hash(key)
                except TypeError:
                    key = None
            metas = known.get(key) if key is not None else None
            if metas is not None:
                made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in metas]
                out = made[0] if len(made) == 1 and not isinstance(
                    metas, list) else type(metas)(made)
            else:
                out = func(*args, **kwargs)
                outs = out if isinstance(out, (tuple, list)) else (out,)
                if key is not None and all(
                        isinstance(o, torch.Tensor) and o.is_meta
                        and o.storage_offset() == 0 for o in outs):
                    spec = [(o.shape, o.stride(), o.dtype) for o in outs]
                    known[key] = (spec if isinstance(out, (tuple, list))
                                  else tuple(spec))
            ins = flat((args, kwargs), [])
            outs = flat(out, [])
            if outs:
                state["flops"] += _dot_flops(func, args, outs[0])
            state["bytes_stream"] += sum(t.numel() * t.element_size()
                                         for t in ins + outs)
            in_ids = {id(t) for t in ins}
            for o in outs:
                if id(o) in in_ids or id(o) in fresh:
                    continue   # written in place
                n = o.untyped_storage().nbytes()
                fresh.add(id(o))
                state["live"] += n
                weakref.finalize(o, freed, id(o), n)
            state["peak"] = max(state["peak"], state["live"])
            return out

    t0 = time.perf_counter()
    with count_collectives() as stats, Counter():
        result = fn(*abstract_args, **kwargs)
    count_s = time.perf_counter() - t0
    args = (abstract_args, kwargs)
    arg_ids = {id(t) for t in _tensors(args)}
    new_out = nbytes([t for t in _tensors(result) if id(t) not in arg_ids])
    return {"flops": float(state["flops"]),
            "bytes_stream": float(state["bytes_stream"]),
            "bytes_fused": float(nbytes(args) + nbytes(result)),
            "peak_bytes": float(state["peak"]),
            "new_output_bytes": float(new_out),
            "ops": state["ops"], "count_s": count_s, "collectives": stats,
            "result": result}


# ---------------------------------------------------------------------------
# collectives and roofline terms
# ---------------------------------------------------------------------------

def collective_bytes(fn, *args, **kwargs) -> CollectiveStats:
    """Run ``fn(*args, **kwargs)`` once and return the bytes its
    collectives delivered to this rank by kind (``all-to-all``,
    ``all-reduce``, ``all-gather``, ``collective-permute``), backward ones
    included when ``fn`` runs a backward: the port's counterpart of the
    reference's count over a compiled module.  Both count the bytes each
    collective's output holds on a rank, its own chunk included (what the
    process group hands back; over the wire an all-to-all or all-gather
    over ``n`` ranks brings ``(n - 1) / n`` of it).  XLA writes a CPU
    module's all-to-all as a tuple of its ``n`` chunks, and the
    reference's parser sums them to the same figure."""
    with count_collectives() as stats:
        fn(*args, **kwargs)
    return stats


def roofline_terms(cost: dict, n_chips: int, model_flops=None,
                   compute_scale: float = 1.0, card: str = DEFAULT_CARD,
                   coll: CollectiveStats | None = None) -> dict:
    """The reference's roofline record for a per-chip ``cost`` (``flops``,
    ``bytes_stream``, ``bytes_fused``), priced on ``card``'s data-sheet
    peaks (:data:`CARD_PEAKS`: dense bf16 FLOP/s, HBM bytes/s and NVLink
    bytes/s a direction).

    The memory term reads ``bytes_fused`` (weights read once, state read
    and written); the stream count is recorded beside it, and as the
    reference's XLA-convention key.  ``compute_scale`` folds a numerics
    policy into the compute term (:func:`policy_compute_scale`).  Given
    ``coll`` (the bytes a chip receives: a placed step's count,
    :func:`step_cost`'s ``collectives``, or :func:`collective_bytes` of a
    run over ranks), the collective term is those bytes over the card's
    link rate and ``dominant`` weighs it with compute and memory; without
    (a one-chip cell), the collective fields are ``None`` and ``dominant``
    is taken over compute and memory."""
    _, card_name, hbm_bw, peak_flops, _, link_bw = _card_row(card)
    flops = float(cost.get("flops", 0.0))
    stream = float(cost.get("bytes_stream", 0.0))
    fused = float(cost.get("bytes_fused", stream))
    t_compute = flops * compute_scale / peak_flops
    t_memory = fused / hbm_bw
    t_coll = None if coll is None else coll.total_bytes / link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll or 0.0}
    out = {
        "hlo_flops_per_chip": flops,
        "numerics_compute_scale": compute_scale,
        "hlo_bytes_per_chip": fused,
        "hlo_bytes_stream_per_chip": stream,
        "hlo_bytes_xla_convention_per_chip": stream,
        "collective_bytes_per_chip": None if coll is None else
        coll.total_bytes,
        "collective_by_kind": None if coll is None else dict(coll.by_kind),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": max(terms, key=terms.get),
        "n_chips": n_chips,
        "card": card_name,
        "peak_flops_bf16": peak_flops,
        "hbm_bytes_per_s": hbm_bw,
        "link_bytes_per_s": link_bw,
    }
    if model_flops is not None:
        out["model_flops_total"] = model_flops
        out["model_flops_per_chip"] = model_flops / n_chips
        out["useful_flops_ratio"] = (model_flops / n_chips) / max(flops, 1.0)
        bound = max(terms.values())
        ideal = (model_flops / n_chips) / peak_flops
        out["roofline_fraction"] = ideal / max(bound, 1e-12)
    return out
