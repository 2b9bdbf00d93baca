"""Logical-axis sharding rules (``repro.distributed.sharding`` counterpart).

Parameters, optimizer state, serving state and batches carry *logical*
axis names (``transformer.param_specs``, ``launch.specs``); a rule table
maps each name to a mesh axis (or None: replicated).  :func:`spec_for`
keeps the reference's divisibility fallback: a dim that does not divide by
its mesh axis is replicated instead, which is what lets the whole zoo (40
heads, odd vocabularies, batch 1 long-context) shard under one rule set.

A sharding is a :class:`PartitionSpec` over a
:class:`repro_torch.launch.mesh.Mesh`.  Over an abstract mesh the dry-run
counts what each chip holds from it (:func:`local_shape`).  Over a mesh
with ranks (``make_test_mesh``) the explicit collectives run on it:
:func:`repro_torch.distributed.collectives.shard_map` cuts a rank's block
by its spec, and MoE's expert-parallel path reads :func:`spec_for` under
:func:`use_mesh_rules`.  Whole-model placement by these specs
(``DTensor``) is not done: :func:`logical_constraint` is the identity.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

# -- default rule tables ------------------------------------------------------

# weights + activations, training (TP over 'model', DP/FSDP over 'data'(+pod))
TRAIN_RULES = {
    # weight axes
    "vocab": "model",
    "embed": None,            # -> "data" when cfg.fsdp (ZeRO-3 style)
    "embed_table": None,      # embedding/unembed d_model dim: never fsdp
    "mlp": "model",
    "experts": "model",
    "q_dim": "model",         # fused heads*head_dim projections
    "kv_dim": "model",
    "q_lora": None,
    "kv_lora": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "layers": None,
    "conv": None,
    # activation axes
    "batch": ("pod", "data"),
    "seq": "model",           # sequence parallelism on the residual stream
    "heads": "model",
    "kv_seq": "model",
    "expert_cap": ("pod", "data"),
}

# serving: weights TP'd over 'model'; MoE experts spread over 'data' too
SERVE_RULES = dict(TRAIN_RULES)
SERVE_RULES.update({
    "experts": ("pod", "data"),
    "batch": ("pod", "data"),
    "seq": "model",
    "kv_seq": "model",
})


def rules_for(cfg, mode: str) -> dict:
    rules = dict(TRAIN_RULES if mode == "train" else SERVE_RULES)
    if getattr(cfg, "fsdp", False) and mode == "train":
        rules["embed"] = ("pod", "data")
    if not getattr(cfg, "seq_shard_activations", True):
        rules["seq"] = None
    overrides = getattr(cfg, "sharding_overrides", None)
    if overrides:
        rules.update(dict(overrides))
    return rules


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) per tensor dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


# -- spec construction with divisibility fallback -----------------------------

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= _axis_size(mesh, a)
        return out
    return mesh.shape[axis] if axis in mesh.shape else 1


def _present(mesh, axis):
    """Filter rule entries down to axes that exist in this mesh."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in mesh.shape)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in mesh.shape else None


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: dict) -> PartitionSpec:
    """Logical axes tuple + concrete shape -> PartitionSpec
    (divisibility-safe).  ``mesh`` is anything with a ``.shape`` mapping
    axis name -> size."""
    used = set()
    parts = []
    for dim, name in zip(shape, axes):
        axis = _present(mesh, rules.get(name)) if name else None
        if axis is not None:
            flat = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in flat) or dim % _axis_size(mesh, axis) != 0:
                axis = None
            else:
                used.update(flat)
        parts.append(axis)
    return P(*parts)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shape one chip holds of a tensor of ``shape`` under ``spec``
    (every sharded dim divides by its axes, as :func:`spec_for` keeps)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _axis_size(mesh, a) for d, a in zip(shape, spec))


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple: plain tuple of axis names / None (named
    tuples, like optimizer states, are trees, not leaves)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(isinstance(e, (str, type(None))) for e in x))


def map_specs(fn, specs_tree, *trees):
    """``fn(axes, *leaves)`` over a specs tree (axes tuples as leaves) and
    trees of its structure (nested dicts, lists, named tuples)."""
    if is_axes_leaf(specs_tree):
        return fn(specs_tree, *trees)
    if isinstance(specs_tree, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs_tree.items()}
    if isinstance(specs_tree, tuple) and hasattr(specs_tree, "_fields"):
        return type(specs_tree)(*(map_specs(fn, v, *(t[i] for t in trees))
                                  for i, v in enumerate(specs_tree)))
    if isinstance(specs_tree, (list, tuple)):
        return type(specs_tree)(map_specs(fn, v, *(t[i] for t in trees))
                                for i, v in enumerate(specs_tree))
    raise TypeError(f"not a specs tree node: {specs_tree!r}")


def tree_shardings(specs_tree, shapes_tree, mesh, rules: dict):
    """A specs tree (+ a tree of tensors or anything with ``.shape`` of
    its structure) -> the tree of PartitionSpecs over ``mesh``."""
    return map_specs(lambda axes, t: spec_for(axes, t.shape, mesh, rules),
                     specs_tree, shapes_tree)


def local_bytes(specs_tree, tensors_tree, mesh, rules: dict) -> int:
    """The bytes one chip holds of a tree of tensors (meta tensors will
    do) laid out by :func:`tree_shardings`."""
    total = [0]

    def one(axes, t):
        spec = spec_for(axes, t.shape, mesh, rules)
        total[0] += math.prod(local_shape(t.shape, spec, mesh)) * \
            t.element_size()

    map_specs(one, specs_tree, tensors_tree)
    return total[0]


# -- ambient mesh context ------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict):
    """Record (mesh, rules) for :func:`logical_constraint` in this thread."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh_rules():
    return getattr(_ctx, "state", None)


def logical_constraint(x, axes):
    """The reference's ``with_sharding_constraint`` by logical axes.  It
    is the identity everywhere, in a mesh context or not: the port places
    no whole-model tensor across ranks (no ``DTensor`` placement per
    :func:`spec_for`); the explicit collectives
    (:mod:`repro_torch.distributed.collectives`) are what runs over
    ranks."""
    return x
