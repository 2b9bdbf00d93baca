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
with ranks (``make_test_mesh``, or the dry-run's fake group) a spec is a
DTensor placement (:func:`placements_for`): :func:`place` lays a whole
tree (params, optimizer state, serving state, batch) over the mesh as
DTensors, each rank holding its block, and the step functions run on
them unchanged, as the reference's ``jit`` runs them under
``in_shardings``.  Inside a step :func:`logical_constraint` redistributes
an activation to its rule's spec (the reference's
``with_sharding_constraint``), the kernels shard by their ops' rules
(``kernels/custom_ops.py``), and the explicit collectives run on the
mesh's groups: :func:`repro_torch.distributed.collectives.shard_map`
takes a DTensor's local block, and MoE's expert-parallel path reads
:func:`spec_for` under :func:`use_mesh_rules`.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

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
    """Record (mesh, rules) for :func:`logical_constraint` in this thread.
    On a mesh with ranks a plain tensor that meets a DTensor in an op (a
    mask, ``arange`` positions, a constant) counts as replicated, as a
    constant does inside the reference's ``jit``."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        if getattr(mesh, "has_ranks", False):
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _ctx.state = prev


def current_mesh_rules():
    return getattr(_ctx, "state", None)


def placement_context():
    """``(mesh, rules)`` of the ambient :func:`use_mesh_rules` on a mesh
    with ranks; raises elsewhere (a placed step runs inside one)."""
    state = current_mesh_rules()
    if state is None or not getattr(state[0], "has_ranks", False):
        raise RuntimeError("a placed step runs under use_mesh_rules(mesh, "
                           "rules) on a mesh with ranks")
    return state


def logical_constraint(x, axes):
    """The reference's ``with_sharding_constraint`` by logical axes: under
    :func:`use_mesh_rules` on a mesh with ranks, a DTensor ``x`` is
    redistributed to ``spec_for(axes, x.shape, ...)`` (nothing moves when
    it is laid out so already).  Anywhere else, and for a plain tensor,
    it is the identity."""
    state = current_mesh_rules()
    if state is None or not is_dtensor(x):
        return x
    mesh, rules = state
    if not getattr(mesh, "has_ranks", False):
        return x
    want = placements_for(spec_for(axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh.device_mesh, want)


# -- placement over a mesh with ranks -----------------------------------------

def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def is_split(x) -> bool:
    """A DTensor that some rank does not hold whole (a ``Shard`` or a
    ``Partial`` placement): a DTensor on a mesh of one rank, or replicated
    on every dim, is not."""
    return is_dtensor(x) and not all(p.is_replicate() for p in x.placements)


def reduced(x, dim=None):
    """``x`` with every pending ``Partial`` sum of a DTensor reduced in
    ``x``'s dtype: scattered over ``dim`` (a reduce-scatter) where that
    dim is not sharded yet and splits evenly, else whole (an all-reduce);
    anything else as it is.  A contraction over a sharded dim leaves a
    partial sum, which DTensor would carry through a cast and sum in the
    narrower dtype; XLA reduces a dot's partial sums in the dot's own
    accumulation dtype (scattering them where the result is sharded next),
    and so does the port, at the product."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x

    mesh = x.device_mesh
    parts = [m for m, p in enumerate(x.placements) if p.is_partial()]
    n = math.prod(mesh.size(m) for m in parts)
    scatter = (dim is not None and x.dim() > dim and x.shape[dim] % n == 0
               and not any(p.is_shard(dim) for p in x.placements))
    return x.redistribute(mesh, [
        (Shard(dim) if scatter else Replicate()) if p.is_partial() else p
        for p in x.placements])


def placements_for(spec, mesh) -> tuple:
    """``spec`` as DTensor placements over ``mesh.device_mesh``, one a
    DeviceMesh dim: ``Shard(d)`` on every dim whose axes dim ``d`` names,
    ``Replicate()`` on the rest (and on a dim of one chip).  A tuple of
    axes shards its dim over
    them in the tuple's row-major order, as JAX does; DTensor nests the
    shards of one dim in the mesh's order, so a tuple in another order,
    or one that names part of a merged DeviceMesh dim
    (``mesh.device_axes``), raises."""

    groups = list(mesh.device_axes)
    out = [Replicate()] * len(groups)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        flat = (axis,) if isinstance(axis, str) else tuple(axis)
        i, last = 0, -1
        while i < len(flat):
            g = next((j for j, grp in enumerate(groups)
                      if flat[i:i + len(grp)] == grp), None)
            if g is None or g <= last:
                raise ValueError(
                    f"spec {spec!r}: dim {d} shards over {flat}, which the "
                    f"mesh's dims {tuple(groups)} cannot nest (DTensor "
                    f"shards one dim over whole mesh dims, in mesh order)")
            if math.prod(mesh.shape[a] for a in groups[g]) > 1:
                out[g] = Shard(d)   # an axis of one chip shards nothing
            last = g
            i += len(groups[g])
    return tuple(out)


def block_of(shape, spec, mesh) -> tuple:
    """The slices of this rank's block of a tensor of ``shape`` under
    ``spec`` (a dim over a tuple of axes: row-major over the tuple)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, axis in zip(shape, spec):
        flat = () if axis is None else (
            (axis,) if isinstance(axis, str) else tuple(axis))
        n, i = 1, 0
        for a in flat:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.coords[a]
        if d % n:
            raise ValueError(f"dim of {d} does not split {n} ways over "
                             f"{flat}")
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def place_tensor(t, spec, mesh):
    """``t`` (the whole tensor, on every rank) as a DTensor over ``mesh``
    laid out by ``spec``: this rank keeps its block of ``t`` (a view
    where the block is contiguous; nothing is sent).  A meta ``t`` gives
    a meta block, as the dry-run needs."""

    if mesh.coords is None:
        raise RuntimeError("this rank holds no coordinate of the mesh")
    local = t.detach()[block_of(t.shape, spec, mesh)].contiguous()
    return DTensor.from_local(local, mesh.device_mesh,
                              placements_for(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def _contiguous_stride(shape) -> tuple:
    return tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))


def zeros_by_rules(axes_of, device):
    """``zeros(key, shape, dtype)`` for a placed step's fresh state: the
    leaf's logical axes ``axes_of(key, rank)`` under the ambient rules,
    each rank allocating only its block (zeros), as a DTensor."""

    mesh, rules = placement_context()

    def zeros(key, shape, dtype):
        spec = spec_for(axes_of(key, len(shape)), shape, mesh, rules)
        local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype,
                            device=device)
        return DTensor.from_local(local, mesh.device_mesh,
                                  placements_for(spec, mesh), run_check=False,
                                  shape=tuple(shape),
                                  stride=_contiguous_stride(shape))

    return zeros


def place(tree, specs_tree, mesh, rules: dict):
    """A tree of whole tensors (params, optimizer state, serving state, a
    batch) as DTensors over ``mesh.device_mesh``, each leaf laid out by
    :func:`spec_for` of its logical axes (``specs_tree``, as
    :func:`map_specs` walks it).  A leaf that is not a tensor, or a 0-d
    one (an optimizer's step count, which lives on the host), stays as it
    is."""
    def one(axes, t):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        return place_tensor(t, spec_for(axes, t.shape, mesh, rules), mesh)

    return map_specs(one, specs_tree, tree)


def _block_start(t, dim: int) -> int:
    """Where this rank's block of the DTensor ``t`` starts on ``dim``."""

    mesh, i = t.device_mesh, 0
    for m, p in enumerate(t.placements):
        if p == Shard(dim):
            i = i * mesh.size(m) + mesh.get_local_rank(m)
    return i * t.to_local().shape[dim]


def _with(t, like, dim=None):
    """``t`` (a DTensor, or a plain tensor whole on every rank) laid out
    as the DTensor ``like``, but whole on ``dim``."""

    want = [Replicate() if dim is not None and p == Shard(dim) else p
            for p in like.placements]
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, like.device_mesh,
                               [Replicate()] * len(want), run_check=False)
    return t.redistribute(like.device_mesh, want)


def update_rows_(buf, new, start: int, dim: int = 1):
    """``buf.narrow(dim, start, new.shape[dim]).copy_(new)``, in place.  A
    DTensor ``buf`` is written on each rank's block (a rank writes the
    rows of its block that the range covers), as XLA partitions a
    ``dynamic_update_slice``; ``new`` is first laid out as ``buf``, whole
    on ``dim``.  Returns ``buf``."""
    if not is_dtensor(buf):
        buf.narrow(dim, start, new.shape[dim]).copy_(new)
        return buf
    if (start == 0 and tuple(new.shape) == tuple(buf.shape) and is_dtensor(new)
            and tuple(new.placements) == tuple(buf.placements)):
        buf.to_local().copy_(new.to_local())   # block onto block
        return buf
    new = _with(new, buf, dim).to_local()
    local = buf.to_local()
    lo, n = _block_start(buf, dim), local.shape[dim]
    a, b = max(start, lo), min(start + new.shape[dim], lo + n)
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(new.narrow(dim, a - start,
                                                          b - a))
    return buf


def copy_into_(buf, new):
    """``buf.copy_(new)``.  A DTensor ``buf`` is written in place on each
    rank's block, ``new`` first laid out as ``buf``.  Returns ``buf``."""
    if not is_dtensor(buf):
        return buf.copy_(new)
    buf.to_local().copy_(_with(new, buf).to_local())
    return buf


def local(t):
    """A DTensor's block on this rank; a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def laid_out_as(t, like):
    """``t`` in ``like``'s placements where both are DTensors (a gradient
    as its parameter); anything else as it is."""
    if is_dtensor(t) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def reduction_pieces(t, n: int):
    """``t`` in pieces for a sum over all its elements: a plain tensor as
    flat views of ``n`` elements (bounding the fp32 copy a reduction
    makes), a DTensor whole (DTensor sums each block and reduces the sums
    over the mesh)."""
    if is_dtensor(t):
        return [t]
    flat = t.view(-1)
    return [flat[i:i + n] for i in range(0, flat.numel(), n)]


def micro_batch(x, i: int, n: int):
    """Micro-batch ``i`` of ``n`` of a batch tensor ``x``: its rows
    ``[i * m, (i + 1) * m)`` (``m`` = rows / ``n``), as the reference's
    ``(n, rows / n)`` reshape cuts them.  A DTensor sharded on dim 0 comes
    back laid out as ``x``: each rank's block of the micro-batch comes from
    the rank that holds those rows
    (:func:`~repro_torch.distributed.collectives.exchange_rows`: the
    micro-batch's rows move, nothing else).  Where ``m`` rows do not split
    over the ranks of dim 0, they are sliced from ``x`` gathered."""
    m = x.shape[0] // n
    if n == 1:
        return x
    if not is_dtensor(x) or not any(p.is_shard(0) for p in x.placements):
        return x[i * m:(i + 1) * m]
    from repro_torch.distributed import collectives

    block = x.to_local()
    b = block.shape[0]
    ranks = x.shape[0] // b
    if ranks * b != x.shape[0] or m % ranks:
        return x[i * m:(i + 1) * m]
    mesh, _ = placement_context()
    c, lo = m // ranks, _block_start(x, 0)
    # rank t's rows of the micro-batch, [i * m + t * c, + c), lie in one
    # rank's block (c divides b)
    send = [c if (i * m + t * c) // b == lo // b else 0 for t in range(ranks)]
    src = (i * m + (lo // b) * c) // b
    recv = [c if s == src else 0 for s in range(ranks)]
    first = next((t for t in range(ranks) if send[t]), 0)
    start = i * m + first * c - lo if any(send) else 0
    local = collectives.exchange_rows(block[start:start + sum(send)], mesh,
                                      spec_of(x, mesh)[0], send, recv)
    shape = (m, *x.shape[1:])
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def loss_pieces(x, t, n: int) -> list:
    """The ``n`` pieces ``(x_i, t_i)`` of ``x (B, S, ...)`` and ``t (B,
    S)`` for a sum over their rows and positions (a loss's chunks): rows
    ``[i * c, (i + 1) * c)`` of plain tensors.  Placed, ``t`` is first laid
    out as ``x`` on its two dims, and each rank's piece ``i`` is piece
    ``i`` of its own block, laid out as ``x``: of its rows where they split
    ``n`` ways, else of its positions where those do.  Nothing is gathered,
    where a row slice of a batch-sharded DTensor gathers the slice onto
    every rank.  The pieces hold other rows than a plain split's (a sum
    over all of them is the same up to its order); on one rank they are
    the same.  Where neither splits, the rows are sliced whole."""
    c = x.shape[0] // n

    def rows_of():
        return [(x[i * c:(i + 1) * c], t[i * c:(i + 1) * c])
                for i in range(n)]

    if n == 1 or not is_dtensor(x):
        return rows_of()
    want = [p if p.is_shard() and p.dim < t.dim() else Replicate()
            for p in x.placements]
    if not is_dtensor(t):
        t = DTensor.from_local(t, x.device_mesh, [Replicate()] * len(want),
                               run_check=False)
    if tuple(t.placements) != tuple(want):
        t = t.redistribute(x.device_mesh, want)
    local = x.to_local().shape
    dim = next((d for d in range(t.dim()) if local[d] % n == 0), None)
    if dim is None:
        return rows_of()
    return [(_piece(x, dim, i, n), _piece(t, dim, i, n)) for i in range(n)]


def _piece(x, dim: int, i: int, n: int):
    """Piece ``i`` of ``n`` of each rank's block of ``x`` on ``dim``,
    laid out as ``x``."""
    block = x.to_local()
    c = block.shape[dim] // n
    shape = list(x.shape)
    shape[dim] //= n
    return DTensor.from_local(block.narrow(dim, i * c, c).contiguous(),
                              x.device_mesh, x.placements, run_check=False,
                              shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def take_last(x, idx):
    """``torch.gather(x, -1, idx)`` (``idx (..., 1)``: one entry a row,
    the gold logit of a loss).  On a DTensor ``x`` each rank takes from
    its own block (``idx`` laid out as ``x``, whole on the last dim), and
    where ``x``'s last dim is sharded the ranks that do not hold an entry
    give 0, a ``Partial`` sum, as the reference partitions a
    ``take_along_axis``; the gradient is scattered into each rank's block.
    DTensor's own gather would take the gradient at the whole tensor's
    shape on every rank (a chunk of full-vocabulary logits)."""
    if not is_split(x):
        return torch.gather(x, -1, idx)
    return _TakeLast.apply(x, idx)


class _TakeLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        d = x.dim() - 1
        mesh, placements = x.device_mesh, tuple(x.placements)
        idx = _with(idx, x, d).to_local()
        lo, n = _block_start(x, d), x.to_local().shape[d]
        j = idx - lo
        inside = (j >= 0) & (j < n)
        j = j.clamp(0, n - 1)
        val = torch.gather(x.to_local(), d, j).masked_fill(~inside, 0)
        ctx.save_for_backward(j, inside)
        ctx.like = (mesh, placements, tuple(x.shape), x.to_local().shape)
        out_shape = (*x.shape[:-1], 1)
        return DTensor.from_local(
            val, mesh, [Partial() if p == Shard(d) else p for p in placements],
            run_check=False, shape=out_shape,
            stride=_contiguous_stride(out_shape))

    @staticmethod
    def backward(ctx, g):
        j, inside = ctx.saved_tensors
        mesh, placements, shape, local_shape = ctx.like
        d = len(shape) - 1
        g = g.redistribute(mesh, [Replicate() if p == Shard(d) else p
                                  for p in placements]).to_local()
        gx = g.new_zeros(local_shape).scatter_(d, j,
                                               g.masked_fill(~inside, 0))
        return DTensor.from_local(gx, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=_contiguous_stride(shape)), None


def inner_sharded(x) -> bool:
    """A DTensor ``x (B, ..., K)`` sharded on a leading dim past the first
    (the sequence of a residual-stream activation)."""
    return is_dtensor(x) and any(p.is_shard() and 0 < p.dim < x.dim() - 1
                                 for p in x.placements)


def spec_of(x, mesh) -> PartitionSpec:
    """The :class:`PartitionSpec` of the DTensor ``x``'s layout over
    ``mesh`` (the inverse of :func:`placements_for`); raises on a pending
    ``Partial`` sum."""
    parts = [[] for _ in range(x.dim())]
    for axes, p in zip(mesh.device_axes, x.placements):
        if p.is_partial():
            raise ValueError("a Partial DTensor has no PartitionSpec")
        if p.is_shard():
            parts[p.dim].extend(axes)
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in parts))


def column_parallel(w) -> bool:
    """A DTensor weight ``w (K, N)`` sharded on its output dim."""
    return is_dtensor(w) and any(p.is_shard(w.dim() - 1)
                                 for p in w.placements)


def on_row_blocks(fn, x, w):
    """``fn(x, w)`` for ``x (..., K)`` whose inner leading dims are
    sharded (a sequence-sharded activation) and a weight ``w (K, N)``
    whose output dim is not: each rank multiplies its own rows by the
    whole weight (gathered where it is sharded on K), and the output keeps
    ``x``'s layout, as GSPMD runs such a product on the residual's
    sequence shard where gathering the sequence would make every rank of
    its axis compute the same rows.  ``fn`` runs on plain tensors (a
    kernel's wrapper directly); the weight's gradient is summed over the
    ranks."""
    from repro_torch.distributed import collectives

    mesh, _ = placement_context()
    spec = spec_of(x, mesh)
    return collectives.shard_map(fn, mesh, (spec, P()), spec)(x, w)


def product_operands(x, w):
    """``x (..., K)`` and ``w (K, N)`` laid out for a product that moves
    nothing, chosen here from their layouts, mesh dim by mesh dim, so that
    DTensor's cost-based choice among the product's strategies (which
    differs between torch versions) decides nothing:

    - ``w`` sharded on K: a replicated ``x`` is cut on K too (a local
      chunk; the product is a ``Partial`` sum), an ``x`` sharded on K
      stays, and an ``x`` sharded on its rows takes the whole weight (the
      weight gathered on that dim: FSDP, as GSPMD gathers a ZeRO-3 weight);
    - ``w`` sharded on N: ``x`` replicated on that dim (a column-parallel
      product), or, where ``x`` is sharded there, the weight gathered;
    - ``w`` replicated: ``x`` as it is.

    A pending ``Partial`` sum of ``x`` is reduced first.  Plain tensors,
    or a mix of a DTensor and a plain tensor, are returned as they are."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x, w
    x = reduced(x)
    k = x.dim() - 1
    px, pw = list(x.placements), list(w.placements)
    for m, (a, b) in enumerate(zip(px, pw)):
        if b.is_shard(0):
            if a.is_replicate():
                px[m] = Shard(k)
            elif not a.is_shard(k):
                pw[m] = Replicate()
        elif b.is_shard(1) and not a.is_replicate():
            pw[m] = Replicate()
    if px != list(x.placements):
        x = x.redistribute(x.device_mesh, px)
    if pw != list(w.placements):
        w = w.redistribute(w.device_mesh, pw)
    return x, w


def placed_product(fn, x, w):
    """``fn(x, w)`` for a product ``x (..., K) @ w (K, N)``, its operands
    laid out here, from their layouts alone (plain tensors pass as they
    are):

    - ``x (B, S, K)`` with the sequence sharded and ``w``'s output dim
      unsharded: each rank's rows by the whole weight
      (:func:`on_row_blocks`), as GSPMD runs such a product on the
      residual's sequence shard;
    - the same ``x`` with ``w`` column-parallel: one product over the
      rows, the sequence gathered (:func:`rows`), the output reshaped back;
    - any other ``x``: as :func:`product_operands` lays the pair out."""
    if inner_sharded(x) and not column_parallel(w):
        return on_row_blocks(fn, x, w)
    if inner_sharded(x):
        out = fn(*product_operands(rows(x), w))
        return reshape(out, *x.shape[:-1], out.shape[-1])
    return fn(*product_operands(x, w))


def rows(x):
    """``x (..., K)`` as ``(rows, K)``.  A DTensor's inner leading dims
    (the sequence of a ``(B, S, K)`` activation) are gathered first, as
    GSPMD gathers a sequence-sharded activation for a column-parallel
    product: DTensor flattens dims only while the first of them alone is
    sharded."""
    if inner_sharded(x):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1 else p
            for p in x.placements])
    return reshape(x, -1, x.shape[-1])


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor whose split or merged dims
    DTensor cannot carry sharded (a dim of 1024 split into 8 heads of 128
    over 16 ranks) is first gathered on those dims, as GSPMD reshards
    such a reshape in the reference; the next constraint lays the result
    out again.  Its gradient is reshaped back and laid out as ``x``."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, _resolved(tuple(x.shape), shape))


def _reshaped(x, shape: tuple):
    try:
        return x.reshape(shape)
    except RuntimeError:

        old = tuple(x.shape)
        lead = 0
        while lead < min(len(old), len(shape)) and old[lead] == shape[lead]:
            lead += 1
        tail = 0
        while (tail < min(len(old), len(shape)) - lead
               and old[-1 - tail] == shape[-1 - tail]):
            tail += 1
        changed = set(range(lead, len(old) - tail))
        want = [Replicate() if isinstance(p, Shard) and p.dim in changed
                else p for p in x.placements]
        return x.redistribute(x.device_mesh, want).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return _reshaped(x, shape)

    @staticmethod
    def backward(ctx, g):
        # laid out as the input was: where the forward gathered a dim, the
        # gradient is cut again (a local chunk), so the product before it
        # differentiates on its own block, not on the whole tensor
        g = _reshaped(g, ctx.shape)
        if is_dtensor(g) and tuple(g.placements) != ctx.layout[1]:
            g = g.redistribute(*ctx.layout)
        return g, None


def _resolved(old, shape) -> tuple:
    """``shape`` (which may hold one -1) for a tensor of shape ``old``."""
    shape = tuple(shape[0]) if len(shape) == 1 and isinstance(
        shape[0], (tuple, list)) else tuple(shape)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(math.prod(old) // known if d == -1 else d
                      for d in shape)
    return shape
