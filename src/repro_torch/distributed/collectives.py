"""The port's ``jax.lax`` collectives and ``shard_map``, over the process
groups of a mesh with ranks (:func:`repro_torch.launch.mesh.make_test_mesh`).

Every rank runs the same Python program on its own tensors, as every
device runs the body of a ``shard_map``, and the collectives belong in
such a body.  A tuple of mesh axes orders its ranks row-major over the
tuple, as JAX orders them: chunk ``j`` of an :func:`all_to_all` goes to
the ``j``-th rank of that order, and the chunks received are
concatenated in it.

:func:`shard_map` cuts each full input to this rank's block by its
:class:`~repro_torch.distributed.sharding.PartitionSpec`, runs the body on
the blocks, and reassembles each output from its ``out_spec`` by an
all-gather over the spec's axes (a ``P()`` output is each rank's own).
Inside a placed step (DTensor inputs, :func:`~repro_torch.distributed.
sharding.place`) it takes each DTensor input's local block, laid out by
its spec first, and returns each output as a DTensor laid out by its
``out_spec``, as JAX's ``shard_map`` runs inside ``jit``.
Its gradient is the single program's, as JAX transposes a ``shard_map``
with ``check_rep=False``: an output's cotangent is divided by the size of
the axes its spec leaves out (the ranks that hold the same block), and an
input's cotangent is summed over the axes its spec leaves out and
gathered over the axes it names, so every rank holds the whole gradient.
Under that convention the collectives transpose as in JAX:
``all_to_all`` to the inverse ``all_to_all``, ``ppermute`` to the inverse
permutation, ``psum`` to a ``psum`` (``pmean`` to a ``pmean``), and
``broadcast`` to the sum of the cotangents on its source.

Inside :func:`count_collectives` every collective adds the bytes of its
output on this rank (what the rank receives, its own chunk included) to
the count of its kind, under the reference's names: ``all-to-all``,
``all-reduce``, ``all-gather``, ``reduce-scatter``, ``collective-permute``
(a broadcast counts as the permute from the source to each rank, the
reference's form).  That holds for this module's collectives and for the
ones DTensor runs to redistribute a placed tensor (its
``_c10d_functional`` ops, :func:`functional_kind`).  Backward collectives
count into the counter that was active when their forward ran, whichever
thread autograd runs them on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_util

from .sharding import PartitionSpec, is_dtensor, placements_for


@dataclasses.dataclass
class CollectiveStats:
    """Bytes a rank received by collective kind (``by_kind``)."""

    by_kind: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.by_kind.values()))


_ctx = threading.local()


def _stats():
    return getattr(_ctx, "stats", None)


#: DTensor's collectives (``_c10d_functional`` ops) by the reference's kind
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-permute"}


def functional_kind(func):
    """The reference's kind of a collective op that DTensor runs to
    redistribute (a ``_c10d_functional`` op, or ``_dtensor``'s
    ``shard_dim_alltoall``, its all-to-all between two shardings on ranks
    that have one), else None."""
    if func.namespace == "_dtensor" and func._opname == "shard_dim_alltoall":
        return "all-to-all"
    if func.namespace not in ("_c10d_functional",
                              "_c10d_functional_autograd"):
        return None
    return _FUNCTIONAL.get(func._opname)


class _FunctionalCounter(TorchDispatchMode):
    """Adds each ``_c10d_functional`` collective's output bytes to
    ``stats``; DTensor-level ops pass on, so it sees the local ones."""

    def __init__(self, stats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = functional_kind(func)
        if kind is not None:
            _record(self.stats, kind, out)
        return out


@contextlib.contextmanager
def count_collectives():
    """Count the collectives this thread runs (and their backward) into a
    fresh :class:`CollectiveStats`, which the context yields: this
    module's and DTensor's."""
    stats, prev = CollectiveStats(), _stats()
    _ctx.stats = stats
    try:
        with _FunctionalCounter(stats):
            yield stats
    finally:
        _ctx.stats = prev


def _record(stats, kind: str, t: torch.Tensor):
    if stats is not None:
        stats.by_kind[kind] = (stats.by_kind.get(kind, 0)
                               + t.numel() * t.element_size())


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes) -> int:
    """This rank's index on ``axes`` (a name, or a tuple of names taken
    row-major): ``jax.lax.axis_index``."""
    i = 0
    for a in _axes(axes):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def _group(mesh, axes):
    """(group, members in axis order, axis index of each group rank)."""
    grp, members = mesh.group(_axes(axes))
    return grp, members, [members.index(r) for r in sorted(members)]


def _all_to_all(x, mesh, axes, split_axis, concat_axis, stats):
    grp, members, at = _group(mesh, axes)
    n = len(members)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    chunks = x.chunk(n, split_axis)
    send = torch.stack([chunks[j] for j in at])      # by group rank
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=grp)
    _record(stats, "all-to-all", recv)
    by_index = [None] * n
    for g, j in enumerate(at):
        by_index[j] = recv[g]
    return torch.cat(by_index, dim=concat_axis)


def _all_reduce(x, mesh, axes, stats, mean: bool):
    grp, members, _ = _group(mesh, axes)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=grp)
    _record(stats, "all-reduce", y)
    return y / len(members) if mean else y


def _all_gather(x, mesh, axes, stats) -> list:
    """Every member's ``x``, in axis order."""
    grp, members, at = _group(mesh, axes)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in members]
    dist.all_gather(parts, x, group=grp)
    for p in parts:
        _record(stats, "all-gather", p)
    by_index = [None] * len(members)
    for g, j in enumerate(at):
        by_index[j] = parts[g]
    return by_index


def _ppermute(x, mesh, axis, perm, stats):
    grp, members, _ = _group(mesh, axis)
    me = axis_index(mesh, axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, members[dst], group=grp))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, members[src], group=grp))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _record(stats, "collective-permute", out)
    return out


def _broadcast(x, mesh, axis, src, stats):
    grp, members, _ = _group(mesh, axis)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=members[src], group=grp)
    _record(stats, "collective-permute", y)
    return y


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_axis, concat_axis, stats):
        ctx.args = (mesh, axes, split_axis, concat_axis, stats)
        return _all_to_all(x, mesh, axes, split_axis, concat_axis, stats)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_axis, concat_axis, stats = ctx.args
        return (_all_to_all(g, mesh, axes, concat_axis, split_axis, stats),
                None, None, None, None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, mean, stats):
        ctx.args = (mesh, axes, mean, stats)
        return _all_reduce(x, mesh, axes, stats, mean)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, mean, stats = ctx.args
        return _all_reduce(g, mesh, axes, stats, mean), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm, stats):
        ctx.args = (mesh, axis, perm, stats)
        return _ppermute(x, mesh, axis, perm, stats)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm, stats = ctx.args
        inverse = [(dst, src) for src, dst in perm]
        return _ppermute(g, mesh, axis, inverse, stats), None, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src, stats):
        ctx.args = (mesh, axis, axis_index(mesh, axis) == src, stats)
        return _broadcast(x, mesh, axis, src, stats)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, is_src, stats = ctx.args
        g = _all_reduce(g, mesh, axis, stats, mean=False)
        return (g if is_src else torch.zeros_like(g)), None, None, None, None


def all_to_all(x, mesh, axes, split_axis: int, concat_axis: int):
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axes``: ``x`` cut in
    ``n`` chunks along ``split_axis``, chunk ``j`` sent to the ``j``-th
    rank, the chunks received concatenated along ``concat_axis`` in rank
    order; ``(E, C, D)`` with split 0 and concat 1 gives
    ``(E / n, C * n, D)``."""
    return _AllToAll.apply(x, mesh, axes, split_axis, concat_axis, _stats())


def psum(x, mesh, axes):
    """The sum of ``x`` over the ranks of ``axes`` (``jax.lax.psum``)."""
    return _AllReduce.apply(x, mesh, axes, False, _stats())


def pmean(x, mesh, axes):
    """The sum over ``axes`` divided by their size (``jax.lax.pmean``)."""
    return _AllReduce.apply(x, mesh, axes, True, _stats())


def ppermute(x, mesh, axis, perm):
    """``jax.lax.ppermute``: rank ``src`` of ``axis`` sends ``x`` to rank
    ``dst`` for each ``(src, dst)`` of ``perm`` (point to point); a rank
    no one sends to gets zeros."""
    return _PPermute.apply(x, mesh, axis, tuple(perm), _stats())


def broadcast(x, mesh, axis, src: int = 0):
    """``x`` of the ``src``-th rank of ``axis``, on every rank of it."""
    return _Broadcast.apply(x, mesh, axis, src, _stats())


def exchange_rows(x, mesh, axes, send, recv):
    """An all-to-all of rows with uneven counts over ``axes`` (no
    gradient: a batch's rows): ``x``'s rows in order, ``send[j]`` of them
    to the ``j``-th rank, and ``recv[j]`` rows from the ``j``-th rank,
    concatenated in rank order."""
    grp, members, at = _group(mesh, axes)
    pieces = x.split(list(send))
    out = x.new_empty((sum(recv), *x.shape[1:]))
    # the group's own rank order is ascending global rank
    dist.all_to_all_single(out, torch.cat([pieces[j] for j in at]),
                           [recv[j] for j in at], [send[j] for j in at],
                           group=grp)
    _record(_stats(), "all-to-all", out)
    got = out.split([recv[j] for j in at])
    by_index = [None] * len(members)
    for g, j in enumerate(at):
        by_index[j] = got[g]
    return torch.cat(by_index)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _spec_axes(spec, ndim: int) -> list:
    """Per dim, the tuple of mesh axes it is sharded over (maybe empty)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [() if a is None else _axes(a) for a in spec]


def _block(mesh, dims, shape, index=None) -> tuple:
    """The slices of a block of ``shape`` (this rank's, or the block at
    row-major ``index`` over the spec's axes)."""
    flat = [a for axes in dims for a in axes]
    coords = (mesh.coords if index is None else
              dict(zip(flat, _unravel(index, [mesh.shape[a] for a in flat]))))
    out = []
    for d, axes in zip(shape, dims):
        n = math.prod(mesh.shape[a] for a in axes)
        if d % n:
            raise ValueError(f"dim of {d} does not split {n} ways over {axes}")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def _unravel(i: int, sizes: list) -> list:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return out[::-1]


def _assemble(x, mesh, dims, stats):
    """The full tensor from every rank's block ``x`` (an all-gather over
    the axes ``dims`` name)."""
    flat = tuple(a for axes in dims for a in axes)
    if not flat:
        return x
    parts = _all_gather(x, mesh, flat, stats)
    full = x.new_empty([d * math.prod(mesh.shape[a] for a in axes)
                        for d, axes in zip(x.shape, dims)])
    for i, p in enumerate(parts):
        full[_block(mesh, dims, full.shape, i)] = p
    return full


class _Cut(torch.autograd.Function):
    """This rank's block of a full input; backward, the cotangent summed
    over the axes the spec leaves out and gathered over those it names."""

    @staticmethod
    def forward(ctx, x, mesh, dims, stats):
        ctx.args = (mesh, dims, stats)
        return x[_block(mesh, dims, x.shape)].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, dims, stats = ctx.args
        named = {a for axes in dims for a in axes}
        rest = tuple(a for a in mesh.axis_names if a not in named)
        if rest:
            g = _all_reduce(g, mesh, rest, stats, mean=False)
        return _assemble(g, mesh, dims, stats), None, None, None


class _Assemble(torch.autograd.Function):
    """The full output from the ranks' blocks; backward, this rank's block
    of the cotangent, divided by the size of the axes the spec leaves out
    (the ranks holding the same block), as JAX's ``shard_map`` transposes
    with ``check_rep=False``: a cotangent then sums to the whole once its
    input's cotangent is summed over those ranks."""

    @staticmethod
    def forward(ctx, x, mesh, dims, stats):
        named = {a for axes in dims for a in axes}
        ctx.args = (mesh, dims, math.prod(
            n for a, n in mesh.shape.items() if a not in named))
        return _assemble(x, mesh, dims, stats) if named else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, reps = ctx.args
        g = g[_block(mesh, dims, g.shape)]
        return (g / reps if reps > 1 else g), None, None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity; its backward scales the cotangent by ``1 / reps``."""

    @staticmethod
    def forward(ctx, x, reps):
        ctx.reps = reps
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.reps, None


def _local_block(t, mesh, spec):
    """This rank's block of the DTensor ``t``, laid out by ``spec`` first;
    its cotangent comes back sharded on the axes ``spec`` names and summed
    over the rest (``Partial``)."""
    want = placements_for(tuple(spec) + (None,) * (t.dim() - len(spec)),
                          mesh)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh.device_mesh, want)
    return t.to_local(grad_placements=[
        p if isinstance(p, Shard) else Partial() for p in want])


def _placed(o, mesh, spec):
    """The DTensor of this rank's output block ``o`` laid out by
    ``spec``; its cotangent is divided by the ranks that hold the same
    block (the ``_Assemble`` convention)."""
    # the global stride below is a contiguous tensor's
    o = o.contiguous()
    dims = _spec_axes(spec, o.dim())
    named = {a for axes in dims for a in axes}
    reps = math.prod(n for a, n in mesh.shape.items() if a not in named)
    if reps > 1:
        o = _ScaleGrad.apply(o, reps)
    shape = tuple(d * math.prod(mesh.shape[a] for a in axes)
                  for d, axes in zip(o.shape, dims))
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(o, mesh.device_mesh,
                              placements_for(tuple(spec) + (None,) * (
                                  o.dim() - len(spec)), mesh),
                              run_check=False, shape=shape, stride=stride)


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` run on this rank's blocks of its inputs (``jax.experimental.
    shard_map`` with ``check_rep=False``).  ``in_specs`` holds one
    :class:`PartitionSpec` an argument, applied to every tensor of that
    argument (a tensor or a tree of them); ``out_specs`` is a spec (``fn``
    returns a tensor) or a tuple of specs (a tuple of tensors).  Each
    output comes back whole on every rank of its spec's axes, or, when an
    input is a DTensor, as a DTensor laid out by its spec."""
    def run(*args):
        stats = _stats()
        placed = any(is_dtensor(t) for t in tree_util.leaves(args))

        def cut(t, spec):
            if is_dtensor(t):
                return _local_block(t, mesh, spec)
            return _Cut.apply(t, mesh, _spec_axes(spec, t.dim()), stats)

        local = [tree_util.map(lambda t, s=spec: cut(t, s), a)
                 for a, spec in zip(args, in_specs, strict=True)]
        out = fn(*local)
        single = isinstance(out_specs, PartitionSpec)
        outs, specs = ((out,), (out_specs,)) if single else (out, out_specs)
        if placed:
            full = tuple(_placed(o, mesh, s)
                         for o, s in zip(outs, specs, strict=True))
        else:
            full = tuple(_Assemble.apply(o, mesh, _spec_axes(s, o.dim()),
                                         stats)
                         for o, s in zip(outs, specs, strict=True))
        return full[0] if single else full
    return run
