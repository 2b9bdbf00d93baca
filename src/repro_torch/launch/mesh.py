"""Meshes (``repro.launch.mesh`` counterpart).

A :class:`Mesh` is a shape and its axis names: the dry-run and the
sharding rules read only its ``.shape`` (axis name -> size), which is all
that :func:`repro_torch.distributed.sharding.spec_for` needs to cut a
tensor.  :func:`make_production_mesh` stays abstract (the dry-run prices
16 x 16 and 2 x 16 x 16 without the chips).

:func:`make_test_mesh` lays a mesh over the ranks of the initialised
default process group (:func:`init_ranks`): rank ``r`` sits at the
row-major coordinate of ``r`` in the shape, as JAX lays a mesh over its
device list.  Such a mesh also carries a
:class:`~torch.distributed.device_mesh.DeviceMesh`, this rank's
coordinate on each axis, and a process group for every set of axes
(:meth:`Mesh.group`), which the port's collectives
(:mod:`repro_torch.distributed.collectives`) and ``shard_map`` run over,
and on which :func:`repro_torch.distributed.sharding.place` lays DTensors.

:func:`fake_mesh` lays a production-size mesh over a fake process
group (``torch.testing``'s ``FakeStore``, backend ``fake``): this process
is rank 0 of ``n`` ranks whose collectives move nothing, which is what
the dry-run needs to run one chip's share of a sharded step on meta
tensors.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

#: the process-group backend of each device type; nothing falls back
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A device mesh: ``shape`` maps each axis name to its size, in order;
    ``size`` is the number of chips it stands for.  Built by
    :func:`make_test_mesh` it also holds ranks (``has_ranks``); built
    directly it is abstract."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"bad mesh: shape {shape}, axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.device_mesh = None
        #: the axes of each dim of ``device_mesh`` (adjacent mesh axes
        #: that every rule names together may share one)
        self.device_axes = tuple((a,) for a in axis_names)
        self.coords: dict | None = None
        self._groups: dict = {}     # axes in mesh order -> this rank's group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def tag(self) -> str:
        """``16x16``, ``2x16x16``: the dry-run's name for the mesh."""
        return "x".join(str(s) for s in self.shape.values())

    @property
    def has_ranks(self) -> bool:
        return self.device_mesh is not None

    def rank_at(self, coords: dict) -> int:
        """The global rank at a coordinate (axis name -> index)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def group(self, axes):
        """``(process group, member ranks)`` of this rank's group over
        ``axes`` (a name or a tuple of names): the ranks that differ from
        this one on those axes only, listed row-major over ``axes`` in the
        order given, as JAX orders a tuple of mesh axes.  (The group's own
        rank order is ascending global rank; the collectives map
        between the two.)"""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.has_ranks or self.coords is None:
            raise RuntimeError("this mesh holds no ranks of this process")
        members = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            at = dict(self.coords)
            at.update(zip(axes, idx))
            members.append(self.rank_at(at))
        return self._groups[tuple(a for a in self.axis_names
                                  if a in axes)], members

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The single-pod (16, 16) ``("data", "model")`` mesh (256 chips), or
    with ``multi_pod`` the (2, 16, 16) ``("pod", "data", "model")`` one
    (512)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def init_ranks(device=None, rank: int = 0, world_size: int = 1,
               init_method: str | None = None) -> torch.device:
    """Start the default process group for ``device`` (``cuda`` unless
    ``"cpu"``): NCCL on the card, gloo on the CPU.  ``init_method``
    defaults to a ``file://`` store in a fresh temporary directory, which
    serves a one-rank group; several ranks pass one store they share
    (a ``file://`` path or a ``tcp://`` address).  On the card rank ``r``
    takes device ``r`` modulo the device count.  Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if init_method is None:
        if world_size != 1:
            raise ValueError("several ranks need an init_method they share")
        init_method = f"file://{tempfile.mkdtemp()}/store"
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            rank=rank, world_size=world_size)
    return dev


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device=None) -> Mesh:
    """A mesh over the ranks of the initialised default group (the first
    ``prod(shape)`` of them; a rank past those holds no coordinate).
    Raises when the world is smaller than the mesh, and when the group's
    backend is not the one of ``device`` (``cuda`` unless ``"cpu"``).

    Every rank must call this, in the same order as its other group
    constructors: it creates a group for each set of axes, collectively."""
    mesh = Mesh(shape, axes)
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_ranks first")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise RuntimeError(f"a {dev.type} mesh needs a "
                           f"{BACKENDS[dev.type]} group, not {backend}")
    n, world = mesh.size, dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} devices, have {world}")
    return _lay_ranks(mesh, dev.type)


def _lay_ranks(mesh: Mesh, device_type: str, merge=()) -> Mesh:
    """Give ``mesh`` the first ``mesh.size`` ranks of the default group,
    row-major, with this rank's coordinate and its groups.  Each tuple of
    ``merge`` (adjacent axes, in mesh order) becomes one dim of the
    DeviceMesh, which DTensor then shards over in one collective."""
    from torch.distributed.device_mesh import DeviceMesh

    n = mesh.size
    names = list(mesh.axis_names)
    dims, i = [], 0
    while i < len(names):
        group = next((tuple(g) for g in merge if names[i:i + len(g)]
                      == list(g)), (names[i],))
        dims.append(group)
        i += len(group)
    ranks = torch.arange(n).reshape(tuple(mesh.shape.values()))
    mesh.device_axes = tuple(dims)
    mesh.device_mesh = DeviceMesh(
        device_type, torch.arange(n).reshape(tuple(
            math.prod(mesh.shape[a] for a in g) for g in dims)),
        mesh_dim_names=tuple("_".join(g) for g in dims))
    me = dist.get_rank()
    if me < n:
        mesh.coords = dict(zip(mesh.axis_names,
                               (int(i) for i in (ranks == me).nonzero()[0])))
    # a DeviceMesh dim of one axis lends its group; every other set of
    # axes gets one group a subgroup, created in one order on every rank
    # (new_group is collective over the whole world)
    for k in range(1, len(mesh.axis_names) + 1):
        for sub in itertools.combinations(range(len(mesh.axis_names)), k):
            key = tuple(mesh.axis_names[i] for i in sub)
            if k == 1 and key in dims:
                if mesh.coords is not None:
                    mesh._groups[key] = mesh.device_mesh.get_group(key[0])
                continue
            rest = [i for i in range(ranks.dim()) if i not in sub]
            flat = ranks.permute(*rest, *sub).reshape(-1, math.prod(
                ranks.shape[i] for i in sub))
            for row in flat.tolist():
                group = dist.new_group(sorted(row))
                if me in row:
                    mesh._groups[key] = group
    return mesh


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str], merge=(),
              device_type: str = "cuda"):
    """A mesh of ``shape`` over a fake process group of ``prod(shape)``
    ranks, this process rank 0 (its collectives return at once and move
    no data), for the duration of the context; ``merge`` as
    :func:`_lay_ranks` takes it.  ``device_type`` is the DeviceMesh's:
    DTensor redistributes as it would on those ranks (on ``cpu`` ranks it
    turns an all-to-all into an all-gather, as gloo has none), whatever
    device the local tensors live on.  The fake group is the default group
    meanwhile, so a process that already has one raises (the caller's
    group is never torn down: count in a process of its own)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = Mesh(shape, axes)
    if dist.is_initialized():
        raise RuntimeError(
            "a sharded count needs a process of its own: this one already "
            f"has a {dist.get_backend()} process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield _lay_ranks(mesh, device_type, merge)
    finally:
        dist.destroy_process_group()
