"""Production meshes (``repro.launch.mesh`` counterpart), abstract.

A :class:`Mesh` here is a shape and its axis names, nothing more: it holds
no devices and no process group.  The dry-run and the sharding rules only
read its ``.shape`` (axis name -> size), which is all that
:func:`repro_torch.distributed.sharding.spec_for` needs to cut a tensor.
The port has no mesh over real ranks yet.
"""
from __future__ import annotations

import math
from typing import Sequence


class Mesh:
    """An abstract device mesh: ``shape`` maps each axis name to its size,
    in order; ``size`` is the number of chips it stands for."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"bad mesh: shape {shape}, axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def tag(self) -> str:
        """``16x16``, ``2x16x16``: the dry-run's name for the mesh."""
        return "x".join(str(s) for s in self.shape.values())

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The single-pod (16, 16) ``("data", "model")`` mesh (256 chips), or
    with ``multi_pod`` the (2, 16, 16) ``("pod", "data", "model")`` one
    (512)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))
