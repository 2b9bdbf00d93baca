"""The benchmark's weights: drawn on the device from ``--seed``.

The layout (leaf names and shapes) is the port's parameter layout, which
the run reads from ``repro_torch.models.transformer.param_shapes``; the
values are the benchmark's own.  Every leaf is a view of one flat fp32
buffer filled by one ``randn_`` from a seeded ``torch.Generator`` on the
device, then scaled leaf by leaf by the configuration's recipe
(``weights.std``: a number, or ``"fan_in"`` for ``shape[-2] ** -0.5``;
``weights.const``: a constant fill).  The same tensors go to the program
and to the reference.
"""
from __future__ import annotations

import math

import torch

__all__ = ["draw", "leaf_kind", "unflatten"]


def leaf_kind(name: str) -> str:
    """``seg0_p0.attn.wq`` -> ``attn.wq``; top-level names stay whole."""
    head, _, rest = name.partition(".")
    return rest if head.startswith("seg") and rest else name


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def draw(shapes: dict, recipe: dict, seed: int, device) -> dict:
    """``shapes`` ``{dotted name: shape}`` -> the nested parameter tree."""
    device = torch.device(device)
    std, const = recipe["std"], recipe["const"]
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    flat_buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat_buf.normal_(generator=gen)
    flat, off = {}, 0
    for name, size in zip(names, sizes):
        t = flat_buf[off:off + size].view(shapes[name])
        off += size
        kind = leaf_kind(name)
        if kind in const:
            t.fill_(float(const[kind]))
        elif kind in std:
            s = std[kind]
            t.mul_(shapes[name][-2] ** -0.5 if s == "fan_in" else float(s))
        else:
            raise KeyError(f"the weight recipe has no rule for {kind!r}")
        flat[name] = t
    return unflatten(flat)
