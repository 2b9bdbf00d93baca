"""Framework-neutral state-dict model + declarative path-mapping DSL.

The port's copy of ``repro.compat.state_dict`` (numpy only).  A *state
dict* is a flat ``{dotted.path: np.ndarray}`` mapping, the lingua franca
between the nested parameter trees and foreign checkpoint layouts.  Two
layers live here:

1. **tree <-> state dict**: :func:`flatten_tree` walks a nested tree
   (dicts, lists/tuples; tensors come back to the host) into dotted keys;
   :func:`unflatten_tree` rebuilds arrays into the shape of a template
   tree, validating every leaf's shape and dtype with a one-line
   :class:`CompatError`.
2. **the mapping DSL**: a :class:`Mapping` is an ordered tuple of
   :class:`MapRule`; each rule renames one foreign key (or one stacked
   family of per-layer keys) onto one native key through an invertible
   adapter chain (axis permutation, reshape, additive shift), so one rule
   table serves both import (:meth:`Mapping.to_native`) and export
   (:meth:`Mapping.to_foreign`) and a round trip is bit-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping as TMapping, Optional, Tuple

import numpy as np

__all__ = ["CompatError", "Leaf", "MapRule", "Mapping", "flatten_tree",
           "tree_paths", "unflatten_tree"]


class CompatError(RuntimeError):
    """A checkpoint-interop error with a one-line structured message."""


# ---------------------------------------------------------------------------
# tree <-> flat state dict
# ---------------------------------------------------------------------------

def _join(prefix: str, key: str) -> str:
    return f"{prefix}.{key}" if prefix else key


def _to_numpy(node) -> np.ndarray:
    if hasattr(node, "detach"):   # a torch tensor, on any device
        return node.detach().cpu().numpy()
    return np.asarray(node)


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested tree -> flat ``{dotted.path: array}`` state dict.

    Dict keys join with ``.``; list/tuple entries use their index as the
    path segment; tensors come back to the host as numpy arrays.
    """
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], _join(path, str(k)))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, _join(path, str(i)))
        else:
            out[path] = _to_numpy(node)

    walk(tree, prefix)
    return out


def tree_paths(tree, prefix: str = "") -> list:
    """The dotted leaf paths of a tree, in :func:`flatten_tree` order."""
    return list(flatten_tree(tree, prefix))


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A template leaf: the shape and dtype a state-dict entry must have."""

    shape: tuple
    dtype: np.dtype


def _leaf_spec(leaf) -> Tuple[tuple, np.dtype]:
    """(shape, dtype) of a template leaf (a :class:`Leaf` or an array)."""
    return tuple(leaf.shape), np.dtype(leaf.dtype)


def unflatten_tree(template, sd: TMapping[str, np.ndarray], prefix: str = "",
                   *, cast: bool = False):
    """Rebuild a tree shaped like ``template`` from a flat state dict.

    ``template`` leaves only need ``.shape``/``.dtype`` (:class:`Leaf` or
    real arrays).  Each leaf is validated: a missing key,
    wrong shape, or wrong dtype raises a one-line :class:`CompatError`
    naming the offending path (``cast=True`` converts dtype mismatches
    with ``astype`` instead of failing).
    """
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], _join(path, str(k))) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, _join(path, str(i)))
                              for i, v in enumerate(node))
        if path not in sd:
            raise CompatError(f"missing key {path!r} in state dict "
                              f"({len(sd)} keys present)")
        arr = np.asarray(sd[path])
        shape, dtype = _leaf_spec(node)
        if tuple(arr.shape) != shape:
            raise CompatError(f"{path}: shape {tuple(arr.shape)} does not "
                              f"match expected {shape}")
        if arr.dtype != dtype:
            if not cast:
                raise CompatError(f"{path}: dtype {arr.dtype} does not match "
                                  f"expected {dtype} (pass cast=True to "
                                  f"convert)")
            arr = arr.astype(dtype)
        return arr

    return walk(template, prefix)


# ---------------------------------------------------------------------------
# the mapping DSL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MapRule:
    """One foreign-key -> native-key mapping with an invertible adapter
    chain (applied in import order: permute -> reshape -> ``+ shift``).

    ``transpose`` is shorthand for swapping the last two axes (the torch
    ``Linear`` (out, in) vs our (in, out) convention); ``permute`` is a
    full axes permutation (e.g. torch conv OIHW -> our HWIO is
    ``(2, 3, 1, 0)``).  ``reshape`` reshapes to the given *native* shape
    after the permutation; exporting back then needs ``src_shape`` (the
    foreign shape) to invert it.

    ``stack=N`` makes this a *stacked* rule: ``src`` must contain an
    ``{i}`` placeholder, and import gathers the adapter-applied slices
    for ``i = start, start+stride, ...`` (``N`` of them) onto a new
    leading axis of the single native key ``dst`` — our scanned
    ``seg{s}_p{p}.*`` layers layout.
    """

    src: str
    dst: str
    transpose: bool = False
    permute: Optional[Tuple[int, ...]] = None
    reshape: Optional[Tuple[int, ...]] = None
    src_shape: Optional[Tuple[int, ...]] = None
    shift: float = 0.0
    stack: int = 0
    start: int = 0
    stride: int = 1

    def __post_init__(self):
        if self.transpose and self.permute is not None:
            raise CompatError(f"rule {self.src!r}: transpose and permute "
                              f"are mutually exclusive")
        if self.stack and "{i}" not in self.src:
            raise CompatError(f"rule {self.src!r}: stack={self.stack} "
                              f"requires an {{i}} placeholder in src")

    # -- adapter chain ------------------------------------------------------

    def _perm(self, ndim: int) -> Optional[Tuple[int, ...]]:
        if self.permute is not None:
            return self.permute
        if self.transpose:
            return tuple(range(ndim - 2)) + (ndim - 1, ndim - 2)
        return None

    def adapt(self, arr: np.ndarray) -> np.ndarray:
        """Foreign array -> native array (import direction)."""
        perm = self._perm(arr.ndim)
        if perm is not None:
            arr = np.transpose(arr, perm)
        if self.reshape is not None:
            arr = np.reshape(arr, self.reshape)
        if self.shift:
            arr = arr + np.asarray(self.shift, arr.dtype)
        return arr

    def unadapt(self, arr: np.ndarray) -> np.ndarray:
        """Native array -> foreign array (export direction)."""
        if self.shift:
            arr = arr - np.asarray(self.shift, arr.dtype)
        if self.reshape is not None:
            if self.src_shape is None:
                raise CompatError(
                    f"rule {self.src!r}: exporting a reshape rule needs "
                    f"src_shape (the foreign shape) to invert it")
            perm = self._perm(len(self.src_shape))
            mid = (tuple(self.src_shape[a] for a in perm)
                   if perm is not None else tuple(self.src_shape))
            arr = np.reshape(arr, mid)
        perm = self._perm(arr.ndim)
        if perm is not None:
            arr = np.transpose(arr, tuple(np.argsort(perm)))
        return arr

    def src_keys(self) -> list:
        """The foreign key(s) this rule consumes."""
        if not self.stack:
            return [self.src]
        return [self.src.format(i=self.start + r * self.stride)
                for r in range(self.stack)]


class Mapping:
    """An ordered rule table mapping one foreign checkpoint layout onto
    one native param-tree layout (see :class:`MapRule`)."""

    def __init__(self, rules: Iterable[MapRule]):
        self.rules = tuple(rules)
        dsts = [r.dst for r in self.rules]
        if len(set(dsts)) != len(dsts):
            dup = sorted({d for d in dsts if dsts.count(d) > 1})
            raise CompatError(f"mapping has duplicate native keys: {dup}")

    def to_native(self, foreign: TMapping[str, np.ndarray], *,
                  unknown: str = "error") -> Dict[str, np.ndarray]:
        """Foreign state dict -> native state dict.

        Every rule's source key(s) must be present (one-line
        :class:`CompatError` otherwise).  Foreign keys no rule consumes
        are an error under ``unknown="error"`` (strict — catches layout
        drift) and dropped under ``unknown="ignore"`` (HF checkpoints
        carry buffers like rotary ``inv_freq`` that have no native
        counterpart).
        """
        if unknown not in ("error", "ignore"):
            raise CompatError(f"unknown= must be 'error' or 'ignore', "
                              f"got {unknown!r}")
        native: Dict[str, np.ndarray] = {}
        consumed = set()
        for rule in self.rules:
            keys = rule.src_keys()
            missing = [k for k in keys if k not in foreign]
            if missing:
                shown = ", ".join(repr(k) for k in missing[:3])
                more = f" (+{len(missing) - 3} more)" if len(missing) > 3 \
                    else ""
                raise CompatError(f"checkpoint is missing {shown}{more} "
                                  f"for native key {rule.dst!r}")
            consumed.update(keys)
            if rule.stack:
                native[rule.dst] = np.stack(
                    [rule.adapt(np.asarray(foreign[k])) for k in keys])
            else:
                native[rule.dst] = rule.adapt(np.asarray(foreign[keys[0]]))
        leftover = sorted(set(foreign) - consumed)
        if leftover and unknown == "error":
            shown = ", ".join(repr(k) for k in leftover[:3])
            more = f" (+{len(leftover) - 3} more)" if len(leftover) > 3 else ""
            raise CompatError(f"checkpoint has {len(leftover)} unmapped "
                              f"key(s): {shown}{more} (pass "
                              f"unknown='ignore' to drop them)")
        return native

    def to_foreign(self, native: TMapping[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """Native state dict -> foreign state dict (the export path;
        exact inverse of :meth:`to_native`)."""
        foreign: Dict[str, np.ndarray] = {}
        for rule in self.rules:
            if rule.dst not in native:
                raise CompatError(f"native state dict is missing "
                                  f"{rule.dst!r} (cannot export "
                                  f"{rule.src!r})")
            arr = np.asarray(native[rule.dst])
            if rule.stack:
                if arr.shape[0] != rule.stack:
                    raise CompatError(
                        f"{rule.dst}: leading (layers) axis is "
                        f"{arr.shape[0]}, rule stacks {rule.stack}")
                for r, key in enumerate(rule.src_keys()):
                    foreign[key] = rule.unadapt(arr[r])
            else:
                foreign[rule.src] = rule.unadapt(arr)
        return foreign

    def native_keys(self) -> list:
        return [r.dst for r in self.rules]
