"""Dynamic numerics scoping: precision as an ambient property of a region.

A thread-local stack of ambient numerics values plus a thread-local stack
of layer-name segments.  ``nmatmul(x, w)`` resolves its config from the
innermost :func:`numerics_scope` and its layer path from the joined
:func:`layer_scope` stack.  PyTorch runs eagerly, so resolution happens
on every call (there is no trace to bake it into).

The stacks are ``threading.local``: sessions in different threads cannot
observe each other's scopes.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = [
    "current_numerics",
    "current_path",
    "layer_scope",
    "numerics_scope",
    "resolve_here",
    "restored",
    "snapshot",
]


class _ScopeState(threading.local):
    def __init__(self):
        self.numerics = []   # stack of ambient numerics (config or policy)
        self.path = []       # stack of layer-path segments


_STATE = _ScopeState()


@contextlib.contextmanager
def numerics_scope(numerics):
    """Make ``numerics`` ambient; nested scopes shadow outer ones."""
    _STATE.numerics.append(numerics)
    try:
        yield numerics
    finally:
        _STATE.numerics.pop()


@contextlib.contextmanager
def layer_scope(name):
    """Push one layer-path segment (dotted names allowed: ``blocks.3``)."""
    _STATE.path.append(str(name))
    try:
        yield
    finally:
        _STATE.path.pop()


def snapshot():
    """The ambient numerics and layer-path stacks, for :func:`restored`."""
    return tuple(_STATE.numerics), tuple(_STATE.path)


@contextlib.contextmanager
def restored(snap):
    """Run with the stacks of a :func:`snapshot` in place of this thread's,
    e.g. where autograd recomputes a checkpointed region in its own
    thread, outside the scopes the forward ran under."""
    saved = _STATE.numerics, _STATE.path
    _STATE.numerics, _STATE.path = list(snap[0]), list(snap[1])
    try:
        yield
    finally:
        _STATE.numerics, _STATE.path = saved


def current_numerics():
    """The innermost ambient numerics, or None outside any scope."""
    return _STATE.numerics[-1] if _STATE.numerics else None


def current_path(leaf: str = "") -> str:
    """Dot-joined layer path of the active ``layer_scope`` stack
    (+ ``leaf`` appended when given)."""
    parts = [p for p in _STATE.path if p]
    if leaf:
        parts.append(leaf)
    return ".".join(parts)


def resolve_here(leaf: str = ""):
    """The concrete :class:`~repro_torch.core.numerics.NumericsConfig` at
    the current scope (+ optional ``leaf``): the ambient config itself, or
    ``amb.lookup(path)`` for a duck-typed policy; EXACT outside any
    scope."""
    # deferred: numerics imports scope
    from .numerics import EXACT, NumericsConfig

    amb = current_numerics()
    if amb is None:
        return EXACT
    if isinstance(amb, NumericsConfig):
        return amb
    return amb.lookup(current_path(leaf))
