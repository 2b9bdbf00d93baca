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
import contextvars
import threading

__all__ = [
    "current_numerics",
    "current_path",
    "fp64_sums",
    "fp64_sums_on",
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


_FP64_SUMS = contextvars.ContextVar("fp64_sums", default=False)


@contextlib.contextmanager
def fp64_sums(on: bool = True):
    """The serving path's sums: while on, the reductions whose order the
    library picks by shape or by placement (``rmsnorm``, the blockwise
    attention's scores, softmax and PV sums, the MoE router, and the
    segmented matmul's plain route, :func:`repro_torch.kernels.dispatch.
    matmul`) run in fp64 and round once, so a row's result does not
    depend on how many rows share the call, nor a placed product's on how
    many ranks share its contraction (see
    :func:`repro_torch.models.layers.einsum_f64`).
    ``transformer.prefill`` and ``transformer.decode_step`` (which also
    runs a chunked prefill) turn it on; ``transformer.loss_fn`` turns it
    off, so training keeps the reference's fp32 sums."""
    token = _FP64_SUMS.set(bool(on))
    try:
        yield
    finally:
        _FP64_SUMS.reset(token)


def fp64_sums_on() -> bool:
    """Whether :func:`fp64_sums` is on here."""
    return _FP64_SUMS.get()


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
