"""Spans of the serving path: a bounded in-memory record on the host clock.

A span is a named interval of ``time.perf_counter()`` (the clock of
:class:`~repro_torch.serving.engine.TierStats` and of
:class:`~repro_torch.serving.scheduler.MonotonicClock`) with a few counts
attached.  The engine and the lane runner open four:

- ``serve.step``: one :meth:`Engine.step`, whole;
- ``serve.prefill``: one runner prefill call (``tier``);
- ``serve.decode``: one runner decode call (``tier``; ``ctx_used``, the
  positions the live rows attend, from the engine; ``ctx_attended``, the
  positions the gathered view holds over all its rows, counted by the
  runner that gathers it; ``attn_kernel_layers``, the layers whose
  attention core took the fused decode kernel, counted by the runner);
- ``serve.sync``: the greedy pick and its copy to the host, where a call
  waits for the device.

On exit a span is appended to a ring of the last :data:`CAPACITY` spans,
so the record can stay on: it costs two clock readings and an append.
Only while ``torch.profiler`` runs does a span also open a
``record_function`` of its name, which puts it in the profiler's
timeline; with no profiler running none is entered.

The record is the process's, kept for one serving loop on one thread.
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["CAPACITY", "Span", "clear", "count", "profiling", "span",
           "spans"]

#: spans the ring keeps; past it the oldest go first
CAPACITY = 2 ** 15


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    #: ``index`` of the span open around this one, None at the top
    parent: Optional[int]
    attrs: dict
    #: the order in which spans were entered, counted over the process
    index: int


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_open: list = []        # the spans open now, innermost last
_entered = 0


def profiling() -> bool:
    """Whether ``torch.profiler`` is recording now (read per span; a
    ``record_function`` costs microseconds even with no profiler)."""
    return torch.autograd.profiler._is_profiler_enabled


class _Open:
    """One span while it is open; ``t0`` / ``t1`` are readable after exit
    (the engine adds them to its :class:`TierStats`)."""

    __slots__ = ("name", "attrs", "index", "parent", "t0", "t1", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Open":
        global _entered
        self.parent = _open[-1].index if _open else None
        self.index = _entered
        _entered += 1
        _open.append(self)
        self._fn = None
        if profiling():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _open.pop()
        _ring.append(Span(self.name, self.t0, self.t1, self.parent,
                          self.attrs, self.index))


def span(name: str, **attrs) -> _Open:
    """A context manager that records ``name`` over its body, with
    ``attrs`` (counts known when it opens)."""
    return _Open(name, attrs)


def count(**attrs) -> None:
    """Add counts to the innermost open span (none open: nothing), for a
    callee that knows them only once it has done its work."""
    if _open:
        _open[-1].attrs.update(attrs)


def spans() -> list:
    """The ring's spans, oldest first, in the order they closed."""
    return list(_ring)


def clear() -> None:
    """Empty the ring."""
    _ring.clear()
