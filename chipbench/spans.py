"""The program's own spans (``repro_torch.serving.trace``) for the readers
of ``chipbench/metrics/``: the spans that lie inside the host-clock window
(``run.t_open`` to ``run.t_host_end``, before any profiling), on the
``perf_counter`` clock that the engine and the harness share.

Nothing is read (``None``) from a program that records no spans, or where
the program's ring no longer reaches back to the window's opening (it
dropped, or was cleared of, spans of the window).
"""
from __future__ import annotations

__all__ = ["in_window", "nested_ms", "self_ms"]


def in_window(run):
    """The spans inside the window, in the order they closed, or None."""
    try:
        from repro_torch.serving import trace
    except ImportError:          # a program without the recorder
        return None
    ring = trace.spans()
    # spans land in the ring as they close: one that closed before the
    # window opened proves that every span of the window is still there
    if not ring or ring[0].t1 > run.t_open:
        return None
    return [s for s in ring
            if s.t0 >= run.t_open and s.t1 <= run.t_host_end]


def self_ms(run, name: str, children: tuple):
    """Mean ms of the window's ``name`` spans, each less its child spans
    named in ``children``."""
    spans = in_window(run)
    if spans is None:
        return None
    inner = {}
    for s in spans:
        if s.name in children:
            inner[s.parent] = inner.get(s.parent, 0.0) + s.t1 - s.t0
    own = [s.t1 - s.t0 - inner.get(s.index, 0.0)
           for s in spans if s.name == name]
    return 1e3 * sum(own) / len(own) if own else None


def nested_ms(run, name: str, parent: str):
    """Mean ms of the window's ``name`` spans opened inside a ``parent``
    span."""
    spans = in_window(run)
    if spans is None:
        return None
    parents = {s.index for s in spans if s.name == parent}
    d = [s.t1 - s.t0 for s in spans
         if s.name == name and s.parent in parents]
    return 1e3 * sum(d) / len(d) if d else None
