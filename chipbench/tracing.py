"""The traced run: ``torch.profiler`` over a span of the window, reduced to
device time.

The harness opens the span between two engine steps (each ends in a
device-to-host copy, so no work of an earlier step is in flight) and
marks it, and each runner call inside it, with ``record_function``
annotations named ``chipbench.*``.  Here the trace becomes:

- ``busy_s``: the union of every device operation's interval (kernels,
  copies, fills) inside the span, and ``window_s`` the span's length;
- device seconds by operation name and by name group (``k1`` for K1's
  ``afpm_matmul_kernel``);
- idle gaps (no device operation running) summed by what the host was
  doing when each began: the innermost ``chipbench.*`` annotation and
  the outermost ATen op under it.

Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import collections

import torch

__all__ = ["K1_KERNEL", "Profiler", "reduce_events"]

K1_KERNEL = "afpm_matmul_kernel"
SPAN = "chipbench.traced"


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped
    by the harness between engine steps."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self._span = None

    def start(self):
        self.prof.start()
        self._span = torch.profiler.record_function(SPAN)
        self._span.__enter__()

    def stop(self):
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> dict:
        return reduce_events(self.prof.events())


def _union(intervals):
    """Sorted disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _is_device(e) -> bool:
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return False
    return not (getattr(e, "is_user_annotation", False)
                or e.name.startswith("chipbench."))


def reduce_events(events) -> dict:
    span = None
    dev, host = [], []
    for e in events:
        if _is_device(e):
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            if e.name == SPAN:
                span = (e.time_range.start, e.time_range.end)
            host.append(e)
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN!r} annotation")
    t0, t1 = span
    by_name = collections.Counter()
    k1_n, k1_us = 0, 0.0
    ivals = []
    for s, e, name in dev:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        ivals.append((s, e))
        by_name[name] += e - s
        if K1_KERNEL in name:
            k1_n += 1
            k1_us += e - s
    busy = _union(ivals)
    busy_us = sum(e - s for s, e in busy)
    idle = _idle_by_host(busy, host, t0, t1)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in by_name.most_common(10)],
        "idle_gaps": [[n, us / 1e6] for n, us in idle.most_common(10)],
        "k1_kernels": k1_n,
        "k1_s": k1_us / 1e6,
    }


def _idle_by_host(busy, host, t0, t1) -> collections.Counter:
    """Idle microseconds of the span, summed by the host activity at each
    gap's start: ``<innermost chipbench.* annotation>`` and, after a
    ``/``, the outermost ATen op under it (if one was running)."""
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    marks = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in host if e.name.startswith("chipbench.")
                    and e.name != SPAN), key=lambda m: m[0])
    ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in host if e.name.startswith("aten::")
                  and e.cpu_parent is not None
                  and e.cpu_parent.name.startswith("chipbench.")),
                 key=lambda m: m[0])
    mark_starts = [m[0] for m in marks]
    op_starts = [o[0] for o in ops]
    out = collections.Counter()
    for gs, ge in gaps:
        label = "harness"
        i = bisect.bisect_right(mark_starts, gs) - 1
        # the innermost enclosing annotation: the latest-starting one that
        # is still open at the gap's start
        while i >= 0 and marks[i][1] < gs:
            i -= 1
        if i >= 0:
            label = marks[i][2][len("chipbench."):]
            j = bisect.bisect_right(op_starts, gs) - 1
            if j >= 0 and ops[j][1] >= gs and ops[j][0] >= marks[i][0]:
                label += "/" + ops[j][2]
        out[label] += ge - gs
    return out
