"""Arithmetic shared by the metric readers."""
from __future__ import annotations

import math

__all__ = ["percentile", "ttft_s", "gaps_s"]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100), linear between closest ranks (the
    ``(n - 1) * q / 100`` rank, as numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    k = (len(v) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def ttft_s(run) -> list:
    """First-token time of every request due in the window, from its due
    time; a request with no first token at the close counts at the time
    it has waited by then."""
    out = []
    for r in run.window_reqs:
        first = r.tokens[0] if r.tokens and r.tokens[0] <= run.t_close \
            else run.t_close
        out.append(first - r.due)
    return out


def gaps_s(run) -> list:
    """Every gap between consecutive tokens of a request whose later token
    lands in the window, and each gap still open at the close (a request
    with a first token and no finish by then), at its length so far."""
    out = []
    for r in run.reqs.values():
        ts = [t for t in r.tokens if t <= run.t_close]
        for a, b in zip(ts, ts[1:]):
            if b > run.t_open:
                out.append(b - a)
        done = not math.isnan(r.finish) and r.finish <= run.t_close
        if ts and not done:
            out.append(run.t_close - ts[-1])
    return out
