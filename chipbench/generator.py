"""The one traffic generator: a mix file of parameters -> the run's requests.

A mix fixes the SET of sizes and arrival gaps; ``--seed`` draws the token
ids and the ORDER in which sizes, tiers and gaps are dealt out, a plain
seeded permutation of each.  Two seeds therefore offer the same work at
the same rate, and runs of different seeds differ in arrangement only:
where a seed's order bunches short gaps or long prompts, the run sees the
burst.

Lengths are stratified quantiles of a clipped lognormal: ``n`` requests
take the quantiles ``(i + 0.5) / n`` of ``lognormal(ln(median), sigma)``,
rounded and clipped to ``[min, max]``.  Poisson gaps are the quantiles of
the exponential of mean ``1 / rate`` in the same way.  Tiers are dealt by
largest remainder of ``n * share``.

Arrival kinds:

``poisson``  open loop at ``rate_rps``: the load-in (``load_in_s``, before
             the window opens) and the window (``seconds``) each get their
             own set, ``round(rate * span)`` requests whose gaps are scaled
             to fill the span exactly, so every seed's window is offered
             the same work.
``backlog``  ``per_tier`` requests of every tier, all due when the
             traffic starts: every lane's queue outlasts the window.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Request", "generate", "length_set", "rng_for"]


@dataclasses.dataclass
class Request:
    rid: str
    tier: str
    due: float          # seconds after the traffic starts
    prompt: np.ndarray  # int32 token ids
    max_new: int


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of a seed: any whole number up to
    2**63 - 1 (seeds past 2**31 included) maps to its own stream."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [ord(c) for c in stream]
    return np.random.default_rng(np.random.SeedSequence(words))


def _lognormal_quantile(q: np.ndarray, median: float, sigma: float):
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
    return median * np.exp(sigma * z)


def length_set(spec: dict, n: int) -> np.ndarray:
    """The mix's ``n`` lengths, sorted: stratified quantiles of the clipped
    lognormal."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    q = (np.arange(n) + 0.5) / n
    v = np.rint(_lognormal_quantile(q, spec["median"], spec["sigma"]))
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def _deal_tiers(shares: dict, n: int) -> list:
    names = list(shares)
    raw = np.array([shares[t] * n for t in names], float)
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return [t for t, c in zip(names, counts) for _ in range(c)]


def deal(items, rng) -> list:
    """``items`` in a seeded order: a plain permutation."""
    return [items[i] for i in rng.permutation(len(items))]


def _poisson_dues(n: int, span: float, rng) -> np.ndarray:
    """``n`` arrival times over ``span`` seconds: gaps the exponential's
    stratified quantiles, dealt in a seeded order and scaled to end at
    ``span``."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)                     # unit-rate exponential
    dues = np.cumsum(deal(list(gaps), rng))
    return dues * (span / dues[-1])


def _set(mix: dict, n: int, rng) -> tuple:
    """One set's tiers, prompt and output lengths, each dealt in order."""
    tiers = deal(_deal_tiers(mix["tiers"], n), rng)
    plen = deal(list(length_set(mix["prompt_tokens"], n)), rng)
    olen = deal(list(length_set(mix["output_tokens"], n)), rng)
    return tiers, plen, olen


def generate(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    """The run's requests in due order."""
    arr = mix["arrival"]
    rng = rng_for(seed, "order")
    if arr["kind"] == "poisson":
        dues, tiers, plen, olen = [], [], [], []
        t0 = 0.0
        for span in (float(arr.get("load_in_s", 0.0)), float(seconds)):
            n = int(round(float(arr["rate_rps"]) * span))
            if n == 0:
                continue
            d = _poisson_dues(n, span, rng)
            dues.extend(t0 + d)
            t, p, o = _set(mix, n, rng)
            tiers += t
            plen += p
            olen += o
            t0 += span
        n = len(dues)
        dues = np.array(dues)
    elif arr["kind"] == "backlog":
        names = list(mix["tiers"])
        n = int(arr["per_tier"]) * len(names)
        dues = np.zeros(n)
        tiers = [names[i % len(names)] for i in range(n)]
        plen = length_set(mix["prompt_tokens"], n)[rng.permutation(n)]
        olen = length_set(mix["output_tokens"], n)[rng.permutation(n)]
    else:
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    tok = rng_for(seed, "tokens")
    out = []
    for i in range(n):
        prompt = tok.integers(0, vocab, int(plen[i]), dtype=np.int64)
        out.append(Request(rid=f"q{i}", tier=tiers[i], due=float(dues[i]),
                           prompt=prompt.astype(np.int32),
                           max_new=int(olen[i])))
    out.sort(key=lambda r: (r.due, int(r.rid[1:])))
    return out
