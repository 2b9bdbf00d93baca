"""Design-space exploration: the accuracy-PPA sweep and per-layer
auto-configuration.

The port's counterpart of ``repro.core.sweep``.  :func:`sweep` gives the
Pareto frontier over the registered designs (MRED on a uniform operand
distribution against area and power from :mod:`repro_torch.core.ppa`);
:func:`recommend` picks the cheapest design within an error budget.

:func:`auto_configure` assigns each layer of a network the cheapest
design (by the same PPA model) whose composed network error stays within
a budget, and emits a :class:`~repro_torch.core.policy.NumericsPolicy`:

``method="proxy"`` (default)
    One instrumented calibration pass fits the composed-error model of
    :mod:`repro_torch.core.sensitivity`; the assignment is a
    knapsack-style exchange over the modeled per-site contributions,
    with exactly **one** ``eval_fn`` call.
``method="greedy"``
    Probe each layer, then re-evaluate the whole network per candidate
    assignment: measured, not modeled, error at O(layers x designs)
    full-network evaluations.
"""
from __future__ import annotations

import dataclasses
import heapq
import re
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

from . import ppa
from .metrics import mred
from .numerics import NumericsConfig
from .policy import NumericsPolicy
from .registry import get_elementwise

SWEEPABLE = {
    # name -> (ppa kind, ppa kwargs)
    "AC3-3": ("ac", {"n": 3}), "AC4-4": ("ac", {"n": 4}),
    "AC5-5": ("ac", {"n": 5}), "AC6-6": ("ac", {"n": 6}),
    "AC7-7": ("ac", {"n": 7}),
    "ACL4": ("acl", {"n": 4}), "ACL5": ("acl", {"n": 5}),
    "ACL6": ("acl", {"n": 6}),
    "MMBS5": ("mmbs", {"k": 5}), "MMBS6": ("mmbs", {"k": 6}),
    "MMBS7": ("mmbs", {"k": 7}),
    "CSS12": ("css", {"m": 12}), "CSS14": ("css", {"m": 14}),
    "CSS16": ("css", {"m": 16}), "CSS18": ("css", {"m": 18}),
    "NC": ("log", {"comp": "nc"}), "LPC": ("log", {"comp": "lpc"}),
    "HPC": ("log", {"comp": "hpc"}),
}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    name: str
    mred: float
    area_um2: float
    power_w: float
    pareto: bool = False


def sweep(x=None, y=None, seed: int = 0, n_samples: int = 50_000,
          device=None):
    """Evaluate every design; returns SweepPoints with Pareto flags.

    The products run on ``device`` (``cuda`` unless ``"cpu"``) through
    :func:`~repro_torch.core.registry.get_elementwise` (on the card the
    AFPM designs take the bit-level kernel; the bits are the same)."""
    device = resolve_device(device)
    if x is None:
        rng = np.random.default_rng(seed)
        x = rng.uniform(-4, 4, n_samples).astype(np.float32)
        y = rng.uniform(-4, 4, n_samples).astype(np.float32)
    exact = np.asarray(x, np.float64) * np.asarray(y, np.float64)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=device)
    points = []
    for name, (kind, kw) in SWEEPABLE.items():
        approx = get_elementwise(name)(xt, yt).cpu().numpy()
        est = ppa.estimate(kind, name=name, **kw)
        points.append(SweepPoint(name, mred(approx, exact),
                                 est.logic_area_um2, est.power_w))
    # Pareto: no other point has both lower error and lower area
    out = []
    for p in points:
        dominated = any(q.mred <= p.mred and q.area_um2 < p.area_um2
                        for q in points if q is not p)
        out.append(dataclasses.replace(p, pareto=not dominated))
    return sorted(out, key=lambda p: p.mred)


def recommend(error_budget: float, metric: str = "area_um2", **kw) -> SweepPoint:
    """Cheapest design meeting the MRED budget (the compiler's selection)."""
    candidates = [p for p in sweep(**kw) if p.mred <= error_budget]
    if not candidates:
        raise ValueError(f"no design meets MRED <= {error_budget}")
    return min(candidates, key=lambda p: getattr(p, metric))


# ---------------------------------------------------------------------------
# per-layer auto-configuration (network-level budget -> NumericsPolicy)
# ---------------------------------------------------------------------------

def config_ppa(cfg: NumericsConfig) -> ppa.PPAEstimate:
    """PPA estimate of the multiplier a NumericsConfig instantiates.

    ``segmented`` mode (the split-float matmul) is modeled by its
    hardware counterpart: 1 pass ≈ ACL-n (single high-segment product),
    2-3 passes ≈ AC-n-n (conditional multi-pass) — a proxy, but the same
    one the paper's Table II rows describe.
    """
    if cfg.mode == "exact":
        return ppa.estimate("exact", name="Exact")
    if cfg.mode == "emulated":
        spec = SWEEPABLE.get(cfg.multiplier) or SWEEPABLE.get(cfg.multiplier.upper())
        if spec is None:  # AFPM family outside the sweep table (e.g. AC-fp16)
            low = cfg.multiplier.lower()
            kind = "acl" if low.startswith("acl") else "ac"
            return ppa.estimate(kind, name=cfg.multiplier, n=cfg.seg_n)
        kind, kw = spec
        return ppa.estimate(kind, name=cfg.multiplier, **kw)
    if cfg.mode == "segmented":
        kind = "acl" if cfg.seg_passes == 1 else "ac"
        return ppa.estimate(kind, name=f"segmented-{cfg.seg_passes}", n=cfg.seg_n)
    raise ValueError(f"unknown numerics mode {cfg.mode!r}")


def policy_area(policy: NumericsPolicy, layer_paths: Sequence[str],
                counts: Optional[Mapping[str, int]] = None) -> float:
    """Modeled logic area (um^2) of one multiplier instance per layer path.

    ``counts`` weights paths by instance multiplicity (e.g. a path standing
    for all experts of a MoE layer); per-expert path enumerations
    (``repro_torch.core.policy.expert_paths``) carry
    multiplicity in the path list itself and need no counts.
    """
    counts = counts or {}
    return sum(config_ppa(policy.lookup(p)).logic_area_um2 * counts.get(p, 1)
               for p in layer_paths)


def policy_ppa(policy: NumericsPolicy, layer_paths: Sequence[str],
               counts: Optional[Mapping[str, int]] = None) -> dict:
    """Table II roll-up of a policy over a network's call sites: total
    modeled logic area and power, one multiplier instance per path (scaled
    by ``counts`` multiplicity), plus the all-exact baseline for deltas."""
    counts = counts or {}
    area = power = 0.0
    for p in layer_paths:
        est = config_ppa(policy.lookup(p))
        k = counts.get(p, 1)
        area += est.logic_area_um2 * k
        power += est.power_w * k
    n = sum(counts.get(p, 1) for p in layer_paths)
    exact = ppa.estimate("exact", name="Exact")
    return {
        "area_um2": area,
        "power_w": power,
        "baseline_area_um2": exact.logic_area_um2 * n,
        "baseline_power_w": exact.power_w * n,
        "n_sites": n,
    }


def _emulated_config(name: str) -> NumericsConfig:
    m = re.match(r"ACL?(\d)", name)
    return NumericsConfig(mode="emulated", multiplier=name,
                          seg_n=int(m.group(1)) if m else 5)


def pareto_candidates(**kw) -> list:
    """(name, NumericsConfig) per Pareto-frontier design — the default
    per-layer candidate set for :func:`auto_configure`.  ``kw`` goes to
    :func:`sweep` (``device`` included)."""
    return [(p.name, _emulated_config(p.name)) for p in sweep(**kw) if p.pareto]


@dataclasses.dataclass(frozen=True)
class AutoConfigResult:
    policy: NumericsPolicy                    # serializable (policy.to_json())
    error: float                              # network error: measured (greedy)
    #                                           or composed-model (proxy)
    area_um2: float                           # modeled logic area, all layers
    baseline_area_um2: float                  # all layers on the default design
    assignments: Tuple[Tuple[str, str], ...]  # (layer path, design name)
    n_evals: int                              # eval_fn invocations spent
    method: str = "greedy"
    predicted_error: Optional[float] = None   # proxy only: == error

    @property
    def area_reduction(self) -> float:
        return 1.0 - self.area_um2 / self.baseline_area_um2


def auto_configure(eval_fn: Callable[[NumericsPolicy], float],
                   layer_paths: Sequence[str],
                   error_budget: float,
                   candidates: Optional[Sequence[Tuple[str, NumericsConfig]]] = None,
                   default: Optional[NumericsConfig] = None,
                   verbose: bool = False,
                   method: str = "proxy",
                   device=None) -> AutoConfigResult:
    """Per-layer design selection under a network error budget.

    ``eval_fn(policy)`` runs the network on a calibration batch under
    ``policy`` and returns its error versus the exact baseline (e.g. MRED
    of the logits — any monotone scalar works).  ``layer_paths`` names the
    layers to configure (e.g. ``repro_torch.models.resnet.layer_paths(cfg)``
    or ``repro_torch.models.transformer.layer_paths(cfg)``); ``candidates`` is a
    ``(name, NumericsConfig)`` list (default: the emulated Pareto-frontier
    designs from :func:`pareto_candidates`, swept on ``device``, ``cuda``
    unless ``"cpu"``); ``default`` is the config of unassigned layers
    (default exact fp32).

    ``method="proxy"`` (default) spends exactly one ``eval_fn`` call: the
    instrumented calibration pass of ``repro_torch.core.sensitivity`` records
    per-site operand distributions, propagation coefficients and gain
    coefficients (the gain-aware composed-error model), then a
    knapsack-style exchange assigns each site the cheapest design whose
    composed (modeled) error stays within budget; ``eval_fn`` must route
    its matmuls through ``nmatmul`` under the policy it is given, so the
    operand tap sees them.  ``method="greedy"`` keeps the
    original measured-error schedule: ``O(L)`` probe evals plus up to
    ``O(L * C)`` assignment evals, each a full-network run.
    """
    if method not in ("proxy", "greedy"):
        raise ValueError(f"unknown method {method!r}; expected 'proxy' or 'greedy'")
    default = default or NumericsConfig(mode="exact", compute_dtype="float32")
    cand = (list(candidates) if candidates is not None
            else pareto_candidates(device=device))
    cand.sort(key=lambda nc: config_ppa(nc[1]).logic_area_um2)
    exact_area = config_ppa(default).logic_area_um2
    cand = [(n, c) for n, c in cand
            if config_ppa(c).logic_area_um2 < exact_area]
    if not cand:
        raise ValueError("no candidate is cheaper than the default design")
    if method == "proxy":
        return _proxy_configure(eval_fn, layer_paths, error_budget, cand,
                                default, exact_area, verbose)
    n_evals = 0

    def evaluate(assign) -> float:
        nonlocal n_evals
        n_evals += 1
        return float(eval_fn(NumericsPolicy.from_assignments(
            {p: c for p, (_, c) in assign.items()}, default=default)))

    sens = {p: evaluate({p: cand[0]}) for p in layer_paths}
    assign: dict = {}
    err = evaluate(assign)  # default-only policy (0 when default == baseline)
    for p in sorted(layer_paths, key=lambda q: sens[q]):
        for name, c in cand:
            trial = dict(assign)
            trial[p] = (name, c)
            e = evaluate(trial)
            if e <= error_budget:
                assign, err = trial, e
                if verbose:
                    print(f"[auto_configure] {p:16s} -> {name:7s} "
                          f"err={e:.3e} (budget {error_budget:.3e})")
                break
        else:
            if verbose:
                print(f"[auto_configure] {p:16s} -> default (no candidate fits)")

    policy = NumericsPolicy.from_assignments(
        {p: c for p, (_, c) in assign.items()}, default=default)
    return AutoConfigResult(
        policy=policy,
        error=err,
        area_um2=policy_area(policy, layer_paths),
        baseline_area_um2=exact_area * len(layer_paths),
        assignments=tuple((p, assign[p][0]) for p in layer_paths if p in assign),
        n_evals=n_evals,
        method="greedy",
    )


def _proxy_configure(eval_fn, layer_paths, error_budget, cand, default,
                     exact_area, verbose) -> AutoConfigResult:
    """Knapsack-style assignment over the composed-error model.

    Start every recorded site on its cheapest candidate; while the composed
    prediction exceeds budget, take the exchange (site -> lower-error
    option, the default included as the zero-error anchor) with the best
    error-reduction-per-area ratio.  Terminates within budget because the
    all-default assignment contributes zero composed error.

    Site areas are weighted by the execution multiplicity the calibration
    pass observed (``SiteRecord.calls``): a path the pass ran several
    times stands for as many multiplier instances, and its contribution
    is already ``calls``-weighted, so both sides of the error-per-area
    exchange ratio (and the reported area roll-up) count the same
    instances.
    """
    from . import sensitivity as sens_mod  # deferred: keeps sweep importable alone

    model = sens_mod.calibrate(eval_fn, default=default)
    areas = [(name, c, config_ppa(c).logic_area_um2) for name, c in cand]
    # physical multiplier instances per path (1 unless the pass executed
    # the site multiple times)
    mult = {p: (model.sites[p].calls if p in model.sites else 1)
            for p in layer_paths}

    opts = {}       # path -> [(name or None, cfg, area, contribution)]
    for p in layer_paths:
        if p not in model.sites:
            continue  # never executed on the calibration batch: stays default
        o = [(name, c, a * mult[p], model.contribution(p, c))
             for name, c, a in areas]
        o.append((None, default, exact_area * mult[p], 0.0))
        opts[p] = o
    if layer_paths and not opts:
        raise ValueError(
            "proxy calibration recorded no operand samples for any of the "
            f"{len(layer_paths)} layer paths — eval_fn must route its "
            "matmuls through nmatmul under the policy it is given, at these "
            "paths; use method='greedy' otherwise")
    choice = {p: min(range(len(o)), key=lambda i: o[i][2])
              for p, o in opts.items()}
    total = model.baseline_error + sum(
        opts[p][i][3] for p, i in choice.items())

    # best exchange per site, served from a max-heap with lazy (versioned)
    # invalidation: O((L*C) log(L*C)) overall instead of rescanning every
    # (site, option) pair per exchange — L is tens of thousands of sites on
    # the per-expert LM-zoo enumerations this method exists for.  The
    # globally best exchange is always some site's best exchange, so the
    # schedule is identical to the full rescan.
    def best_move(p):
        cur = opts[p][choice[p]]
        best = None
        for j, alt in enumerate(opts[p]):
            gain = cur[3] - alt[3]
            if gain <= 0.0:
                continue
            score = gain / max(alt[2] - cur[2], 1e-9)
            if best is None or score > best[0]:
                best = (score, gain, j)
        return best

    version = dict.fromkeys(opts, 0)
    heap = []
    for p in opts:
        bm = best_move(p)
        if bm is not None:
            heapq.heappush(heap, (-bm[0], version[p], p, bm[2], bm[1]))
    while total > error_budget and heap:
        _, ver, p, j, gain = heapq.heappop(heap)
        if ver != version[p]:
            continue  # stale: this site was exchanged since the push
        choice[p] = j
        total -= gain
        version[p] += 1
        bm = best_move(p)
        if bm is not None:
            heapq.heappush(heap, (-bm[0], version[p], p, bm[2], bm[1]))

    assign = {p: opts[p][i] for p, i in choice.items()
              if opts[p][i][0] is not None}
    if verbose:
        for p in layer_paths:
            if p in assign:
                name, _, _, contrib = assign[p]
                print(f"[auto_configure/proxy] {p:24s} -> {name:12s} "
                      f"alpha={model.alpha[p]:.3f} "
                      f"G={model.gain.get(p, 1.0):.3f} "
                      f"contrib={contrib:.3e}")
            elif p in opts:
                print(f"[auto_configure/proxy] {p:24s} -> default")
        print(f"[auto_configure/proxy] composed error {total:.3e} "
              f"(budget {error_budget:.3e}, baseline "
              f"{model.baseline_error:.3e}, tail x{model.tail:.2f})")
    policy = NumericsPolicy.from_assignments(
        {p: c for p, (_, c, _, _) in assign.items()}, default=default)
    return AutoConfigResult(
        policy=policy,
        error=total,
        area_um2=policy_area(policy, layer_paths, counts=mult),
        baseline_area_um2=exact_area * sum(mult[p] for p in layer_paths),
        assignments=tuple((p, assign[p][0]) for p in layer_paths if p in assign),
        n_evals=1,
        method="proxy",
        predicted_error=total,
    )
