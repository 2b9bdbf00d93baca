"""Gain-aware composed-error sensitivity model: one calibration pass.

The port's counterpart of ``repro.core.sensitivity``, with the same
constants (:data:`MAX_ROWS`, :data:`MAX_COLS`, :data:`PROBE_SEED`,
:data:`CHAIN_RTOL`, :data:`CHAIN_ATOL`) and the same model:

1. :func:`record_operands` installs the operand tap of
   :mod:`repro_torch.core.numerics`; one forward under the default-only
   calibration policy records, per ``nmatmul`` call site, a bounded
   sample of its operands (host numpy copies), the rms of its input and
   exact product, and a **gain coefficient**.  The port runs every layer
   eagerly, so every call site is seen (the reference has to unroll its
   scanned segments for the pass).
2. Per site, the **local error** of a candidate design is the recorded
   sample pushed through that design (on the device the site ran on, so
   a segmented candidate runs the Hopper kernel on the card), against
   the calibration default's own output (:meth:`SensitivityModel.
   local_rms_error`) or the float64 product (:meth:`SensitivityModel.
   local_error`, diagnostic).
3. The **gain coefficient** ``g_i`` is ``rms(J v) / rms(v)`` of the site's
   map ``t -> t @ w`` on a fixed-seed random tangent ``v`` (a
   ``torch.func.jvp`` probe, with a finite-difference fallback).
4. The **composed error** of an assignment::

       predict(assign) = baseline
                       + sum_i calls_i * tail * alpha_i * G_i * delta_rms_i
       alpha_i = out_rms_i / out_rms_head
       G_i     = prod_{j in downstream chain of i} g_j
       tail    = sqrt(2/pi) * mean(1/|y_head|) * rms(y_head)

   where a chain links site ``j`` to ``j-1`` when ``j``'s recorded input
   equals ``j-1``'s recorded output (``docs/sensitivity.md`` of the JAX
   package has the derivation and the model's assumptions).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .metrics import mred
from .numerics import EXACT, NumericsConfig, nmatmul, set_operand_tap
from .policy import NumericsPolicy
from .scope import numerics_scope

# bounded per-site operand sample: rows of x, columns of w (strided,
# deterministic, so calibration and its golden fixtures are reproducible)
MAX_ROWS = 64
MAX_COLS = 64

# the gain probe: a fixed-seed random tangent (deterministic, so the
# recorded coefficients are reproducible and golden-pinnable)
PROBE_SEED = 20260730
# chain detection: site j is "chained" to site j-1 when its recorded input
# sample equals site j-1's recorded exact output within this tolerance.
# The pass's actual output (under the calibration default, e.g. bf16
# operand rounding for the LM's exact-bf16 default) is compared with the
# tap's float64 product, so the tolerance swallows the default's own
# rounding; unrelated tensors differ at O(1) per element.
CHAIN_RTOL = 5e-2
CHAIN_ATOL = 2e-2  # x rms(prev output)


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One call site's recorded operand distribution + gain coefficient."""

    path: str
    x: np.ndarray          # (<=MAX_ROWS, K) float32 operand rows
    w: np.ndarray          # (K, <=MAX_COLS) float32 weight columns
    out_rms: float         # rms of the exact (float64) sample product
    order: int             # execution order of the site's first call
    calls: int = 1         # times the site was hit during the pass
    in_rms: float = 0.0    # rms of the recorded x sample
    gain: float = 1.0      # random-tangent rms gain of t -> t @ w (JVP probe)
    chained: bool = False  # input sample == previous site's output sample
    device: str = "cpu"    # where the site ran: candidates are measured there


def _strided(n: int, limit: int) -> np.ndarray:
    if n <= limit:
        return np.arange(n)
    return np.unique(np.linspace(0, n - 1, limit).astype(np.int64))


def _rms(a: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a * a))) if a.size else 0.0


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def probe_gain(x: np.ndarray, w: np.ndarray, method: str = "jvp") -> float:
    """Jacobian-norm estimate of the site's map on a random tangent.

    ``rms(J v) / rms(v)`` for a fixed-seed tangent ``v`` shaped like the
    recorded operand sample ``x``: by ``torch.func.jvp`` of ``t -> t @ w``
    at ``x`` (``method="jvp"``), or by the finite-difference output
    perturbation ``(f(x + eps*v) - f(x)) / eps`` in float64 (``"fd"``, the
    fallback when the JVP cannot be taken).  The map is linear in ``x``,
    so both agree to rounding; what matters is the *random* tangent.
    """
    v = np.random.default_rng(PROBE_SEED).standard_normal(
        x.shape).astype(np.float32)
    v_rms = _rms(v)
    if v_rms == 0.0:
        return 1.0
    if method == "jvp":
        wt = torch.from_numpy(np.ascontiguousarray(w))
        _, jv = torch.func.jvp(lambda t: torch.matmul(t, wt),
                               (torch.from_numpy(np.ascontiguousarray(x)),),
                               (torch.from_numpy(v),))
        jv = jv.numpy()
    elif method == "fd":
        eps = 1e-2
        x64, w64 = x.astype(np.float64), w.astype(np.float64)
        jv = ((x64 + eps * v.astype(np.float64)) @ w64 - x64 @ w64) / eps
    else:
        raise ValueError(f"unknown probe method {method!r}")
    return _rms(jv) / v_rms


def _site_gain(x: np.ndarray, w: np.ndarray) -> float:
    """JVP probe with the finite-difference fallback (see :func:`probe_gain`)."""
    try:
        g = probe_gain(x, w, method="jvp")
    except RuntimeError:  # the JVP cannot be taken for these operands
        g = probe_gain(x, w, method="fd")
    return g if np.isfinite(g) and g > 0.0 else 1.0


@contextlib.contextmanager
def record_operands(max_rows: int = MAX_ROWS, max_cols: int = MAX_COLS):
    """Context manager: install the nmatmul operand tap, yield the store.

    The store maps full layer path -> :class:`SiteRecord`.  Repeat calls
    to the same path keep the first sample and bump ``calls``.
    """
    store: Dict[str, SiteRecord] = {}
    order = [0]
    # chain probe: the previous site's exact sample product, the column
    # indices it was sampled at, and its FULL output width (the next
    # site's input is compared in the previous site's sampled column
    # space, so chains are detected even when the width exceeds max_cols)
    prev_probe = [None]  # (exact_sample, col_idx, full_out_cols)

    def tap(path, x, w):
        if getattr(w, "ndim", 0) != 2:
            return
        if path in store:
            r = store[path]
            store[path] = dataclasses.replace(r, calls=r.calls + 1)
            return
        x2 = x.reshape(-1, x.shape[-1])
        x2 = _host(x2[torch.as_tensor(_strided(x2.shape[0], max_rows),
                                      device=x2.device)])
        cols = _strided(w.shape[1], max_cols)
        full_out_cols = w.shape[1]
        w2 = _host(w[:, torch.as_tensor(cols, device=w.device)])
        exact = x2.astype(np.float64) @ w2.astype(np.float64)
        chained = False
        if prev_probe[0] is not None:
            p_exact, p_cols, p_full = prev_probe[0]
            if (x2.shape[0] == p_exact.shape[0]
                    and x2.shape[1] == p_full):
                x_sub = x2[:, p_cols]
                # atol scales with the signal: a fixed floor would let
                # unrelated quiet tensors (rms << 1) false-positive
                chained = bool(np.allclose(
                    x_sub, p_exact, rtol=CHAIN_RTOL,
                    atol=CHAIN_ATOL * _rms(p_exact)))
        store[path] = SiteRecord(
            path=path, x=x2, w=w2,
            out_rms=_rms(exact),
            order=order[0],
            in_rms=_rms(x2),
            gain=_site_gain(x2, w2),
            chained=chained,
            device=str(x.device))
        order[0] += 1
        prev_probe[0] = (exact, cols, full_out_cols)

    prev = set_operand_tap(tap)
    try:
        yield store
    finally:
        set_operand_tap(prev)


def propagation_coefficients(store: Mapping[str, SiteRecord]) -> Dict[str, float]:
    """Flat first-order alpha per site: ``out_rms / out_rms(last site)``.

    The last-executed site is the network head (``fc`` / ``lm_head``), so
    its coefficient is exactly 1; upstream sites scale by how loud their
    output is relative to the head's.  This is the *data-magnitude* term
    of the composition — the gain and tail terms (:class:`SensitivityModel`)
    multiply on top of it.
    """
    if not store:
        return {}
    last = max(store.values(), key=lambda r: r.order)
    net_rms = max(last.out_rms, 1e-30)
    return {p: r.out_rms / net_rms for p, r in store.items()}


def downstream_gains(store: Mapping[str, SiteRecord]) -> Dict[str, float]:
    """Per site, the product of gain coefficients along its downstream
    *chain*: starting from the next-executed site, multiply ``gain`` while
    each successive site is ``chained`` to its predecessor; the first
    unchained site ends the run (the perturbation rides the residual /
    branching stream from there, unit gain).  The head's own coefficient
    is 1."""
    ordered = sorted(store.values(), key=lambda r: r.order)
    out: Dict[str, float] = {}
    # suffix pass: G_i = gain_{i+1} * G_{i+1} while site i+1 is chained
    for i in range(len(ordered) - 1, -1, -1):
        if i + 1 < len(ordered) and ordered[i + 1].chained:
            out[ordered[i].path] = (ordered[i + 1].gain
                                    * out[ordered[i + 1].path])
        else:
            out[ordered[i].path] = 1.0
    return out


def mred_tail_factor(store: Mapping[str, SiteRecord]) -> float:
    """MRED-vs-rms conversion at the head: ``sqrt(2/pi) * mean(1/|y|) *
    rms(y)`` over the head site's recorded exact sample (zero elements
    masked, like :func:`repro_torch.core.metrics.mred`).

    For a centered error ``e`` independent of the output ``y``,
    ``E[|e|/|y|] = E[|e|] * E[1/|y|] = sqrt(2/pi) * rms(e) * E[1/|y|]`` —
    so predicted-MRED = tail * (rms-relative error).  Heavy small-``|y|``
    tails (logits near decision boundaries) push this well above 1; the
    flat model's implicit ``tail = 1`` was the dominant source of its ~2x
    composed-error under-prediction on deep stacks.
    """
    if not store:
        return 1.0
    last = max(store.values(), key=lambda r: r.order)
    y = (last.x.astype(np.float64) @ last.w.astype(np.float64)).ravel()
    y = y[y != 0.0]
    if y.size == 0:
        return 1.0
    return float(np.sqrt(2.0 / np.pi) * np.mean(1.0 / np.abs(y)) * _rms(y))


@dataclasses.dataclass
class SensitivityModel:
    """Per-site records + propagation/gain coefficients + error caches.

    ``alpha`` is the flat data-magnitude coefficient, ``gain`` the per-site
    downstream-chain gain product ``G_i``, ``tail`` the head's MRED
    conversion factor; :meth:`contribution` composes all three with the
    site's local rms error (see the module docstring for the formula and
    its assumptions).
    """

    sites: Dict[str, SiteRecord]
    alpha: Dict[str, float]
    baseline_error: float = 0.0    # eval_fn under the default-only policy
    gain: Dict[str, float] = dataclasses.field(default_factory=dict)
    tail: float = 1.0
    # the design local rms errors are measured against: the calibration
    # default (what eval_fn's reference ran), or None for the float64
    # exact product
    reference: Optional[NumericsConfig] = None

    def __post_init__(self):
        self._local: Dict[Tuple[str, NumericsConfig], float] = {}
        self._local_rms: Dict[Tuple[str, NumericsConfig], float] = {}
        self._ref: Dict[str, np.ndarray] = {}  # per-path reference output
        if not self.gain:
            self.gain = downstream_gains(self.sites)

    @classmethod
    def from_store(cls, store: Mapping[str, SiteRecord],
                   baseline_error: float = 0.0,
                   reference: Optional[NumericsConfig] = None,
                   ) -> "SensitivityModel":
        return cls(dict(store), propagation_coefficients(store),
                   baseline_error, downstream_gains(store),
                   mred_tail_factor(store), reference)

    def _approx(self, path: str, cfg: NumericsConfig) -> np.ndarray:
        r = self.sites[path]
        x = torch.from_numpy(r.x).to(r.device)
        w = torch.from_numpy(np.ascontiguousarray(r.w)).to(r.device)
        with numerics_scope(cfg):
            return nmatmul(x, w).cpu().numpy().astype(np.float64)

    def _reference(self, path: str) -> np.ndarray:
        if path not in self._ref:  # cached: one reference per path, not
            r = self.sites[path]   # one per (path, candidate) pair
            self._ref[path] = (
                r.x.astype(np.float64) @ r.w.astype(np.float64)
                if self.reference is None
                else self._approx(path, self.reference))
        return self._ref[path]

    def local_error(self, path: str, cfg: NumericsConfig) -> float:
        """MRED the design induces at ``path`` on its recorded operands,
        against the float64 exact product (the paper's per-multiplier
        metric; diagnostic, not what the composition propagates)."""
        key = (path, cfg)
        if key not in self._local:
            r = self.sites[path]
            exact = r.x.astype(np.float64) @ r.w.astype(np.float64)
            self._local[key] = mred(self._approx(path, cfg), exact)
        return self._local[key]

    def local_rms_error(self, path: str, cfg: NumericsConfig) -> float:
        """rms relative error the design induces at ``path`` on its
        recorded operands — ``rms(approx - ref) / rms(ref)`` where ``ref``
        is the calibration default's own output (:attr:`reference`; the
        float64 exact product when None).  This is the quantity linear
        maps transport, i.e. what :meth:`contribution` propagates."""
        key = (path, cfg)
        if key not in self._local_rms:
            ref = self._reference(path)
            err = self._approx(path, cfg) - ref
            self._local_rms[key] = _rms(err) / max(_rms(ref), 1e-30)
        return self._local_rms[key]

    def contribution(self, path: str, cfg: NumericsConfig) -> float:
        """Predicted network-output MRED contribution of one assignment:
        ``calls * tail * alpha * G * local_rms_error`` (gain-aware
        composition).  ``calls`` weights execution multiplicity: a path
        the pass ran several times injects the design's error once per
        run, and the linear composition counts every injection."""
        return (self.sites[path].calls * self.tail * self.alpha[path]
                * self.gain.get(path, 1.0)
                * self.local_rms_error(path, cfg))

    def predict(self, assignments: Mapping[str, NumericsConfig]) -> float:
        """Composed network error of a per-site assignment (first-order,
        linear over the assigned sites, on top of the baseline)."""
        return self.baseline_error + sum(
            self.contribution(p, c) for p, c in assignments.items()
            if p in self.sites)


def calibration_policy(default: Optional[NumericsConfig] = None) -> NumericsPolicy:
    """The default-only policy the calibration pass runs under."""
    return NumericsPolicy((), default=default or EXACT)


def calibrate(eval_fn, default: Optional[NumericsConfig] = None,
              max_rows: int = MAX_ROWS, max_cols: int = MAX_COLS) -> SensitivityModel:
    """One instrumented pass: run ``eval_fn`` under the default-only
    calibration policy with the operand tap installed; returns the fitted
    :class:`SensitivityModel` (``eval_fn`` is invoked exactly once)."""
    with record_operands(max_rows, max_cols) as store:
        base = float(eval_fn(calibration_policy(default)))
    return SensitivityModel.from_store(store, baseline_error=base,
                                       reference=default or EXACT)
