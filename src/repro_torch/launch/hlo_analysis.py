"""Modeled cost of serving under a per-layer numerics policy.

The port's counterpart of two functions of ``repro.launch.hlo_analysis``
(:func:`policy_compute_scale`, :func:`policy_ppa_summary`): pure
arithmetic over a policy and its call sites, what
``Session.ppa_report`` returns.  The rest of the reference module reads
XLA's cost analysis and has no counterpart yet.
"""
from __future__ import annotations

# Passes of the exact split-float product (paper Eq. 6: the full 6-term
# hi/lo expansion); segmented seg_passes=k keeps k of them, so a site's
# modeled compute time scales by k/6 against exact.
EXACT_PASSES = 6


def policy_compute_scale(policy, layer_paths, counts=None) -> float:
    """Modeled pass scale of a policy against the all-exact baseline.

    Per site: exact -> 1.0; ``segmented`` -> ``seg_passes / 6`` (term
    skipping drops whole passes, the paper's latency lever on the
    multiplier datapath); ``emulated`` -> 1.0 (the bit-level emulation
    models accuracy, not a faster datapath).  Returns the mean over
    ``layer_paths``, weighted by ``counts`` multiplicity where given.
    """
    counts = counts or {}
    num = den = 0.0
    for p in layer_paths:
        cfg = policy.lookup(p)
        k = counts.get(p, 1)
        scale = (cfg.seg_passes / EXACT_PASSES
                 if cfg.mode == "segmented" else 1.0)
        num += scale * k
        den += k
    return num / max(den, 1.0)


def policy_ppa_summary(policy, layer_paths, counts=None) -> dict:
    """Modeled area / power / compute scale of a per-layer policy: the
    Table II roll-up (:func:`repro_torch.core.sweep.policy_ppa`, one
    multiplier instance per call-site path) with the pass scale and the
    reductions against the all-exact baseline."""
    from repro_torch.core import sweep

    out = dict(sweep.policy_ppa(policy, layer_paths, counts))
    out["compute_scale"] = policy_compute_scale(policy, layer_paths, counts)
    out["area_reduction"] = 1.0 - out["area_um2"] / max(
        out["baseline_area_um2"], 1e-30)
    out["power_reduction"] = 1.0 - out["power_w"] / max(
        out["baseline_power_w"], 1e-30)
    return out
