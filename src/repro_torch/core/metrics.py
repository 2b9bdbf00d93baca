"""Error and quality metrics used by the paper (MRED, NMED, PSNR).

The port's counterpart of ``repro.core.metrics``.  The error metrics run
in numpy float64 on host copies (a tensor on the card is copied back
first), so they give the reference's numbers for the same outputs.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def mred(approx, exact) -> float:
    """Mean relative error distance: E[|a-e| / |e|], over nonzero exact values."""
    approx = _host(approx).ravel()
    exact = _host(exact).ravel()
    mask = np.isfinite(exact) & np.isfinite(approx) & (exact != 0)
    if not mask.any():
        return 0.0
    return float(np.mean(np.abs(approx[mask] - exact[mask]) / np.abs(exact[mask])))


def nmed(approx, exact) -> float:
    """Normalized mean error distance: E[|a-e|] / max|e|."""
    approx = _host(approx).ravel()
    exact = _host(exact).ravel()
    mask = np.isfinite(exact) & np.isfinite(approx)
    if not mask.any():
        return 0.0
    denom = np.max(np.abs(exact[mask]))
    if denom == 0:
        return 0.0
    return float(np.mean(np.abs(approx[mask] - exact[mask])) / denom)


def psnr(test, ref, peak: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB (paper Table III's metric)."""
    test = _host(test)
    ref = _host(ref)
    if peak is None:
        peak = float(np.max(np.abs(ref))) or 1.0
    mse = float(np.mean((test - ref) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def max_red(approx, exact) -> float:
    """Worst-case relative error distance (useful for error-bound tests)."""
    approx = _host(approx).ravel()
    exact = _host(exact).ravel()
    mask = np.isfinite(exact) & np.isfinite(approx) & (exact != 0)
    if not mask.any():
        return 0.0
    return float(np.max(np.abs(approx[mask] - exact[mask]) / np.abs(exact[mask])))


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> float:
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device)
    topk = torch.argsort(logits, dim=-1, stable=True)[..., -k:]
    hit = (topk == labels[..., None]).any(dim=-1)
    return float(hit.to(torch.float32).mean())
