"""Deterministic synthetic data (``repro.data.synthetic`` counterpart).

Only the image generator of the Table III pipeline is ported so far; it is
a numpy copy of the reference's, so the same seed gives the same images
bit for bit.  The token and batch generators come with training.
"""
from __future__ import annotations

import numpy as np


def gray_images(seed: int, n: int, size: int = 128) -> np.ndarray:
    """Natural-ish grayscale test images for the image-processing benchmark
    (sums of oriented gratings + smooth blobs; they stand in for the
    paper's Lake/Mandril/Cameraman images), float32 in [0, 255]."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        img = np.zeros((size, size))
        for _ in range(6):
            fx, fy = rng.uniform(1, 12, 2)
            img += rng.uniform(0.2, 1.0) * np.sin(
                2 * np.pi * (fx * xx + fy * yy) + rng.uniform(0, 2 * np.pi))
        for _ in range(3):
            cx, cy, s = rng.uniform(0.2, 0.8, 2).tolist() + [rng.uniform(0.01, 0.08)]
            img += rng.uniform(0.5, 1.5) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / s)
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        out[i] = img * 255.0
    return out
