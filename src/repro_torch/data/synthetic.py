"""Deterministic synthetic data (``repro.data.synthetic`` counterpart).

Every generator is a numpy copy of the reference's and a pure function of
(seed, step, shard), so the same arguments give the same batch bit for bit
in either package, and a restarted run needs no data-loader state beyond
its step: the training token stream (:func:`lm_batch`) and the images of
Tables III and IV (:func:`gray_images`, :func:`cifar_like`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    kind: str = "lm"  # lm | markov | images


def _keys(seed, step, shard):
    return np.random.default_rng(np.uint64(seed) * 1_000_003
                                 + np.uint64(step) * 97 + np.uint64(shard))


def lm_batch(cfg: DataConfig, step: int, shard: int = 0, nshards: int = 1):
    """Degree-2 Markov token stream, ``next = (31 prev + 7 prev2 + noise)
    mod vocab`` with noise in [0, 17): learnable structure (the loss
    drops), unlike uniform noise.  Returns host numpy arrays ``{"tokens",
    "targets": (global_batch // nshards, seq_len) int32}``."""
    rng = _keys(cfg.seed, step, shard)
    b = cfg.global_batch // nshards
    S = cfg.seq_len
    toks = np.empty((b, S + 1), np.int64)
    toks[:, 0] = rng.integers(0, cfg.vocab, b)
    toks[:, 1] = rng.integers(0, cfg.vocab, b)
    noise = rng.integers(0, 17, (b, S + 1))
    for t in range(2, S + 1):
        toks[:, t] = (31 * toks[:, t - 1] + 7 * toks[:, t - 2]
                      + noise[:, t]) % cfg.vocab
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def cifar_like(cfg: DataConfig, step: int, n: int = None, classes: int = 10):
    """Synthetic 32x32 NHWC images with class-dependent structure
    (frequency + colour statistics per class), normalised; deterministic in
    (seed, step).  Returns ``{"images": (n, 32, 32, 3) float32, "labels":
    (n,) int32}``."""
    rng = _keys(cfg.seed, step, 0)
    n = n or cfg.global_batch
    labels = rng.integers(0, classes, n)
    xx, yy = np.meshgrid(np.arange(32), np.arange(32))
    images = np.empty((n, 32, 32, 3), np.float32)
    for i in range(n):
        c = labels[i]
        fx, fy = 1 + (c % 5), 1 + (c // 5) * 2
        phase = rng.uniform(0, 2 * np.pi)
        base = np.sin(2 * np.pi * (fx * xx + fy * yy) / 32 + phase)
        color = np.array([np.cos(c), np.sin(2 * c), np.cos(3 * c)]) * 0.5
        img = base[..., None] * (0.5 + color) + rng.normal(0, 0.35, (32, 32, 3))
        images[i] = img
    mean, std = images.mean(), images.std() + 1e-6
    return {"images": ((images - mean) / std).astype(np.float32),
            "labels": labels.astype(np.int32)}


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
