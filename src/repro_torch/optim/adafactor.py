"""Adafactor (Shazeer & Stern 2018), ``repro.optim.adafactor`` counterpart:
second moments factored into row and column statistics for matrices whose
last two dims are both at least ``min_dim_factored``, no first moment.
``launch.steps.make_optimizer`` picks it for the giant configs.

The reference's formulas and order of operations; params and moments are
updated in place, leaf by leaf, under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import tree as tree_util

from .adamw import _contiguous, _f32, clip_by_global_norm_, schedule_lr


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    beta2: float = 0.999
    eps: float = 1e-30
    clip_threshold: float = 1.0      # update RMS clipping (Adafactor d)
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_dim_factored: int = 128      # factor only dims >= this


class FactoredMoment(NamedTuple):
    row: torch.Tensor    # mean of g^2 over the last axis
    col: torch.Tensor    # mean of g^2 over the second-to-last axis
    full: torch.Tensor   # when not factored (shape of param, else (0,))


class AdafactorState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the host
    v: dict              # tree of FactoredMoment


def _factored(p, cfg) -> bool:
    return (p.dim() >= 2 and p.shape[-1] >= cfg.min_dim_factored
            and p.shape[-2] >= cfg.min_dim_factored)


def init(params, cfg: AdafactorConfig) -> AdafactorState:
    def one(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if _factored(p, cfg):
            return FactoredMoment(row=z(p.shape[:-1]),
                                  col=z(p.shape[:-2] + p.shape[-1:]),
                                  full=z((0,)))
        return FactoredMoment(row=z((0,)), col=z((0,)), full=z(p.shape))

    return AdafactorState(step=torch.zeros((), dtype=torch.int32),
                          v=tree_util.map(one, params))


def _moments(state: AdafactorState) -> list:
    """One FactoredMoment a param leaf, in leaf order."""
    flat = tree_util.leaves(state.v)
    return [FactoredMoment(*flat[i:i + 3]) for i in range(0, len(flat), 3)]


@torch.no_grad()
def apply_updates(params, grads, state: AdafactorState, cfg: AdafactorConfig):
    """One Adafactor step, params and moments in place; returns ``(params,
    new state, {"grad_norm", "lr"})``."""
    grads = _contiguous(grads, params)
    gnorm = clip_by_global_norm_(grads, cfg.grad_clip)
    step = state.step + 1
    lr = float(schedule_lr(cfg, step))
    # increasing-decay beta2 hat (the paper's eq. 37-ish), in fp32
    beta2t = float(torch.clamp(1.0 - _f32(step) ** -0.8, max=cfg.beta2))
    f, eps = torch.float32, cfg.eps
    for p, g, v in zip(tree_util.leaves(params), tree_util.leaves(grads),
                       _moments(state)):
        g32 = g.to(f)
        g2 = g32 * g32 + eps
        if _factored(p, cfg):
            row = v.row.mul_(beta2t).add_((1 - beta2t) * g2.mean(dim=-1))
            col = v.col.mul_(beta2t).add_((1 - beta2t) * g2.mean(dim=-2))
            rmean = torch.clamp(row.mean(dim=-1, keepdim=True), min=eps)
            denom = torch.sqrt((row / rmean)[..., None] * col[..., None, :])
            u = g32 / torch.clamp(denom, min=eps)
        else:
            full = v.full.mul_(beta2t).add_((1 - beta2t) * g2)
            u = g32 / torch.sqrt(torch.clamp(full, min=eps))
        # update clipping: rms(u) <= clip_threshold
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p32 = p.to(f)
        p.copy_(p32 - lr * (u + cfg.weight_decay * p32))
    return params, AdafactorState(step, state.v), {"grad_norm": gnorm,
                                                   "lr": lr}
