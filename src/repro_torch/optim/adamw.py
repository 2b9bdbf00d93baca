"""AdamW with dtype-configurable moments, global-norm clipping and
schedules (``repro.optim.adamw`` counterpart).

The formulas, their order of operations and the fp32 update math are the
reference's.  The port updates params and moments IN PLACE, leaf by leaf
and in pieces of :data:`PIECE` elements, under ``torch.no_grad()``: a
whole-tree update would hold tree-sized temporaries, which a full-width
qwen3-4b cannot afford beside its 64 GB of params, gradients and fp32
moments.  The update is elementwise, so the pieces change no bit of it
(the global norm is summed piece by piece, in another order than the
reference's).
The step counter and the learning rate live on the host.

Placed leaves (DTensors, ``distributed/sharding.place``) update the same
way on each rank's block: a gradient is laid out as its parameter first,
the global norm sums each leaf as a DTensor (every block, reduced over
the mesh), and the elementwise update runs on the local blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import tree as tree_util
from repro_torch.core.numerics import torch_dtype
from repro_torch.distributed import sharding

#: elements of one piece of a leaf in the in-place updates (128 MB fp32)
PIECE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    schedule: str = "cosine"      # constant | cosine | linear_warmup_cosine
    warmup_steps: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the host
    mu: dict
    nu: dict


def init(params, cfg: AdamWConfig) -> OptState:
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=tree_util.map(zeros, params),
                    nu=tree_util.map(zeros, params))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d fp32
    host tensor computed in fp32 as the reference does."""
    step = _f32(step)
    lr = _f32(cfg.lr)
    if cfg.schedule == "constant":
        return lr
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1)), max=1.0)
    if cfg.schedule in ("linear_warmup_cosine", "cosine"):
        prog = torch.clamp((step - cfg.warmup_steps)
                           / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
        return lr * warm * (0.1 + 0.9 * cos)
    raise ValueError(cfg.schedule)


def pieces(*ts):
    """Matching flat pieces of equally shaped contiguous tensors (of each
    rank's blocks, for DTensors laid out alike)."""
    flat = [sharding.local(t).view(-1) for t in ts]
    n = flat[0].numel()
    for i in range(0, n, PIECE):
        yield tuple(f[i:i + PIECE] for f in flat)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, fp32, on the leaves'
    device (no host sync)."""
    total = None
    for g in tree_util.leaves(grads):
        for gp in sharding.reduction_pieces(g, PIECE):
            gf = gp.to(torch.float32)
            s = torch.sum(gf * gf)
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_util.leaves(grads):
        g.mul_(scale.to(g.dtype))
    return norm


def _contiguous(grads, params):
    """Contiguous gradients, each DTensor laid out as its parameter."""
    return tree_util.unflatten(grads, [
        sharding.laid_out_as(g, p).contiguous() for g, p in zip(
            tree_util.leaves(grads), tree_util.leaves(params))])


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place (``grads`` are clipped in place); returns ``(params, new state,
    {"grad_norm", "lr"})`` with the same param tensors."""
    grads = _contiguous(grads, params)
    gnorm = clip_by_global_norm_(grads, cfg.grad_clip)
    step = state.step + 1
    lr = float(schedule_lr(cfg, step))
    b1, b2 = cfg.b1, cfg.b2
    t = _f32(step)
    bc1 = float(1 - _f32(b1) ** t)
    bc2 = float(1 - _f32(b2) ** t)
    f = torch.float32
    for p, g, m, v in zip(*(tree_util.leaves(x) for x in
                            (params, grads, state.mu, state.nu))):
        for pp, gp, mp, vp in pieces(p, g, m, v):
            # ``.to(f)`` of an fp32 piece is the piece itself: the math then
            # runs in place, and other dtypes copy back at the end
            g32 = gp.to(f)
            m32 = mp.to(f).mul_(b1).add_(g32 * (1 - b1))
            v32 = vp.to(f).mul_(b2).add_(g32 * (1 - b2) * g32)
            delta = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
            p32 = pp.to(f)
            delta.add_(p32 * cfg.weight_decay).mul_(lr)
            for dst, src in ((pp, p32.sub_(delta)), (mp, m32), (vp, v32)):
                if src is not dst:
                    dst.copy_(src)
    return params, OptState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
