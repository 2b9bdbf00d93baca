"""The kernels as ``torch.library`` custom ops, with their fake kernels,
gradients and DTensor sharding rules.

Four ops, each the wrapper of one kernel entry:

- ``repro_torch::afpm_matmul``: K1, the segmented matmul
  (:func:`.afpm_matmul.afpm_matmul`);
- ``repro_torch::afpm_bitwise``: K2's elementwise product
  (:func:`.afpm_bitwise.afpm_bitwise`);
- ``repro_torch::afpm_emulated_matmul``: K2's emulated-matmul entry
  (:func:`.afpm_bitwise.emulated_matmul`);
- ``repro_torch::ssd_scan``: K3, the SSD chunked scan
  (:func:`.ssd_scan.ssd_scan`).

An op runs its wrapper unchanged: the kernel for CUDA tensors, the plain
version for CPU tensors (what lets CPU ranks hold each sharding rule's
numbers).  The entry points at the end take the op only where a call
needs it, a DTensor operand or a gradient; any other call (an unplaced
inference step) goes to the wrapper directly, as it would through the op,
and saves the op's dispatch on the host.  A launch shape (``tile``, ``block``, ``chunk``) travels as a
list of ints and an :class:`~repro_torch.core.afpm.AFPMConfig` as a
string (:func:`config_str`): an op takes no Python object.  The fake
kernels give the output's shape to meta tensors and DTensor's shape
inference; the gradients are :mod:`.autograd`'s (K2's elementwise product
has none, as the JAX package's bit-level function has none).

The sharding rules (``register_sharding``) say, per mesh dim, how a
DTensor call may be cut.  Each is the kernel's own arithmetic, run on
each rank's block:

- K1 and the emulated matmul, ``x (..., M, K) @ w (K, N)``: ``x`` sharded
  on a leading or M dim with ``w`` replicated gives the output sharded on
  that dim (a row depends on its row alone); ``x`` replicated with ``w``
  sharded on N gives the output sharded on N (a column on its column and
  the K chunks alone: the chunks of K are a function of K, whatever the
  tile); both sharded on K gives a ``Partial`` sum (the ranks' chunk sums
  added in another order: within 64 ulps of the largest output);
- K2's elementwise product: both operands in one placement, the output
  in it;
- K3: batch-sharded, or head-sharded (``x``, ``dt`` and ``A`` on H, ``B``
  and ``C`` replicated); never on L, which the scan walks in order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.core.afpm import AFPMConfig

from . import autograd
from .afpm_bitwise import afpm_bitwise as _afpm_bitwise
from .afpm_bitwise import emulated_matmul as _emulated_matmul
from .afpm_matmul import afpm_matmul
from .ssd_scan import ssd_scan as _ssd_scan

_CFG_FIELDS = ("n", "mode", "fmt", "skip_bd", "conditional", "compensation")


def config_str(cfg: AFPMConfig) -> str:
    """``cfg`` as the string an op takes (its fields in order)."""
    return ",".join(str(getattr(cfg, f)) for f in _CFG_FIELDS)


def config_of(s: str) -> AFPMConfig:
    """The :class:`AFPMConfig` of :func:`config_str`'s string."""
    n, mode, fmt, *flags = s.split(",")
    return AFPMConfig(int(n), mode, fmt, *(f == "True" for f in flags))


def _shape(t) -> Optional[tuple]:
    return None if t is None else tuple(t)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::afpm_matmul", mutates_args=())
def afpm_matmul_op(x: torch.Tensor, w: torch.Tensor, passes: int,
                   tile: Optional[list[int]] = None) -> torch.Tensor:
    return afpm_matmul(x, w, passes, _shape(tile))


@afpm_matmul_op.register_fake
def _(x, w, passes, tile=None):
    return x.new_empty((*x.shape[:-1], w.shape[1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::afpm_bitwise", mutates_args=())
def afpm_bitwise_op(x: torch.Tensor, y: torch.Tensor, cfg: str,
                    block: Optional[list[int]] = None) -> torch.Tensor:
    return _afpm_bitwise(x, y, config_of(cfg), _shape(block))


@afpm_bitwise_op.register_fake
def _(x, y, cfg, block=None):
    return x.new_empty(x.shape, dtype=torch.float32)


@torch.library.custom_op("repro_torch::afpm_emulated_matmul", mutates_args=())
def afpm_emulated_matmul_op(x: torch.Tensor, w: torch.Tensor, cfg: str,
                            k_chunk: int) -> torch.Tensor:
    return _emulated_matmul(x, w, config_of(cfg), k_chunk)


@afpm_emulated_matmul_op.register_fake
def _(x, w, cfg, k_chunk):
    return x.new_empty((*x.shape[:-1], w.shape[1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    return _ssd_scan(x, dt, A, B, C, chunk)


@ssd_scan_op.register_fake
def _(x, dt, A, B, C, chunk):
    return x.new_empty(x.shape, dtype=torch.float32)


# ---------------------------------------------------------------------------
# gradients (kernels/autograd.py)
# ---------------------------------------------------------------------------

def _save_operands(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:2])
    ctx.arg = inputs[2]


def _k1_backward(ctx, g):
    x, w = ctx.saved_tensors
    dx, dw = autograd.segmented_matmul_grads(x, w, ctx.arg, g,
                                             ctx.needs_input_grad[:2])
    return dx, dw, None, None


def _emulated_backward(ctx, g):
    x, w = ctx.saved_tensors
    dx, dw = autograd.emulated_matmul_grads(x, w, g, ctx.needs_input_grad[:2])
    return dx, dw, None, None


def _save_scan(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.chunk = inputs[5]


def _k3_backward(ctx, g):
    grads = autograd.ssd_grads(ctx.saved_tensors, ctx.chunk, g,
                               ctx.needs_input_grad[:5])
    return (*grads, None)


afpm_matmul_op.register_autograd(_k1_backward, setup_context=_save_operands)
afpm_emulated_matmul_op.register_autograd(_emulated_backward,
                                          setup_context=_save_operands)
ssd_scan_op.register_autograd(_k3_backward, setup_context=_save_scan)


# ---------------------------------------------------------------------------
# sharding rules (one mesh dim; DTensor expands them over the mesh)
# ---------------------------------------------------------------------------

def _matmul_rules(x, w, *rest):
    nd = x.ndim
    tail = [None] * len(rest)
    rules = [([Replicate()], [Replicate(), Replicate(), *tail])]
    rules += [([Shard(d)], [Shard(d), Replicate(), *tail])
              for d in range(nd - 1)]
    rules.append(([Shard(nd - 1)], [Replicate(), Shard(1), *tail]))
    rules.append(([Partial()], [Shard(nd - 1), Shard(0), *tail]))
    return rules


register_sharding(torch.ops.repro_torch.afpm_matmul.default)(_matmul_rules)
register_sharding(torch.ops.repro_torch.afpm_emulated_matmul.default)(
    _matmul_rules)


@register_sharding(torch.ops.repro_torch.afpm_bitwise.default)
def _bitwise_rules(x, y, cfg, block=None):
    rules = [([Replicate()], [Replicate(), Replicate(), None, None])]
    rules += [([Shard(d)], [Shard(d), Shard(d), None, None])
              for d in range(x.ndim)]
    return rules


@register_sharding(torch.ops.repro_torch.ssd_scan.default)
def _scan_rules(x, dt, A, B, C, chunk):
    R, b, h = Replicate(), Shard(0), Shard(2)
    return [([R], [R, R, R, R, R, None]),
            ([b], [b, b, R, b, b, None]),
            ([h], [h, h, Shard(0), R, R, None])]


# ---------------------------------------------------------------------------
# entry points (kernels/dispatch.py's kernel route)
# ---------------------------------------------------------------------------

def _through_op(*ts) -> bool:
    """Whether a call needs its op: an operand is a DTensor (whose rules
    the op carries), or autograd records the call (the op's backward).
    Any other call goes to the wrapper itself, as the op would run it,
    without the op's dispatch on the host."""
    return any(isinstance(t, DTensor) for t in ts) or (
        torch.is_grad_enabled() and any(t.requires_grad for t in ts))


def segmented_matmul(x, w, passes: int = 3, tile=None) -> torch.Tensor:
    """K1, through ``repro_torch::afpm_matmul`` where :func:`_through_op`
    says so, differentiable (``tile``: :func:`.afpm_matmul.plan`'s)."""
    if not _through_op(x, w):
        return afpm_matmul(x, w, passes, tile)
    return afpm_matmul_op(x, w, passes, None if tile is None else list(tile))


def bitwise(x, y, cfg: AFPMConfig, block=None) -> torch.Tensor:
    """K2's elementwise product, through ``repro_torch::afpm_bitwise``
    where an operand is a DTensor (it has no gradient)."""
    if not any(isinstance(t, DTensor) for t in (x, y)):
        return _afpm_bitwise(x, y, cfg, block)
    return afpm_bitwise_op(x, y, config_str(cfg),
                           None if block is None else list(block))


def emulated_matmul(x, w, cfg: AFPMConfig, k_chunk: int = 64) -> torch.Tensor:
    """K2's emulated matmul, through ``repro_torch::afpm_emulated_matmul``
    where :func:`_through_op` says so, differentiable."""
    if not _through_op(x, w):
        return _emulated_matmul(x, w, cfg, k_chunk)
    return afpm_emulated_matmul_op(x, w, config_str(cfg), k_chunk)


def ssd(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """K3, through ``repro_torch::ssd_scan`` where :func:`_through_op`
    says so, differentiable."""
    if not _through_op(x, dt, A, B, C):
        return _ssd_scan(x, dt, A, B, C, chunk)
    return ssd_scan_op(x, dt, A, B, C, chunk)
