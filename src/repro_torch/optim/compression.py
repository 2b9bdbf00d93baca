"""int8 gradient compression with error feedback
(``repro.optim.compression`` counterpart): blockwise symmetric int8 with
one fp32 scale a block of :data:`BLOCK`; the residual (what compression
lost) is carried to the next step, which preserves convergence (EF-SGD).

    g_q, new_err = compress_with_feedback(g, err)
    # all-reduce g_q (1 byte an element on the wire), then apply it
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    flat = torch.nn.functional.pad(x.reshape(-1), (0, (-n) % BLOCK))
    return flat.reshape(-1, BLOCK), n


def quantize_int8(x: torch.Tensor):
    """Blockwise symmetric int8: ``(q int8, scale fp32 a block, n)``."""
    blocks, n = _pad_to_block(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, n


def dequantize_int8(q, scale, n: int, shape) -> torch.Tensor:
    x = q.to(torch.float32) * scale
    return x.reshape(-1)[:n].reshape(shape)


def compress_with_feedback(grad: torch.Tensor, err: torch.Tensor):
    """``(what the receiving side reconstructs, in grad's dtype; the new
    fp32 residual)``: applying the first locally keeps replicas
    bit-identical, and the residual accumulates what compression lost."""
    g = grad.to(torch.float32) + err
    q, scale, n = quantize_int8(g)
    g_hat = dequantize_int8(q, scale, n, grad.shape)
    return g_hat.to(grad.dtype), (g - g_hat).to(torch.float32)


def tree_compress_with_feedback(grads, errs):
    out = [compress_with_feedback(g, e) for g, e in
           zip(tree_util.leaves(grads), tree_util.leaves(errs))]
    return (tree_util.unflatten(grads, [o[0] for o in out]),
            tree_util.unflatten(grads, [o[1] for o in out]))


def init_error_feedback(params):
    return tree_util.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
