"""Shared building blocks: init helpers, norms, embeddings, RoPE, MLPs.

Parameters are plain nested dicts of tensors with the JAX package's
layout (``wq`` is ``(d, H * hd)``; stacked layers carry a leading
``repeats`` axis), so the two packages can exchange weights directly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scope import fp64_sums, fp64_sums_on  # noqa: F401
from repro_torch.distributed.sharding import logical_constraint, reduced
from repro_torch.numerics import layer_scope, nmatmul


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and cast back to fp32: operands for an fp32
    matmul whose products are exact, i.e. a bf16 dot accumulated in fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def einsum_f64(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in fp64; the result stays fp64 for the caller to
    round once, where it casts anyway.

    The library picks a sum order by shape: on the card a row's fp32 dot
    changes with the batch it sits in (cuBLAS chooses its kernels by the
    batch count), which in a bf16 model moves roundings far downstream.
    Summed in fp64 the orders agree to fp64 rounding, so a row rounds to
    the same fp32 or bf16 value at any batch unless its sum lies within a
    few fp64 ulps of a rounding boundary.  For bf16-rounded operands the
    products are exact: this is the reference's bf16 dot, summed more
    precisely.  Pass bf16 operands as they are: widened straight to fp64
    they make no fp32 copy.  A placed contraction over a sharded dim is
    reduced in fp64, before any caller rounds it."""
    return reduced(torch.einsum(eq, *(t.to(torch.float64) for t in operands)))


def normal(gen: torch.Generator, shape, scale: float,
           device) -> torch.Tensor:
    # scaled in place: a full-width expert stack (15 GB) is drawn once,
    # with no second buffer for the product
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, or under :func:`fp64_sums` in fp64 and rounded
    once to ``x``'s dtype: a reduction's order changes with the number of
    rows on the card (see :func:`einsum_f64`), and in fp64 a row's result
    does not depend on the batch it is served in, at no launch more."""
    dt = x.dtype
    ct = torch.float64 if fp64_sums_on() else torch.float32
    xf = x.to(ct)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(ct))).to(dt)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


# ---------------------------------------------------------------------------
# RoPE (rotates split halves, not interleaved pairs; M-RoPE sections)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, sections=None) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S), or (..., S, 3) with M-RoPE
    ``sections`` ``(t, h, w)``: the ``D/2`` frequency bands split into
    three runs, each driven by its own position stream (qwen2-vl; text
    gives the three streams equal positions, which is plain RoPE)."""
    D = x.shape[-1]
    half = D // 2
    freqs = rope_freqs(D, theta, x.device)
    if sections is None:
        ang = positions[..., :, None, None].to(torch.float32) * freqs
    else:
        st, sh, sw = sections
        if st + sh + sw != half:
            raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum "
                             f"to head_dim/2 = {half}")
        # which position stream drives each band
        sec = torch.tensor([0] * st + [1] * sh + [2] * sw, device=x.device)
        pos = positions.to(torch.float32)[..., sec]       # (..., S, half)
        ang = pos[..., :, None, :] * freqs
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP ``wo(wi(x) * silu(wg(x)))`` under the ambient numerics
    scope (relative call-site paths ``wi``/``wg``/``wo``)."""
    hidden_axes = ("batch",) + (None,) * (x.dim() - 2) + ("mlp",)
    with layer_scope("wi"):
        h = nmatmul(x, params["wi"])
    with layer_scope("wg"):
        g = nmatmul(x, params["wg"])
    h = logical_constraint(h, hidden_axes)
    g = logical_constraint(g, hidden_axes)
    h = h * F.silu(g)
    with layer_scope("wo"):
        return nmatmul(h.to(x.dtype), params["wo"])


def softcap(x: torch.Tensor, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
