"""Mamba2 (SSD) block: projections, causal conv and the chunked scan.

The scan is the SSD kernel (:func:`repro_torch.kernels.ops.ssd_scan`, the
Hopper kernel for CUDA tensors); this module is the block around it: the
fused in/out projections through the paper's numerics config, gating, the
depthwise causal conv, and the O(1) single-token decode update.

Layouts are the JAX package's: activations ``(B, S, H, P)`` going into the
scan, the SSM state ``(B, H, N, P)`` fp32 and the conv tail
``(B, W - 1, d_inner)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import logical_constraint, reshape
from repro_torch.kernels import ops
from repro_torch.numerics import layer_scope, nmatmul, resolve_here

from .layers import einsum_f64, rmsnorm


def ssm_dims(cfg):
    """``(d_inner, n_heads)`` of ``cfg``'s SSD block."""
    s = cfg.ssm
    d_inner = s.expansion * cfg.d_model
    return d_inner, d_inner // s.head_dim


def ssm_param_shapes(cfg) -> dict:
    """``{name: (shape, init)}`` of one SSD block, unstacked, in the JAX
    package's layout; ``in_proj`` is fused: ``[z, x, B, C, dt]``."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H = ssm_dims(cfg)
    proj_out = 2 * d_inner + 2 * s.state_size + H
    return {
        "in_proj": ((d, proj_out), ("normal", d ** -0.5)),
        "conv_w": ((s.conv_width, d_inner), ("normal", s.conv_width ** -0.5)),
        "conv_b": ((d_inner,), ("zeros",)),
        # A = -exp(A_log) spread over [-16, -1], the same in every layer
        "A_log": ((H,), ("log_linspace", 1.0, 16.0)),
        "dt_bias": ((H,), ("zeros",)),
        "norm": ((d_inner,), ("zeros",)),
        "out_proj": ((d_inner, d), ("normal", d_inner ** -0.5)),
    }


def _split_proj(proj, cfg):
    s = cfg.ssm
    d_inner, _ = ssm_dims(cfg)
    N = s.state_size
    z = proj[..., :d_inner]
    xs = proj[..., d_inner:2 * d_inner]
    B = proj[..., 2 * d_inner:2 * d_inner + N]
    C = proj[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xs, B, C, dt


def _causal_conv(xs, w, b, state=None):
    """Depthwise causal conv of width W.  xs: (B, S, D), w: (W, D).

    ``state`` (B, W-1, D) is the trailing context for decode (zeros, the
    conv's own history, without it).  Returns ``(silu(out), tail)`` with
    ``tail`` the last W-1 input rows of that history plus ``xs``, so a
    prompt shorter than W-1 keeps its zero rows in front."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros(xs.shape[:1] + (W - 1,) + xs.shape[2:],
                            dtype=xs.dtype, device=xs.device)
    full = torch.cat([state.to(xs.dtype), xs], dim=1)
    S = xs.shape[1]
    out = 0
    for i in range(W):   # summed in xs's dtype, term by term, as the reference
        out = out + full[:, i:i + S] * w[i].to(xs.dtype)
    out = out + b.to(xs.dtype)
    return F.silu(out), full[:, -(W - 1):]


#: logical axes of the scan's operands x, dt, A, B and C: heads sharded
SCAN_AXES = (("batch", None, "heads", None), ("batch", None, "heads"),
             ("heads",), ("batch", None, None), ("batch", None, None))


def _scan(x, dt, A, B, C, chunk: int, backend: str):
    """The SSD scan (:func:`repro_torch.kernels.ops.ssd_scan`).  Placed
    over several ranks, each rank scans its own heads and batch rows
    (:data:`SCAN_AXES`) on either route, as the reference keeps the heads
    sharded through the scan: the plain version on DTensors would run the
    chunk products of every head on each rank.  A DTensor that every rank
    holds whole (a mesh of one rank) goes to the scan as it is."""
    def scan(*ins):
        return ops.ssd_scan(*ins, chunk=chunk, backend=backend)

    if not sharding.is_split(x):
        return scan(x, dt, A, B, C)
    mesh, rules = sharding.placement_context()
    specs = tuple(sharding.spec_for(axes, t.shape, mesh, rules)
                  for axes, t in zip(SCAN_AXES, (x, dt, A, B, C)))
    return collectives.shard_map(scan, mesh, specs, specs[0])(x, dt, A, B, C)


def ssm_apply(params, x, cfg, cache=None, want_state=False):
    """x: (B, S, D).  ``cache`` = ``{"conv": (B, W-1, d_inner), "state":
    (B, H, N, P)}`` for a decode step (S = 1), updated IN PLACE.

    Without ``cache`` (prefill) the scan runs through the SSD kernel; with
    ``want_state`` the final state is also returned, in closed form (one
    weighted einsum over the sequence), with the conv tail.  Returns
    ``(out, new_cache)``.

    Numerics come from the ambient scope: ``in_proj`` / ``out_proj`` are
    the projections' call-site paths and ``scan`` selects the scan's
    kernel backend (the scan is not a multiplier datapath, but its backend
    is still per layer).
    """
    s = cfg.ssm
    B_, S, _ = x.shape
    d_inner, H = ssm_dims(cfg)
    P = s.head_dim
    f = torch.float32

    with layer_scope("in_proj"):
        proj = nmatmul(x, params["in_proj"]).to(x.dtype)
    proj = logical_constraint(proj, ("batch", None, "ssm_inner"))
    z, xs, Bm, Cm, dt = _split_proj(proj, cfg)
    dt = dt.to(f) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))            # softplus
    A = -torch.exp(params["A_log"].to(f))                     # (H,)

    if cache is None:
        xs, conv_tail = _causal_conv(xs, params["conv_w"], params["conv_b"])
        xh = reshape(xs, B_, S, H, P)
        Bf, Cf = Bm.to(f), Cm.to(f)
        y = _scan(xh, dt, A, Bf, Cf, s.chunk, resolve_here("scan").backend)
        new_cache = None
        if want_state:
            # S[h] = sum_l dt[l,h] e^{A_h (cum[L,h] - cum[l,h])} B[l] x[l,h]^T
            cum = torch.cumsum(dt, dim=1)                     # (B, S, H)
            w = dt * torch.exp(A * (cum[:, -1:, :] - cum))
            S_fin = torch.einsum("bsh,bsn,bshp->bhnp", w, Bf, xh.to(f))
            new_cache = {"conv": conv_tail.to(x.dtype), "state": S_fin}
    else:
        # decode: one token, O(1) state update, in place
        xs, conv_tail = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                     state=cache["conv"])
        xh = reshape(xs, B_, H, P).to(f)
        dt1 = dt[:, 0]                                        # (B, H)
        decay = torch.exp(A * dt1)                            # (B, H)
        Bv = Bm[:, 0].to(f)                                   # (B, N)
        Cv = Cm[:, 0].to(f)
        inp = dt1[..., None, None] * Bv[:, None, :, None] * xh[:, :, None, :]
        S_new = decay[..., None, None] * cache["state"] + inp
        # in fp64, rounded once below: the same row at any batch
        # (layers.einsum_f64)
        y = einsum_f64("bn,bhnp->bhp", Cv, S_new)[:, None]    # (B, 1, H, P)
        sharding.copy_into_(cache["conv"], conv_tail)
        sharding.copy_into_(cache["state"], S_new)
        new_cache = cache

    y = reshape(y, B_, S, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    with layer_scope("out_proj"):
        return nmatmul(y, params["out_proj"]).to(x.dtype), new_cache


def ssm_cache_init(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    """Zero decode cache of one SSD block: conv tail in ``dtype``, state
    fp32."""
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, s.state_size, s.head_dim),
                             dtype=torch.float32, device=device),
    }
