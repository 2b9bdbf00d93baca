"""Mixture of experts with sort-based capacity dispatch: top-k routing,
capacity-factor drops, shared (always-on) experts (llama4, deepseek-v3).

The reference's group-local path (``_moe_apply_gspmd``), which it takes
whenever no device mesh shards the experts, so always on one device: each
batch row is a routing group of its ``S * K`` assignments, sorted by
expert and given ``C`` slots an expert; assignments past an expert's
``C`` are dropped.  The tokens are gathered into a dense ``(B, E, C, D)``
buffer, the experts run on it, and each token gathers its ``K`` slots
back, weighted by its renormalised gates.  (The expert-parallel path of
the reference, ``_moe_apply_shardmap``, needs a mesh.)

Every routed expert's three projections resolve under their own
``expert{k}.{wi,wg,wo}`` paths (``blocks.{i}.mlp.expert3.wi``), so a
policy can put experts on different multipliers; the shared expert
resolves under ``shared.*``.  When every expert resolves to ``exact`` and
no calibration tap is recording, the experts run as one fused einsum over
the stack in the activation dtype, the reference's datapath.  The router
is control logic: fp32 whatever the numerics (fp64 in a decode step,
rounded once to fp32, so that a row's expert choice does not depend on
the batch it is decoded in; see :func:`~.layers.einsum_f64`).

Two traps of a port are closed here: ``torch.argsort`` is not stable
unless asked (``jnp.argsort`` is), and ``torch.topk`` promises no order
among equal values where ``jax.lax.top_k`` takes the lower index first,
so the top-k is a stable descending sort.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.numerics import (current_numerics, current_path, layer_scope,
                                  nmatmul, numerics_scope, operand_tap_active,
                                  resolve, scoped)

from .layers import einsum_f64, mlp_apply


def moe_param_shapes(cfg) -> dict:
    """The MoE layer's leaves ``{name: (shape, init)}`` (the reference's
    ``moe_init``): ``router`` (d, E), the expert stacks ``wi`` / ``wg``
    (E, d, d_ff) and ``wo`` (E, d_ff, d), and the shared expert's
    ``shared.{wi, wg, wo}`` (d_ff x n_shared wide) when it has one."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe
    E = e.n_experts
    out = {
        "router": ((d, E), ("normal", d ** -0.5)),
        "wi": ((E, d, ff), ("normal", d ** -0.5)),
        "wg": ((E, d, ff), ("normal", d ** -0.5)),
        "wo": ((E, ff, d), ("normal", ff ** -0.5)),
    }
    if e.n_shared:
        sf = ff * e.n_shared
        out.update({
            "shared.wi": ((d, sf), ("normal", d ** -0.5)),
            "shared.wg": ((d, sf), ("normal", d ** -0.5)),
            "shared.wo": ((sf, d), ("normal", sf ** -0.5)),
        })
    return out


def routed_expert_configs(ncfg, n_experts: int) -> dict:
    """Resolved config per (projection, expert) under ``expert{k}.{name}``:
    ``{name: (cfg_expert0, ..., cfg_expertE-1)}`` for wi / wg / wo.
    ``ncfg`` is the block's ``mlp``-scoped policy view, or a plain config
    (the same for every expert)."""
    return {name: tuple(resolve(ncfg, f"expert{k}.{name}")
                        for k in range(n_experts))
            for name in ("wi", "wg", "wo")}


def _all_exact(cfgs: dict) -> bool:
    return all(c.mode == "exact" for tup in cfgs.values() for c in tup)


def _ambient_view():
    """The ambient numerics rooted at the current layer path (a policy
    scoped there, so ``expert3.wi`` resolves under the full path)."""
    amb, prefix = current_numerics(), current_path()
    return scoped(amb, prefix) if prefix else amb


def _experts_matmul(buf, w, name: str, out_dtype):
    """``buf (B, E, C, D) @ w (E, D, F)``, one ``nmatmul`` an expert under
    its own ``expert{k}.{name}`` scope, so experts may run different
    multipliers in one forward."""
    B, E, C, D = buf.shape
    outs = []
    for k in range(E):
        with layer_scope(f"expert{k}.{name}"):
            ye = nmatmul(buf[:, k].reshape(B * C, D), w[k])
        outs.append(ye.reshape(B, C, -1).to(out_dtype))
    return torch.stack(outs, dim=1)


def capacity(cfg, S: int) -> int:
    """Slots an expert in a routing group of ``S`` tokens (the reference's
    formula, its truncation included): at least 4, a multiple of 4.  It
    depends on the group's length, so a prompt prefilled in chunks routes
    (and drops) differently from the same prompt prefilled whole."""
    e = cfg.moe
    return max(4, -(-int(S * e.top_k / e.n_experts * e.capacity_factor)
                    // 4) * 4)


def route(probs: torch.Tensor, top_k: int):
    """Top-``top_k`` of ``probs`` (..., E): (gate, eidx), the gates
    renormalised to sum to 1.  Equal probabilities pick the lower expert
    index first, as ``jax.lax.top_k`` does (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :top_k], idx[..., :top_k]
    return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), eidx


def dispatch_plan(eidx: torch.Tensor, n_experts: int, C: int):
    """Each batch row's routing plan from its expert choices ``eidx``
    (B, S, K): ``src`` (B, E * C), one plus the token that feeds each
    expert slot (0 for an empty slot), and ``inv`` (B, S, K), the slot of
    each assignment (-1 where it was dropped).  A row's ``S * K``
    assignments are sorted by expert (stably: within an expert, token
    order), and an expert keeps its first ``C``."""
    B, S, K = eidx.shape
    A = S * K
    dev = eidx.device
    ea = eidx.reshape(B, A)
    order = torch.argsort(ea, dim=-1, stable=True)
    es = torch.gather(ea, 1, order)
    ts = order // K                         # the token of each assignment
    counts = torch.zeros((B, n_experts), dtype=torch.long, device=dev)
    counts.scatter_add_(1, es, torch.ones_like(es))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(A, device=dev)[None, :] - torch.gather(starts, 1, es)
    keep = pos < C
    slot = es * C + torch.where(keep, pos, 0)
    src = torch.zeros((B, n_experts * C), dtype=torch.long, device=dev)
    # a dropped assignment adds 0 to a slot its expert's first kept one
    # holds (amax leaves that one)
    src.scatter_reduce_(1, slot, torch.where(keep, ts + 1, 0), "amax")
    inv = torch.empty((B, A), dtype=torch.long, device=dev)
    inv.scatter_(1, order, torch.where(keep, slot, -1))
    return src, inv.reshape(B, S, K)


def moe_apply(params, x: torch.Tensor, cfg, ncfg=None,
              decoding: bool = False) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) under the ambient numerics (the caller
    sets this block's ``mlp`` scope); ``ncfg`` optionally sets the scope
    for this call.  ``decoding`` (a decode step) computes the router's
    logits in fp64, rounded once to fp32."""
    ctx = (numerics_scope(ncfg) if ncfg is not None
           else contextlib.nullcontext())
    with ctx:
        return _moe_apply(params, x, cfg, decoding)


def _moe_apply(params, x, cfg, decoding):
    B, S, D = x.shape
    e = cfg.moe
    E, K = e.n_experts, e.top_k
    C = capacity(cfg, S)

    # routing: fp32 whatever the numerics
    if decoding:
        logits = einsum_f64("bsd,de->bse", x, params["router"]).to(
            torch.float32)
    else:
        logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                              params["router"].to(torch.float32))
    gate, eidx = route(torch.softmax(logits, dim=-1), K)      # (B, S, K)
    src, inv = dispatch_plan(eidx, E, C)

    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.where((src > 0)[..., None], x[rows, (src - 1).clamp_min(0)],
                      0).reshape(B, E, C, D)

    cfgs = routed_expert_configs(_ambient_view(), E)
    if _all_exact(cfgs) and not operand_tap_active():
        # the reference's fused all-expert datapath, in x's dtype
        h = torch.einsum("becd,edf->becf", buf, params["wi"].to(x.dtype))
        g = torch.einsum("becd,edf->becf", buf, params["wg"].to(x.dtype))
        h = h * F.silu(g)
        out = torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))
    else:
        h = _experts_matmul(buf, params["wi"], "wi", x.dtype)
        g = _experts_matmul(buf, params["wg"], "wg", x.dtype)
        h = h * F.silu(g)
        out = _experts_matmul(h, params["wo"], "wo", x.dtype)

    # combine: each token gathers its K slots, gate-weighted, summed in
    # the order k = 0 .. K-1
    flat = out.reshape(B, E * C, D)
    picked = torch.where((inv >= 0)[..., None],
                         flat[rows[..., None], inv.clamp_min(0)], 0)
    picked = picked * gate[..., None].to(x.dtype)           # (B, S, K, D)
    y = picked[:, :, 0]
    for k in range(1, K):
        y = y + picked[:, :, k]

    if "shared" in params:
        with layer_scope("shared"):
            y = y + mlp_apply(params["shared"], x.reshape(-1, D)).to(
                x.dtype).reshape(B, S, D)
    return y


def aux_load_balance_loss(logits, eidx, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss over ``logits`` (T, E) and the
    routed experts ``eidx`` (T, K): ``E * sum(mean prob * top-1 share)``."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)
    fe = F.one_hot(eidx[..., 0].long(), n_experts).to(torch.float32).mean(0)
    return n_experts * torch.sum(me * fe)
