"""Mixture of experts with sort-based capacity dispatch: top-k routing,
capacity-factor drops, shared (always-on) experts (llama4, deepseek-v3).

Two implementations, chosen as the reference chooses them:

- **group-local** (the reference's ``_moe_apply_gspmd``; no mesh, or a
  mesh without ranks such as the dry-run's): each batch row is a routing
  group of its ``S * K`` assignments, sorted by expert and given ``C``
  slots an expert; assignments past an expert's ``C`` are dropped.  The
  tokens are gathered into a dense ``(B, E, C, D)`` buffer, the experts
  run on it, and each token gathers its ``K`` slots back, weighted by its
  renormalised gates.
- **expert parallel** (``_moe_apply_shardmap``): under
  :func:`~repro_torch.distributed.sharding.use_mesh_rules` with a mesh
  over ranks (:func:`~repro_torch.launch.mesh.make_test_mesh`) whose rules
  shard the experts, each rank routes its own block of tokens as one
  group (capacity from its ``T_loc`` tokens, not per batch row), sends
  each expert's slots to the rank holding it (one ``all_to_all``), runs
  its local experts, and sends the results back
  (:mod:`repro_torch.distributed.collectives`).

Every routed expert's three projections resolve under their own
``expert{k}.{wi,wg,wo}`` paths (``blocks.{i}.mlp.expert3.wi``), so a
policy can put experts on different multipliers; the shared expert
resolves under ``shared.*``.  When every expert resolves to ``exact`` and
no calibration tap is recording, the experts of CPU (or meta) tensors run
as one fused einsum over the stack in the activation dtype, the
reference's datapath; on the card each expert projection is one
``nmatmul`` (the Hopper kernel at one pass, whose rows do not depend on
the batch), as the other tiers run them.  The
expert-parallel path runs one config for all experts (a policy that
gives experts different configs takes the group-local path), under a
nested ``numerics_scope`` and no ``expert{k}`` scope, as the reference's
does.  The router is control logic: fp32 whatever the numerics (fp64
under the serving path's sums, rounded once to fp32, so that a row's
expert choice does not depend on the batch it is served in; see
:func:`~.layers.fp64_sums`).

Two traps of a port are closed here: ``torch.argsort`` is not stable
unless asked (``jnp.argsort`` is), and ``torch.topk`` promises no order
among equal values where ``jax.lax.top_k`` takes the lower index first,
so the top-k is a stable descending sort.  A token's ``K`` slots are
summed in the order k = 0 .. K-1 (no float scatter-add, whose atomics
sum in no fixed order on the card).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import (current_mesh_rules,
                                              local_shape, logical_constraint,
                                              spec_for)
from repro_torch.numerics import (current_numerics, current_path, layer_scope,
                                  nmatmul, numerics_scope, operand_tap_active,
                                  resolve, scoped)

from .layers import einsum_f64, fp64_sums_on, mlp_apply


#: logical axes of the group-local dispatch buffer (B, E, C, D): the
#: groups on the batch axes, the experts on theirs (the reference's
#: constraint; a placed step runs this path on each rank's rows)
BUF_AXES = ("batch", "experts", None, None)


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


def moe_apply(params, x: torch.Tensor, cfg, ncfg=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) under the ambient numerics (the caller
    sets this block's ``mlp`` scope); ``ncfg`` optionally sets the scope
    for this call.  Under the serving path's sums the router's logits are
    computed in fp64, rounded once to fp32.  Expert parallel where a mesh
    with ranks shards the experts (module docstring), else group-local."""
    ctx = (numerics_scope(ncfg) if ncfg is not None
           else contextlib.nullcontext())
    with ctx:
        state = current_mesh_rules()
        if state is not None and getattr(state[0], "has_ranks", False):
            mesh, rules = state
            if spec_for(("experts", None, None), params["wi"].shape, mesh,
                        rules)[0] is not None:
                return _moe_apply_shardmap(params, x, cfg, mesh, rules)
        return _moe_apply(params, x, cfg)


def _route(x, router, cfg, C: int):
    """Routing of the groups of ``x`` (G, S, D): ``(gate, eidx)`` (G, S,
    K) and the plan ``(src, inv)`` of :func:`dispatch_plan`."""
    if fp64_sums_on():
        logits = einsum_f64("bsd,de->bse", x, router).to(torch.float32)
    else:
        logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                              router.to(torch.float32))
    gate, eidx = route(torch.softmax(logits, dim=-1), cfg.moe.top_k)
    return (gate, eidx, *dispatch_plan(eidx, cfg.moe.n_experts, C))


def _dispatch(x, src):
    """The ``(G, E * C, D)`` buffer: each slot's token, or zeros."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return torch.where((src > 0)[..., None], x[rows, (src - 1).clamp_min(0)],
                       0)


def _combine(flat, inv, gate, dtype):
    """Each token's ``K`` slots of ``flat`` (G, E * C, D), gate-weighted,
    summed in the order k = 0 .. K-1: (G, S, D)."""
    rows = torch.arange(flat.shape[0], device=flat.device)[:, None, None]
    picked = torch.where((inv >= 0)[..., None], flat[rows, inv.clamp_min(0)],
                         0)
    picked = picked * gate[..., None].to(dtype)             # (G, S, K, D)
    y = picked[:, :, 0]
    for k in range(1, picked.shape[2]):
        y = y + picked[:, :, k]
    return y


def _shared(params, x, y):
    if "shared" not in params:
        return y
    # over (B, S, D) as it is, where the reference flattens it to (B * S,
    # D): the same products, row by row; a placed sequence-sharded x then
    # runs as every projection does, where a flatten of its sharded rows
    # is resharded otherwise by each torch's DTensor
    with layer_scope("shared"):
        return y + mlp_apply(params["shared"], x).to(x.dtype)


def _moe_apply(params, x, cfg):
    if sharding.is_dtensor(x):
        # placed: each rank routes its own rows (a row is a routing group),
        # every expert on every rank, as GSPMD partitions the reference's
        # vmapped groups over the batch
        mesh, rules = sharding.placement_context()
        xs = spec_for(("batch", None, None), x.shape, mesh, rules)
        return collectives.shard_map(
            lambda xl, p: _moe_apply(p, xl, cfg), mesh,
            (xs, sharding.P()), xs)(x, params)
    B, S, D = x.shape
    E = cfg.moe.n_experts
    C = capacity(cfg, S)
    gate, _, src, inv = _route(x, params["router"], cfg, C)
    buf = _dispatch(x, src).reshape(B, E, C, D)
    buf = logical_constraint(buf, BUF_AXES)

    cfgs = routed_expert_configs(_ambient_view(), E)
    # on the card each exact expert projection is a K1 launch, as under
    # the other tiers: the fused einsum's rows depend on the batch there
    if _all_exact(cfgs) and not operand_tap_active() and not x.is_cuda:
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
    out = logical_constraint(out, BUF_AXES)
    y = _combine(out.reshape(B, E * C, D), inv, gate, x.dtype)
    return _shared(params, x, y)


def _moe_apply_shardmap(params, x, cfg, mesh, rules):
    """Expert parallelism (the reference's ``_moe_apply_shardmap``):
    route the rank's ``T_loc`` tokens as one group, one ``all_to_all``
    out to the experts' ranks and one back, the local experts between."""
    E = cfg.moe.n_experts
    B, S, D = x.shape
    cfgs = routed_expert_configs(_ambient_view(), E)
    if any(len(set(tup)) > 1 for tup in cfgs.values()):
        return _moe_apply(params, x, cfg)
    ucfg = {name: tup[0] for name, tup in cfgs.items()}
    exact_experts = _all_exact(cfgs) and not x.is_cuda

    x_spec = spec_for(("batch", "seq", None), x.shape, mesh, rules)
    w_spec = spec_for(("experts", None, None), params["wi"].shape, mesh,
                      rules)
    r_spec = spec_for((None, None), params["router"].shape, mesh, rules)
    ex_axes = w_spec[0]
    b_loc, s_loc, _ = local_shape(x.shape, x_spec, mesh)
    T_loc = b_loc * s_loc
    C = capacity(cfg, T_loc)

    def local(b, w, c):
        with numerics_scope(c):
            return torch.stack([nmatmul(b[i], w[i])
                                for i in range(b.shape[0])]).to(x.dtype)

    def body(xl, router, wi, wg, wo):
        xt = xl.reshape(1, T_loc, D)                  # one routing group
        gate, _, src, inv = _route(xt, router, cfg, C)
        buf = _dispatch(xt, src).reshape(E, C, D)
        # (E, C, D) -> (E / nm, C * nm, D): each expert's slots from every
        # rank of the expert axes, on the rank that holds the expert
        buf = collectives.all_to_all(buf, mesh, ex_axes, 0, 1)
        if exact_experts:
            h = torch.einsum("ecd,edf->ecf", buf, wi.to(x.dtype))
            g = torch.einsum("ecd,edf->ecf", buf, wg.to(x.dtype))
            h = h * F.silu(g)
            out = torch.einsum("ecf,efd->ecd", h, wo.to(x.dtype))
        else:
            h = local(buf, wi, ucfg["wi"])
            g = local(buf, wg, ucfg["wg"])
            h = h * F.silu(g)
            out = local(h, wo, ucfg["wo"])
        out = collectives.all_to_all(out, mesh, ex_axes, 1, 0)   # (E, C, D)
        y = _combine(out.reshape(1, E * C, D), inv, gate, x.dtype)
        return y.reshape(xl.shape)

    y = collectives.shard_map(
        body, mesh, (x_spec, r_spec, w_spec, w_spec, w_spec), x_spec)(
        x, params["router"], params["wi"], params["wg"], params["wo"])
    return _shared(params, x, y)


def aux_load_balance_loss(logits, eidx, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss over ``logits`` (T, E) and the
    routed experts ``eidx`` (T, K): ``E * sum(mean prob * top-1 share)``."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)
    fe = F.one_hot(eidx[..., 0].long(), n_experts).to(torch.float32).mean(0)
    return n_experts * torch.sum(me * fe)
