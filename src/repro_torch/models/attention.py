"""Attention: GQA with qk-norm and RoPE (sliding-window and softcapped
variants, M-RoPE sections), blockwise prefill, grouped decode, MLA
(deepseek-v3's multi-head latent attention) and whisper's
cross-attention.

Numerics: q/k/v/o projections route through ``nmatmul`` (the paper's
configurable multiplier); the score and PV products stay bf16 operands
with fp32 accumulation, as in the JAX package, computed as fp32 einsums
of bf16-rounded operands (exact products, fp32 sums).  Under the serving
path's sums (:func:`~.layers.fp64_sums`: a prefill, a chunked prefill, a
decode step) the scores, the softmax and the PV sum run in fp64 and
round once (:func:`~.layers.einsum_f64`), so a row's attention does not
depend on how many rows share the call: a decode step's self-attention
(its own grouped form) and the blockwise form alike (the
cross-attention keeps the blockwise form in decode, as the reference
does).  The reference's algorithm is kept (no
``scaled_dot_product_attention``) so the bits stay comparable.

A decode step on the card runs its attention core (qk-norm, RoPE, the
cache write and the grouped fp64 attention) as one hand-written kernel a
layer (:mod:`repro_torch.kernels.decode_attention`), with the same
roundings as :func:`decode_core_plain`, the op-by-op chain that every
other decode step runs (:func:`takes_decode_kernel` decides).

Caches are updated in place: the port's serving state is mutable, which
saves the copy a functional update would make of every layer's cache.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import logical_constraint, reshape
from repro_torch.kernels import decode_attention as fused
from repro_torch.numerics import layer_scope, nmatmul

import torch.nn.functional as F

from .layers import (apply_rope, bf16_round, einsum_f64, fp64_sums_on,
                     rmsnorm, softcap)

NEG_INF = -1e30

#: logical axes of q / k / v and the attention output (B, S, H, D): heads
#: sharded, the sequence whole; of a fresh K/V cache (B, S, KH, D); of
#: MLA's latent cache (B, S, r)
HEADS_AXES = ("batch", None, "heads", None)
CACHE_AXES = ("batch", "kv_seq", None, None)
LATENT_AXES = ("batch", "kv_seq", None)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, KH, D = k.shape
    return reshape(k[:, :, :, None, :].expand(B, S, KH, n_rep, D),
                   B, S, KH * n_rep, D)


def _row_pos(pos, rank: int):
    """A decode position shaped to broadcast against a rank-``rank`` score
    whose last axis is the cache sequence: a scalar (lockstep batch) stays
    as is, a per-row ``(B,)`` vector (continuous batching) becomes
    ``(B, 1, ..., 1)``."""
    if isinstance(pos, torch.Tensor) and pos.dim():
        return pos.reshape((-1,) + (1,) * (rank - 1))
    return pos


def _cache_update(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B, S_new, ...) into the (B, S, ...) cache ``buf`` in
    place at position ``pos``: a scalar writes rows ``[pos, pos + S_new)``
    of every batch row; a ``(B,)`` vector writes one row per batch row at
    its own position (S_new == 1).  A DTensor cache (a placed step, laid
    out by the state's rules) is written block by block on each rank, at
    a scalar position."""
    if isinstance(pos, torch.Tensor) and pos.dim():
        if sharding.is_dtensor(buf):
            raise NotImplementedError("a placed cache takes a scalar "
                                      "position (a lockstep batch)")
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, pos] = new[:, 0].to(buf.dtype)
        return buf
    return sharding.update_rows_(buf, new.to(buf.dtype), int(pos))


def _softmax_keys(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim (a decode step's keys).  Placed with the
    keys sharded (a kv_seq-sharded cache), as partial reductions: the max
    and the sum of exps over each rank's keys, reduced over the ranks,
    where DTensor's softmax would gather every score."""
    if not (sharding.is_dtensor(s) and any(
            p.is_shard(s.dim() - 1) for p in s.placements)):
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _mask_for(qp, kp, kvalid, causal, window):
    mask = kvalid[None, None, None, :]
    if causal:
        mask = mask & (qp[None, None, :, None] >= kp[None, None, None, :])
    if window is not None:
        mask = mask & (qp[None, None, :, None] - kp[None, None, None, :] < window)
    return mask


def blockwise_attention(q, k, v, **kwargs):
    """Flash-style online-softmax attention over (q_chunk x kv_chunk)
    blocks, causal unless ``causal=False`` (the encoder and the
    cross-attention), where only the key-validity mask applies: the keys
    that pad the last chunk still add an exact zero.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D) (kv already head-repeated);
    ``q_offset`` is the absolute position of the first query.  bf16
    operands, fp32 online softmax, the JAX package's chunking.  Returns
    (B, Sq, H, D) fp32, or under :func:`~.layers.fp64_sums` fp64 (every
    sum in fp64, for the caller to round once).  The key blocks start at
    multiples of ``kv_chunk`` (or cover every key in one block), so a
    whole prefill and a chunked one over a longer cache give a query the
    same blocks, their extra keys masked to exact zeros.

    Placed (DTensor operands) each rank attends its own rows and heads,
    laid out by :data:`HEADS_AXES` (heads are independent, so this is the
    same arithmetic), its blocks' ops on its local tensors."""
    if not sharding.is_dtensor(q):
        return _blockwise(q, k, v, **kwargs)
    mesh, rules = sharding.placement_context()
    spec = sharding.spec_for(HEADS_AXES, q.shape, mesh, rules)
    return collectives.shard_map(
        functools.partial(_blockwise, **kwargs), mesh, (spec, spec, spec),
        spec)(q, k, v)


def _blockwise(q, k, v, *, causal=True, window=None, attn_cap=None,
               q_chunk=1024, kv_chunk=1024, q_offset=0, v_pad=0):
    """:func:`blockwise_attention` on plain tensors; ``v_pad`` zero
    columns pad v's head dim up to q's (MLA's shared kernel).

    Training differentiates this with autograd (the reference's custom VJP
    re-streams the score blocks to keep memory flat, which the training
    lengths here do not need).  The running max only steadies the
    exponentials and cancels from the result, so it carries no gradient.
    """
    if v_pad:
        v = F.pad(v, (0, v_pad))
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    pad_q, pad_k = nq * qc - Sq, nk * kc - Sk
    f64 = fp64_sums_on()
    f = torch.float64 if f64 else torch.float32
    # bf16 operands: fp32 copies for fp32 sums, or as they are, widened
    # inside each fp64 product
    rnd = (lambda t: t.to(torch.bfloat16)) if f64 else bf16_round
    qs = rnd(_pad_rows(q, pad_q))
    ks = rnd(_pad_rows(k, pad_k))
    vs = rnd(_pad_rows(v, pad_k))
    dev = q.device
    q_pos = int(q_offset) + torch.arange(nq * qc, device=dev).reshape(nq, qc)
    k_pos = torch.arange(nk * kc, device=dev).reshape(nk, kc)
    k_valid = k_pos < Sk

    outs = []
    for i in range(nq):
        qb = qs[:, i * qc:(i + 1) * qc]
        m = torch.full((B, H, qc), NEG_INF, dtype=f, device=dev)
        l = torch.zeros((B, H, qc), dtype=f, device=dev)
        o = torch.zeros((B, qc, H, D), dtype=f, device=dev)
        for j in range(nk):
            kb = ks[:, j * kc:(j + 1) * kc]
            vb = vs[:, j * kc:(j + 1) * kc]
            mask = _mask_for(q_pos[i], k_pos[j], k_valid[j], causal, window)
            if f64:
                m, l, o = _block_f64(qb, kb, vb, mask, m, l, o, scale,
                                     attn_cap)
                continue
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if attn_cap is not None:
                s = softcap(s, attn_cap)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1)).detach()
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", bf16_round(p), vb)
            o = o * alpha.transpose(1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append(o / l.transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1)[:, :Sq]


def _pad_rows(t, pad: int):
    """``t`` (B, S, H, D) with ``pad`` zero rows after its S."""
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def _block_f64(qb, kb, vb, mask, m, l, o, scale, cap):
    """One key block of :func:`_blockwise`'s online softmax under the
    serving path's sums: the bf16 operands widened inside each product
    (exact products, fp64 sums), the softmax in fp64, the score block and
    the running sums updated in place (the serving path takes no
    gradient).  Returns the new ``(m, l, o)``."""
    s = einsum_f64("bqhd,bkhd->bhqk", qb, kb).mul_(scale)
    if cap is not None:
        s.div_(cap).tanh_().mul_(cap)
    s.masked_fill_(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = s.sub_(m_new[..., None]).exp_()
    l = l.mul_(alpha).add_(p.sum(dim=-1))
    pv = einsum_f64("bhqk,bkhd->bqhd", p.to(torch.bfloat16), vb)
    return m_new, l, o.mul_(alpha.transpose(1, 2)[..., None]).add_(pv)


def gqa_apply(params, x, cfg, spec, positions, cache=None, q_offset=0,
              causal=True):
    """Returns (out, new_cache); cache = dict(k, v) of (B, S_max, KH, D)
    tensors, updated in place.  ``causal=False`` is the encoder's
    bidirectional self-attention (no cache)."""
    B, S, d = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    with layer_scope("wq"):
        q = reshape(nmatmul(x, params["wq"]), B, S, H, hd)
    with layer_scope("wk"):
        k = reshape(nmatmul(x, params["wk"]), B, S, KH, hd)
    with layer_scope("wv"):
        v = reshape(nmatmul(x, params["wv"]), B, S, KH, hd)
    window = spec.window if spec.attn == "local" else None
    decoding = cache is not None and S == 1
    scales = (_norm_scales(params, cfg)
              if decoding and q.device.type == "cuda" else None)
    if decoding and takes_decode_kernel(q, k, v, cache, cfg, positions,
                                        q_offset, x.dtype, scales):
        # the whole attention core in one launch, the cache written in place
        out = fused.launch(q, k, v, cache["k"], cache["v"], q_offset,
                           positions, scales, cfg.norm_eps, cfg.rope_theta,
                           window, cfg.attn_softcap, x.dtype)
        new_cache = cache
    else:
        q, k, v = _norm_rope(params, q, k, v, cfg, positions)
        if cache is None:
            out = blockwise_attention(
                q, _repeat_kv(k, H // KH), _repeat_kv(v, H // KH),
                causal=causal, window=window, attn_cap=cfg.attn_softcap,
                q_offset=q_offset)
            out = logical_constraint(out, HEADS_AXES)
            new_cache = {"k": logical_constraint(k, CACHE_AXES),
                         "v": logical_constraint(v, CACHE_AXES)}
        elif decoding:
            out, new_cache = _attend_cache(q, k, v, cache, cfg, window,
                                           q_offset)
        else:
            # chunked prefill (S > 1, scalar q_offset): update the cache at
            # q_offset, then the same blockwise kernel as the no-cache
            # prefill over the updated cache; rows past the frontier mask
            # to exact-zero contributions
            k_cache = _cache_update(cache["k"], k, q_offset)
            v_cache = _cache_update(cache["v"], v, q_offset)
            out = blockwise_attention(
                q, _repeat_kv(k_cache, H // KH), _repeat_kv(v_cache, H // KH),
                window=window, attn_cap=cfg.attn_softcap, q_offset=q_offset)
            out = logical_constraint(out, HEADS_AXES)
            new_cache = {"k": k_cache, "v": v_cache}

    out = reshape(out.to(x.dtype), B, S, H * hd)
    with layer_scope("wo"):
        return nmatmul(out, params["wo"]).to(x.dtype), new_cache


def _norm_rope(params, q, k, v, cfg, positions):
    """qk-norm and RoPE of q and k, and q, k, v laid out with the heads
    sharded and the sequence whole (the reference's TP region; the
    residual stream re-shards at the block boundary)."""
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return (logical_constraint(q, HEADS_AXES), logical_constraint(k, HEADS_AXES),
            logical_constraint(v, HEADS_AXES))


def _attend_cache(q, k, v, cache, cfg, window, pos):
    """A decode step's cache update at ``pos`` (in place) and
    :func:`decode_attention` over the updated cache: ``(out fp64, new
    cache)``."""
    k_cache = _cache_update(cache["k"], k, pos)
    v_cache = _cache_update(cache["v"], v, pos)
    out = decode_attention(q, k_cache, v_cache, pos, window=window,
                           attn_cap=cfg.attn_softcap)
    return out, {"k": k_cache, "v": v_cache}


def decode_core_plain(params, q, k, v, cache, cfg, window, positions, pos):
    """A decode step's attention core op by op, as :func:`gqa_apply` runs
    it wherever the fused kernel does not (:func:`takes_decode_kernel`):
    qk-norm and RoPE (:func:`_norm_rope`), the cache update at ``pos`` (in
    place) and :func:`decode_attention`.  ``q`` (B, 1, H, D), ``k`` / ``v``
    (B, 1, KH, D) as the projections returned them.  Returns ``(out,
    new_cache)``, ``out`` fp64 (B, 1, H, D) for the caller to round once.
    The plain version of :mod:`repro_torch.kernels.decode_attention`."""
    return _attend_cache(*_norm_rope(params, q, k, v, cfg, positions), cache,
                         cfg, window, pos)


def _norm_scales(params, cfg):
    """The qk-norm scales as the kernel takes them (fp32), or None."""
    if not cfg.qk_norm:
        return None
    return (params["q_norm"]["scale"].to(torch.float32),
            params["k_norm"]["scale"].to(torch.float32))


def takes_decode_kernel(q, k, v, cache, cfg, positions, pos, out_dtype,
                        scales=None) -> bool:
    """Whether a decode step's attention core runs the fused kernel: on
    CUDA operands under the serving path's fp64 sums, with plain RoPE (no
    M-RoPE sections), an unplaced cache and the operands the kernel takes
    (:func:`repro_torch.kernels.decode_attention.refusal`); qk-norm
    (``scales``) on or off, a window and a softcap are the kernel's own."""
    return (q.device.type == "cuda" and fp64_sums_on()
            and cfg.mrope_sections is None
            and fused.refusal(q, k, v, cache["k"], cache["v"], positions,
                              pos, out_dtype, scales) is None)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, attn_cap=None):
    """Single-step attention against the full cache.

    ``pos`` is the absolute decode position: a scalar for a lockstep
    batch, or a ``(B,)`` vector when every row sits at its own position.
    GQA-aware: the query is grouped as (B, KH, G, D) and contracted against
    the unexpanded cache.  Computed in fp64 from bf16 operands; the output
    is fp64, rounded once by the caller."""
    B, S1, H, D = q.shape  # S1 == 1
    KH = k_cache.shape[2]
    G = H // KH
    qr = reshape(q, B, KH, G, D)
    bf = torch.bfloat16
    s = einsum_f64("bkgd,bskd->bkgs", qr.to(bf), k_cache.to(bf)) * (D ** -0.5)
    if attn_cap is not None:
        s = softcap(s, attn_cap)
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    pr = _row_pos(pos, 4)
    mask = k_pos[None, None, None, :] <= pr
    if window is not None:
        mask = mask & (pr - k_pos[None, None, None, :] < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = _softmax_keys(s)
    o = einsum_f64("bkgs,bskd->bkgd", p.to(bf), v_cache.to(bf))
    return reshape(o, B, 1, H, D)


def cross_attn_apply(params, x, enc_out, cfg):
    """Whisper's cross-attention: queries from the decoder's ``x`` (B, S,
    d), keys and values projected from ``enc_out`` (B, Se, d) in every
    call, as the reference computes them (nothing cached), attended with
    :func:`blockwise_attention` (``causal=False``, chunks of 1024), a
    decode step's one-token query too."""
    B, S, d = x.shape
    Se = enc_out.shape[1]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    with layer_scope("wq"):
        q = reshape(nmatmul(x, params["wq"]), B, S, H, hd)
    with layer_scope("wk"):
        k = reshape(nmatmul(enc_out, params["wk"]), B, Se, H, hd)
    with layer_scope("wv"):
        v = reshape(nmatmul(enc_out, params["wv"]), B, Se, H, hd)
    out = blockwise_attention(q, k, v, causal=False)
    out = reshape(out.to(x.dtype), B, S, H * hd)
    with layer_scope("wo"):
        return nmatmul(out, params["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_param_shapes(cfg) -> dict:
    """MLA's leaves ``{name: (shape, init)}`` in the reference's layout
    (``mla_init``): the q and kv low-rank projections with their norms,
    the latent's per-head expansions ``wk_b`` / ``wv_b`` and ``wo``."""
    d, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    qd = m.nope_head_dim + m.rope_head_dim
    r = m.kv_lora_rank
    return {
        "wq_a": ((d, m.q_lora_rank), ("normal", d ** -0.5)),
        "q_a_norm.scale": ((m.q_lora_rank,), ("zeros",)),
        "wq_b": ((m.q_lora_rank, H * qd), ("normal", m.q_lora_rank ** -0.5)),
        "wkv_a": ((d, r + m.rope_head_dim), ("normal", d ** -0.5)),
        "kv_a_norm.scale": ((r,), ("zeros",)),
        "wk_b": ((r, H * m.nope_head_dim), ("normal", r ** -0.5)),
        "wv_b": ((r, H * m.v_head_dim), ("normal", r ** -0.5)),
        "wo": ((H * m.v_head_dim, d), ("normal", (H * m.v_head_dim) ** -0.5)),
    }


def _mla_expanded(q_nope, q_pe, ckv, kpe, wk_b, wv_b, dt, q_offset):
    """Attention with the latent ``ckv`` (B, L, r) expanded into per-head
    K and V, blockwise and causal, as the reference's prefill computes it;
    v is padded to K's head size for the shared kernel and sliced back.

    The expansions are summed in fp64 and rounded once to ``dt``
    (:func:`~.layers.einsum_f64`): a chunked prefill expands the whole
    cache (L rows) where a prefill expands its S rows, and in fp64 a
    row's result does not depend on how many rows the library's kernel
    was given, so the two prefills agree bit for bit."""
    B, L = ckv.shape[:2]
    _, H, dn = wk_b.shape
    dv, dr = wv_b.shape[-1], kpe.shape[-1]
    # the latent's sequence gathered for the expansion into the (sharded)
    # heads, as GSPMD gathers it
    ckv = logical_constraint(ckv, ("batch", None, None))
    kpe = logical_constraint(kpe, ("batch", None, None))
    q_nope = logical_constraint(q_nope, HEADS_AXES)
    k_nope = einsum_f64("bsr,rhd->bshd", ckv, wk_b.to(dt)).to(dt)
    v = einsum_f64("bsr,rhd->bshd", ckv, wv_b.to(dt)).to(dt)
    k_nope = logical_constraint(k_nope, HEADS_AXES)
    v = logical_constraint(v, HEADS_AXES)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, L, H, dr)], dim=-1)
    qf = torch.cat([q_nope, q_pe], dim=-1)
    out = blockwise_attention(qf, k, v, v_pad=dn + dr - dv,
                              causal=True, q_offset=q_offset)
    return out[..., :dv]


def mla_apply(params, x, cfg, spec, positions, cache=None, q_offset=0):
    """MLA with its latent cache ``{"ckv": (B, L, r), "kpe": (B, L, dr)}``,
    updated in place.  Returns (out, new_cache).

    ``wq_a``, ``wq_b``, ``wkv_a`` and ``wo`` go through ``nmatmul``;
    ``wk_b`` and ``wv_b`` are plain products, as in the reference (which
    keeps them outside the numerics knob).  Three forms, the reference's:
    no cache (prefill, training) and a chunked prefill over the cache
    expand the latent into per-head K/V, which keeps chunked serving bit
    for bit equal to a whole prefill; a decode step attends the latent
    cache directly (the absorbed form), its contractions, norms and
    softmax in fp64, rounded once, so a row's step does not depend on the
    batch it runs in (see :func:`~.layers.einsum_f64`)."""
    B, S, _ = x.shape
    H, m = cfg.n_heads, cfg.mla
    dn, dr, dv, r = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    decoding = cache is not None and S == 1
    # the low-rank projections (unsharded outputs) run on the sequence
    # shard of the latent cache they fill, where GSPMD propagates its
    # kv_seq layout back to them; wq_b then gathers q's sequence
    x = logical_constraint(x, LATENT_AXES)
    with layer_scope("wq_a"):
        q = nmatmul(x, params["wq_a"])
    q = rmsnorm(params["q_a_norm"], q.to(x.dtype), cfg.norm_eps)
    with layer_scope("wq_b"):
        q = reshape(nmatmul(q, params["wq_b"]), B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    with layer_scope("wkv_a"):
        kv = nmatmul(x, params["wkv_a"])
    ckv = rmsnorm(params["kv_a_norm"], kv[..., :r].to(x.dtype), cfg.norm_eps)
    k_pe = reshape(apply_rope(reshape(kv[..., r:], B, S, 1, dr), positions,
                              cfg.rope_theta), B, S, dr)
    wk_b = reshape(params["wk_b"], r, H, dn)
    wv_b = reshape(params["wv_b"], r, H, dv)

    if cache is None:
        out = _mla_expanded(q_nope, q_pe, ckv, k_pe, wk_b, wv_b, x.dtype,
                            q_offset)
        new_cache = {"ckv": logical_constraint(ckv, LATENT_AXES),
                     "kpe": logical_constraint(k_pe, LATENT_AXES)}
    else:
        ckv_c = _cache_update(cache["ckv"], ckv, q_offset)
        kpe_c = _cache_update(cache["kpe"], k_pe, q_offset)
        new_cache = {"ckv": ckv_c, "kpe": kpe_c}
        if not decoding:
            # chunked prefill: the expanded form over the updated cache;
            # cache rows hold the bits a whole prefill rounds to, and rows
            # past the frontier mask to exact-zero contributions
            out = _mla_expanded(q_nope, q_pe, ckv_c.to(x.dtype),
                                kpe_c.to(x.dtype), wk_b, wv_b, x.dtype,
                                q_offset)
        else:
            # decode: q projected into the latent space attends the latent
            # cache (per-head K/V never materialise)
            bf = torch.bfloat16
            q_eff = einsum_f64("bshd,rhd->bshr", q_nope, wk_b.to(x.dtype)).to(
                torch.promote_types(q_nope.dtype, x.dtype))
            s = einsum_f64("bhr,bkr->bhk", q_eff[:, 0].to(bf), ckv_c.to(bf))
            s = s + einsum_f64("bhd,bkd->bhk", q_pe[:, 0].to(bf),
                               kpe_c.to(bf))
            s = s * ((dn + dr) ** -0.5)
            k_pos = torch.arange(ckv_c.shape[1], device=x.device)
            s = s.masked_fill(~(k_pos[None, None, :] <= _row_pos(q_offset, 3)),
                              NEG_INF)
            p = _softmax_keys(s)
            o_lat = einsum_f64("bhk,bkr->bhr", p.to(bf), ckv_c.to(bf))
            out = einsum_f64("bhr,rhd->bhd", o_lat.to(x.dtype),
                             wv_b.to(x.dtype))
            out = reshape(out, B, 1, H, dv)

    out = reshape(out.to(x.dtype), B, S, H * dv)
    with layer_scope("wo"):
        return nmatmul(out, params["wo"]).to(x.dtype), new_cache
