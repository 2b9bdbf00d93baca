"""Attention: GQA with qk-norm and RoPE (sliding-window and softcapped
variants), blockwise prefill, grouped decode, and whisper's
cross-attention.

Numerics: q/k/v/o projections route through ``nmatmul`` (the paper's
configurable multiplier); the score and PV products stay bf16 operands
with fp32 accumulation, as in the JAX package, computed as fp32 einsums
of bf16-rounded operands (exact products, fp32 sums); a decode step's
self-attention runs the scores, the softmax and the PV sum in fp64 and
rounds once (:func:`~.layers.einsum_f64`), so a row's attention does not
depend on the batch it is decoded in (the cross-attention keeps the
blockwise form in decode, as the reference does).  The
reference's algorithm is kept (no ``scaled_dot_product_attention``) so
the bits stay comparable.

Caches are updated in place: the port's serving state is mutable, which
saves the copy a functional update would make of every layer's cache.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import layer_scope, nmatmul

from .layers import apply_rope, bf16_round, einsum_f64, rmsnorm, softcap

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, KH, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KH, n_rep, D).reshape(
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
    its own position (S_new == 1)."""
    if isinstance(pos, torch.Tensor) and pos.dim():
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, pos] = new[:, 0].to(buf.dtype)
    else:
        pos = int(pos)
        buf[:, pos:pos + new.shape[1]] = new.to(buf.dtype)
    return buf


def _mask_for(qp, kp, kvalid, causal, window):
    mask = kvalid[None, None, None, :]
    if causal:
        mask = mask & (qp[None, None, :, None] >= kp[None, None, None, :])
    if window is not None:
        mask = mask & (qp[None, None, :, None] - kp[None, None, None, :] < window)
    return mask


def blockwise_attention(q, k, v, *, causal=True, window=None,
                        attn_cap=None, q_chunk=1024, kv_chunk=1024,
                        q_offset=0):
    """Flash-style online-softmax attention over (q_chunk x kv_chunk)
    blocks, causal unless ``causal=False`` (the encoder and the
    cross-attention), where only the key-validity mask applies: the keys
    that pad the last chunk still add an exact zero.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D) (kv already head-repeated);
    ``q_offset`` is the absolute position of the first query.  bf16
    operands, fp32 online softmax, the JAX package's chunking.  Returns
    (B, Sq, H, D) fp32.

    Training differentiates this with autograd (the reference's custom VJP
    re-streams the score blocks to keep memory flat, which the training
    lengths here do not need).  The running max only steadies the
    exponentials and cancels from the result, so it carries no gradient.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    pad_q, pad_k = nq * qc - Sq, nk * kc - Sk
    qs = bf16_round(torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q)))
    ks = bf16_round(torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k)))
    vs = bf16_round(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k)))
    dev = q.device
    q_pos = int(q_offset) + torch.arange(nq * qc, device=dev).reshape(nq, qc)
    k_pos = torch.arange(nk * kc, device=dev).reshape(nk, kc)
    k_valid = k_pos < Sk

    outs = []
    for i in range(nq):
        qb = qs[:, i * qc:(i + 1) * qc]
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        o = torch.zeros((B, qc, H, D), dtype=torch.float32, device=dev)
        for j in range(nk):
            kb = ks[:, j * kc:(j + 1) * kc]
            vb = vs[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if attn_cap is not None:
                s = softcap(s, attn_cap)
            mask = _mask_for(q_pos[i], k_pos[j], k_valid[j], causal, window)
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


def gqa_apply(params, x, cfg, spec, positions, cache=None, q_offset=0,
              causal=True):
    """Returns (out, new_cache); cache = dict(k, v) of (B, S_max, KH, D)
    tensors, updated in place.  ``causal=False`` is the encoder's
    bidirectional self-attention (no cache)."""
    B, S, d = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    with layer_scope("wq"):
        q = nmatmul(x, params["wq"]).reshape(B, S, H, hd)
    with layer_scope("wk"):
        k = nmatmul(x, params["wk"]).reshape(B, S, KH, hd)
    with layer_scope("wv"):
        v = nmatmul(x, params["wv"]).reshape(B, S, KH, hd)
    decoding = cache is not None and S == 1
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps, f64=decoding)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps, f64=decoding)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = spec.window if spec.attn == "local" else None

    if cache is None:
        out = blockwise_attention(
            q, _repeat_kv(k, H // KH), _repeat_kv(v, H // KH),
            causal=causal, window=window, attn_cap=cfg.attn_softcap,
            q_offset=q_offset)
        new_cache = {"k": k, "v": v}
    else:
        # decode (S == 1) or chunked prefill (S > 1, scalar q_offset):
        # update the cache at q_offset, attend the full cache
        k_cache = _cache_update(cache["k"], k, q_offset)
        v_cache = _cache_update(cache["v"], v, q_offset)
        if not decoding:
            # chunked prefill: the same blockwise kernel as the no-cache
            # prefill, over the updated cache; rows past the frontier mask
            # to exact-zero contributions
            out = blockwise_attention(
                q, _repeat_kv(k_cache, H // KH), _repeat_kv(v_cache, H // KH),
                window=window, attn_cap=cfg.attn_softcap, q_offset=q_offset)
        else:
            out = decode_attention(q, k_cache, v_cache, q_offset,
                                   window=window, attn_cap=cfg.attn_softcap)
        new_cache = {"k": k_cache, "v": v_cache}

    out = out.to(x.dtype).reshape(B, S, H * hd)
    with layer_scope("wo"):
        return nmatmul(out, params["wo"]).to(x.dtype), new_cache


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
    qr = q.reshape(B, KH, G, D)
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
    p = torch.softmax(s, dim=-1)
    o = einsum_f64("bkgs,bskd->bkgd", p.to(bf), v_cache.to(bf))
    return o.reshape(B, 1, H, D)


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
        q = nmatmul(x, params["wq"]).reshape(B, S, H, hd)
    with layer_scope("wk"):
        k = nmatmul(enc_out, params["wk"]).reshape(B, Se, H, hd)
    with layer_scope("wv"):
        v = nmatmul(enc_out, params["wv"]).reshape(B, Se, H, hd)
    out = blockwise_attention(q, k, v, causal=False)
    out = out.to(x.dtype).reshape(B, S, H * hd)
    with layer_scope("wo"):
        return nmatmul(out, params["wo"]).to(x.dtype)
