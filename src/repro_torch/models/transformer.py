"""Model assembly: the LM decoder stack of all ten architectures: dense
GQA blocks (qwen3-4b, minitron-8b; sliding-window layers and softcaps:
gemma2-9b, gemma3-12b; M-RoPE: qwen2-vl-72b), MoE blocks (llama4, with
GQA; deepseek-v3, with MLA attention), attention-free SSD blocks
(mamba2-130m), the hybrid of both with one shared attention block
(zamba2-7b), and the whisper-style encoder-decoder (whisper-tiny).

A batch gives ``tokens`` (B, S), or ``embeds`` (B, S, d) in their place
(qwen2-vl's vision stub: precomputed patch embeddings, not scaled by
sqrt(d)), and optionally ``positions``, (B, S) or with M-RoPE (B, S, 3)
(t, h, w); without them positions count from the call's offset, the same
in all three M-RoPE streams.

Depth is organized as ``segments``: ``(repeats, pattern)`` pairs whose
params are stacked on a leading ``repeats`` axis, as in the JAX package
(the weights carry over unchanged); the port runs the repeats in a Python
loop where JAX used ``lax.scan``.  A ``shared`` pattern entry has one
weight set, no repeats axis, applied in every repeat; each application
keeps its own cache (stacked over repeats like any other) and resolves
its numerics under its own ``blocks.{i}`` path, so one weight set may run
under as many configs as it has applications.  Its gradient is the sum
over the applications (autograd accumulates it).

An encoder-decoder (``cfg.encoder_layers``) runs a bidirectional encoder
over ``batch["enc_embeds"]`` (B, Se, d), its stacked layers all resolving
under the one unindexed ``encoder.blocks`` path as in the reference (which
scans them with one trace); every decoder block then cross-attends the
encoder's output after its self-attention.  Prefill keeps that output in
the serving state (``enc_out``) and a decode step attends it again.

Public API:
  init(cfg, seed, device)                      -> params (nested dict)
  encoder_apply(params["encoder"], cfg, batch) -> encoder output
  loss_fn(params, cfg, batch)                  -> mean next-token NLL
  prefill(params, cfg, batch, max_len)         -> (last_logits, state)
  decode_step(params, cfg, batch, state, pos)  -> (logits, state)
  init_state(cfg, batch, max_len, dtype, device) -> serving state

Serving state is updated in place by ``decode_step`` (the returned state
is the same object), which saves a copy of every layer's cache per step.
An SSD block's cache is its conv tail and SSM state (no sequence axis);
prefill computes them in closed form.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import scope
from repro_torch.core.numerics import NumericsConfig, torch_dtype
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.numerics import (expert_paths, layer_scope, nmatmul,
                                  numerics_scope)

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (embed_lookup, fp64_sums, mlp_apply, normal, rmsnorm,
                     softcap)


def check_supported(cfg):
    """The port builds every block the ten configs use: dense and MoE
    blocks with GQA (global or sliding window) or MLA attention, and
    attention-free SSD blocks, shared or not.  It refuses an
    attention-free dense or MoE block (no config has one), and a block
    whose config section (``ssm``, ``moe``, ``mla``) is missing."""
    for _, pattern in cfg.segments:
        for spec in pattern:
            if spec.kind == "ssm":
                ok = spec.attn == "none" and cfg.ssm is not None
            else:
                ok = (spec.kind in ("dense", "moe")
                      and spec.attn in ("global", "local", "mla")
                      and (spec.kind != "moe" or cfg.moe is not None)
                      and (spec.attn != "mla" or cfg.mla is not None))
            if not ok:
                raise NotImplementedError(
                    f"{cfg.arch_id}: the PyTorch port has no layer {spec}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _block_shapes(cfg, spec, r: tuple, cross: bool) -> dict:
    """A dense or MoE block's leaves, each with the leading axes ``r``:
    GQA or (``spec.attn == "mla"``) MLA attention, a gated MLP of
    ``dense_ff`` or (``spec.kind == "moe"``) the MoE layer; ``cross`` adds
    the decoder's cross-attention and its norm."""
    d, H, KH, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    ff = cfg.dense_ff
    blk = {"ln1.scale": ((*r, d), ("zeros",)),
           "ln2.scale": ((*r, d), ("zeros",))}
    if spec.attn == "mla":
        blk.update({f"attn.{k}": ((*r, *shape), how) for k, (shape, how)
                    in attn.mla_param_shapes(cfg).items()})
    else:
        blk.update({
            "attn.wq": ((*r, d, H * hd), ("normal", d ** -0.5)),
            "attn.wk": ((*r, d, KH * hd), ("normal", d ** -0.5)),
            "attn.wv": ((*r, d, KH * hd), ("normal", d ** -0.5)),
            "attn.wo": ((*r, H * hd, d), ("normal", (H * hd) ** -0.5)),
        })
        if cfg.qk_norm:
            blk["attn.q_norm.scale"] = ((*r, hd), ("zeros",))
            blk["attn.k_norm.scale"] = ((*r, hd), ("zeros",))
    if spec.kind == "moe":
        blk.update({f"mlp.{k}": ((*r, *shape), how) for k, (shape, how)
                    in moe_mod.moe_param_shapes(cfg).items()})
    else:
        blk.update({
            "mlp.wi": ((*r, d, ff), ("normal", d ** -0.5)),
            "mlp.wg": ((*r, d, ff), ("normal", d ** -0.5)),
            "mlp.wo": ((*r, ff, d), ("normal", ff ** -0.5)),
        })
    if cross:
        # every head attends the encoder: k and v have H heads, not KH
        blk.update({
            "cross.wq": ((*r, d, H * hd), ("normal", d ** -0.5)),
            "cross.wk": ((*r, d, H * hd), ("normal", d ** -0.5)),
            "cross.wv": ((*r, d, H * hd), ("normal", d ** -0.5)),
            "cross.wo": ((*r, H * hd, d), ("normal", (H * hd) ** -0.5)),
            "ln_cross.scale": ((*r, d), ("zeros",)),
        })
    return blk


def param_shapes(cfg) -> dict:
    """Flat ``{dotted name: (shape, init)}`` in the JAX package's layout;
    ``init`` is ``("normal", scale)``, ``("zeros",)`` or
    ``("log_linspace", lo, hi)`` (the same in every repeat).  A ``shared``
    entry's leaves have no repeats axis; an encoder's layers are stacked
    under ``encoder.blocks`` (no cross-attention there), with
    ``encoder.norm.scale`` after them."""
    check_supported(cfg)
    d = cfg.d_model
    out = {"embed": ((cfg.vocab, d), ("normal", 1.0)),
           "final_norm.scale": ((d,), ("zeros",))}
    for si, (repeats, pattern) in enumerate(cfg.segments):
        for pi, spec in enumerate(pattern):
            pre = f"seg{si}_p{pi}"
            r = () if spec.shared else (repeats,)
            if spec.kind == "ssm":
                blk = {"ln1.scale": ((*r, d), ("zeros",))}
                blk.update({f"ssm.{k}": ((*r, *shape), how) for k, (shape, how)
                            in ssm_mod.ssm_param_shapes(cfg).items()})
                out.update({f"{pre}.{k}": v for k, v in blk.items()})
                continue
            blk = _block_shapes(cfg, spec, r, cross=bool(cfg.encoder_layers))
            out.update({f"{pre}.{k}": v for k, v in blk.items()})
    if not cfg.tie_embeddings:
        out["unembed"] = ((d, cfg.vocab), ("normal", d ** -0.5))
    if cfg.encoder_layers:
        enc = _block_shapes(cfg, _enc_spec(cfg), (cfg.encoder_layers,),
                            cross=False)
        out.update({f"encoder.blocks.{k}": v for k, v in enc.items()})
        out["encoder.norm.scale"] = ((d,), ("zeros",))
    return out


# logical axes of a block's leaves (without the stacked "layers" axis), the
# names the JAX package's initializers give them (``repro.models.layers.PP``)
_BLOCK_AXES = {
    "ln1.scale": ("embed",), "ln2.scale": ("embed",),
    "ln_cross.scale": ("embed",),
    "attn.wq": ("embed", "q_dim"), "attn.wk": ("embed", "kv_dim"),
    "attn.wv": ("embed", "kv_dim"), "attn.wo": ("q_dim", "embed"),
    "attn.q_norm.scale": ("embed",), "attn.k_norm.scale": ("embed",),
    "attn.wq_a": ("embed", "q_lora"), "attn.q_a_norm.scale": ("embed",),
    "attn.wq_b": ("q_lora", "q_dim"), "attn.wkv_a": ("embed", "kv_lora"),
    "attn.kv_a_norm.scale": ("embed",), "attn.wk_b": ("kv_lora", "q_dim"),
    "attn.wv_b": ("kv_lora", "q_dim"),
    "cross.wq": ("embed", "q_dim"), "cross.wk": ("embed", "q_dim"),
    "cross.wv": ("embed", "q_dim"), "cross.wo": ("q_dim", "embed"),
    "mlp.wi": ("embed", "mlp"), "mlp.wg": ("embed", "mlp"),
    "mlp.wo": ("mlp", "embed"), "mlp.router": ("embed", None),
    "mlp.shared.wi": ("embed", "mlp"), "mlp.shared.wg": ("embed", "mlp"),
    "mlp.shared.wo": ("mlp", "embed"),
    "ssm.in_proj": ("embed", "ssm_inner"), "ssm.conv_w": ("conv", "ssm_inner"),
    "ssm.conv_b": ("ssm_inner",), "ssm.A_log": (None,),
    "ssm.dt_bias": (None,), "ssm.norm": ("embed",),
    "ssm.out_proj": ("ssm_inner", "embed"),
}
_TOP_AXES = {"embed": ("vocab", "embed_table"), "unembed": ("embed_table", "vocab"),
             "final_norm.scale": ("embed",), "encoder.norm.scale": ("embed",)}
_EXPERT_STACKS = ("mlp.wi", "mlp.wg", "mlp.wo")


def param_specs(cfg) -> dict:
    """Flat ``{dotted name: logical axes}`` beside :func:`param_shapes`:
    each leaf's axis names as the JAX package's initializers give them
    (``layers`` on a stacked leaf, ``experts`` on a MoE expert stack), what
    :mod:`repro_torch.distributed.sharding` maps onto a mesh."""
    out = {}
    kinds = {f"seg{si}_p{pi}": spec for si, (_, pattern)
             in enumerate(cfg.segments) for pi, spec in enumerate(pattern)}
    for name in param_shapes(cfg):
        if name in _TOP_AXES:
            out[name] = _TOP_AXES[name]
            continue
        if name.startswith("encoder.blocks."):
            out[name] = ("layers",) + _BLOCK_AXES[name[len("encoder.blocks."):]]
            continue
        block, leaf = name.split(".", 1)
        spec = kinds[block]
        axes = _BLOCK_AXES[leaf]
        if spec.kind == "moe" and leaf in _EXPERT_STACKS:
            axes = ("experts",) + axes
        out[name] = axes if spec.shared else ("layers",) + axes
    return out


def block_numerics_sites(cfg, spec) -> tuple:
    """Relative resolution paths inside one block: every ``nmatmul`` call
    site, plus the SSD scan's backend lookup; a decoder block of an
    encoder-decoder has its cross-attention's four, a MoE block every
    routed expert's three (``mlp.expert{k}.{wi,wg,wo}``: one multiplier
    array an expert) and its shared expert's."""
    if spec.kind == "ssm":
        return ("ssm.in_proj", "ssm.out_proj", "ssm.scan")
    if spec.attn == "mla":
        sites = ("attn.wq_a", "attn.wq_b", "attn.wkv_a", "attn.wo")
    else:
        sites = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
    if cfg.encoder_layers:
        sites += ("cross.wq", "cross.wk", "cross.wv", "cross.wo")
    if spec.kind == "moe":
        sites += expert_paths(cfg.moe.n_experts, prefix="mlp")
        if cfg.moe.n_shared:
            sites += ("mlp.shared.wi", "mlp.shared.wg", "mlp.shared.wo")
        return sites
    return sites + ("mlp.wi", "mlp.wg", "mlp.wo")


def _enc_spec(cfg):
    """The encoder's layers: dense, global attention (bidirectional)."""
    return dataclasses.replace(cfg.segments[0][1][0], kind="dense",
                               attn="global")


def _encoder_paths(cfg) -> list:
    enc_cfg = dataclasses.replace(cfg, encoder_layers=0)  # no cross there
    return [f"encoder.blocks.{s}"
            for s in block_numerics_sites(enc_cfg, _enc_spec(cfg))]


def layer_paths(cfg) -> list:
    """All policy paths of the decoder stack, the encoder and ``lm_head``,
    in the reference's order: what the auto-configurer and the PPA roll-up
    enumerate.  The encoder's unindexed ``encoder.blocks.*`` paths each
    stand for ``cfg.encoder_layers`` layers (:func:`layer_path_counts`)."""
    check_supported(cfg)
    paths = []
    idx = 0
    for repeats, pattern in cfg.segments:
        for _ in range(repeats):
            for spec in pattern:
                paths += [f"blocks.{idx}.{s}"
                          for s in block_numerics_sites(cfg, spec)]
                idx += 1
    if cfg.encoder_layers:
        paths += _encoder_paths(cfg)
    paths.append("lm_head")
    return paths


def layer_path_counts(cfg) -> dict:
    """Instance multiplicity of paths that stand for more than one layer:
    every encoder layer resolves under the same unindexed
    ``encoder.blocks.*`` paths, so each of those stands for
    ``cfg.encoder_layers`` multiplier-array instances; every other path
    stands for one.  The PPA roll-ups take this as ``counts=``."""
    check_supported(cfg)
    if not cfg.encoder_layers:
        return {}
    return {p: cfg.encoder_layers for p in _encoder_paths(cfg)}


def unflatten(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def init(cfg, seed: int = 0, device=None) -> dict:
    """Seeded random parameters, drawn on ``device`` by a
    :class:`torch.Generator` (the JAX package's PRNG stream cannot be
    reproduced; equivalence tests load its weights instead)."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = {}
    for name, (shape, how) in param_shapes(cfg).items():
        if how[0] == "zeros":
            flat[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif how[0] == "log_linspace":
            row = torch.log(torch.linspace(how[1], how[2], shape[-1],
                                           dtype=torch.float32, device=device))
            flat[name] = row.expand(shape).contiguous()
        else:
            flat[name] = normal(gen, shape, how[1], device)
    return unflatten(flat)


# ---------------------------------------------------------------------------
# serving state
# ---------------------------------------------------------------------------

#: the residual stream's logical axes (the reference's constraint at each
#: block boundary)
RESIDUAL_AXES = ("batch", "seq", None)

#: serving-state leaves -> logical axes, keyed by (dict key, rank)
STATE_AXES = {
    ("k", 5): ("layers", "batch", "kv_seq", None, None),
    ("v", 5): ("layers", "batch", "kv_seq", None, None),
    ("ckv", 4): ("layers", "batch", "kv_seq", None),
    ("kpe", 4): ("layers", "batch", "kv_seq", None),
    ("conv", 4): ("layers", "batch", None, "ssm_inner"),
    ("state", 5): ("layers", "batch", "ssm_heads", None, None),
    ("enc_out", 3): ("batch", "seq", None),
}


def state_axes(state, key=None):
    """The serving state's logical axes, leaf by leaf (keyed on the dict
    key that holds the leaf and its rank)."""
    if isinstance(state, dict):
        return {k: state_axes(v, k) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(state_axes(v, key) for v in state)
    return STATE_AXES.get((key, state.dim()), (None,) * state.dim())


def block_cache(cfg, spec, repeats: int, batch: int, max_len: int, dtype,
                device, zeros=None) -> dict:
    """Zero cache of one block pattern entry, stacked over ``repeats``;
    ``zeros(key, shape, dtype)`` makes each leaf (default: ``torch.zeros``
    on ``device``)."""
    if zeros is None:
        def zeros(key, shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)
    if spec.kind == "ssm":
        one = ssm_mod.ssm_cache_init(cfg, batch, dtype, device="meta")
        return {k: zeros(k, (repeats, *v.shape), v.dtype)
                for k, v in one.items()}
    if spec.attn == "mla":   # the latent cache: no head axis
        m = cfg.mla
        return {"ckv": zeros("ckv", (repeats, batch, max_len, m.kv_lora_rank),
                             dtype),
                "kpe": zeros("kpe", (repeats, batch, max_len, m.rope_head_dim),
                             dtype)}
    shape = (repeats, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": zeros("k", shape, dtype), "v": zeros("v", shape, dtype)}


def init_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, zeros=None) -> dict:
    """Serving state: per-block caches stacked over repeats,
    ``{"layers": [{pi: cache}]}``; an attention block's cache is
    ``{"k", "v": (repeats, batch, max_len, KH, hd)}`` in ``dtype`` (an
    MLA block's ``{"ckv": (repeats, batch, max_len, kv_lora_rank),
    "kpe": (..., rope_head_dim)}``), an SSD block's ``{"conv": (repeats,
    batch, W-1, d_inner)}`` in ``dtype`` and ``{"state": (repeats, batch,
    H, N, P)}`` in fp32.  An
    encoder-decoder's state also holds the encoder's output, ``enc_out``
    ``(batch, cfg.enc_len, d)`` in ``dtype`` (prefill puts the output of
    its own length there).  ``zeros(key, shape, dtype)`` makes each leaf
    (default: ``torch.zeros`` on ``device``)."""
    check_supported(cfg)
    state = {"layers": [
        {pi: block_cache(cfg, spec, repeats, batch, max_len, dtype, device,
                         zeros)
         for pi, spec in enumerate(pattern)}
        for repeats, pattern in cfg.segments]}
    if cfg.encoder_layers:
        shape = (batch, cfg.enc_len, cfg.d_model)
        state["enc_out"] = (zeros("enc_out", shape, dtype) if zeros else
                            torch.zeros(shape, dtype=dtype, device=device))
    return state


# ---------------------------------------------------------------------------
# decoder stack
# ---------------------------------------------------------------------------

def _block_apply(params, x, cfg, spec, positions, cache=None, q_offset=0,
                 train=False, causal=True, enc=None):
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if spec.kind == "ssm":
        with layer_scope("ssm"):
            h, new_cache = ssm_mod.ssm_apply(
                params["ssm"], h, cfg, cache=cache,
                want_state=cache is None and not train)
        return logical_constraint(x + h, RESIDUAL_AXES), new_cache
    with layer_scope("attn"):
        if spec.attn == "mla":
            h, new_cache = attn.mla_apply(params["attn"], h, cfg, spec,
                                          positions, cache=cache,
                                          q_offset=q_offset)
        else:
            h, new_cache = attn.gqa_apply(params["attn"], h, cfg, spec,
                                          positions, cache=cache,
                                          q_offset=q_offset, causal=causal)
    x = logical_constraint(x + h, RESIDUAL_AXES)
    if "cross" in params and enc is not None:
        h = rmsnorm(params["ln_cross"], x, cfg.norm_eps)
        with layer_scope("cross"):
            x = x + attn.cross_attn_apply(params["cross"], h, enc, cfg)
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    with layer_scope("mlp"):
        if spec.kind == "moe":
            h = moe_mod.moe_apply(params["mlp"], h, cfg)
        else:
            h = mlp_apply(params["mlp"], h).to(x.dtype)
    return logical_constraint(x + h, RESIDUAL_AXES), new_cache


def _take(tree, r):
    return {k: (_take(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def _unstack(tree, repeats: int) -> list:
    """Per-repeat views of a stacked tree, from one ``unbind`` a leaf: its
    backward writes the leaf's gradient once, where indexing each repeat
    would build a full-size gradient for every repeat."""
    flat = {k: (_unstack(v, repeats) if isinstance(v, dict)
                else torch.unbind(v, 0)) for k, v in tree.items()}
    return [{k: v[r] for k, v in flat.items()} for r in range(repeats)]


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products without batch
    dims (``aten.mm``), recompute the rest (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    policy = ckpt.CheckpointPolicy
    return (policy.MUST_SAVE if op in (torch.ops.aten.mm.default,
                                       torch.ops.aten.addmm.default)
            else policy.PREFER_RECOMPUTE)


def checkpointed(fn, *args, remat: str = "full"):
    """``fn(*args)`` under activation checkpointing: ``full`` saves only
    the inputs and recomputes ``fn`` in the backward, ``dots`` saves the
    matrix products too, ``none`` calls ``fn``.  The recompute runs under
    the numerics and layer scopes of the forward (autograd may run it in
    another thread)."""
    if remat == "none":
        return fn(*args)
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {remat!r}; expected full | dots | "
                         f"none")
    snap = scope.snapshot()

    def body(*a):
        with scope.restored(snap):
            return fn(*a)

    context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_dots) if remat == "dots"
               else ckpt.noop_context_fn)
    return ckpt.checkpoint(body, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context)


def _positions_for(cfg, batch, B: int, S: int, offset, device):
    """``batch["positions"]`` as given, else (B, S) absolute positions
    from a scalar offset, or from per-row ``(B,)`` offsets (continuous
    batching: each request at its own position); with M-RoPE sections
    they are broadcast to the three streams, (B, S, 3)."""
    if "positions" in batch:
        return batch["positions"].to(device)
    pos = torch.arange(S, device=device)[None, :]
    if isinstance(offset, torch.Tensor) and offset.dim():
        pos = pos + offset.to(device)[:, None]
    else:
        pos = pos + int(offset)
    pos = pos.expand(B, S)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(B, S, 3)
    return pos


def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    """``batch["embeds"]`` in ``cfg.dtype`` (a stub frontend's output,
    taken as it is), else the token embedding scaled by sqrt(d)."""
    dt = torch_dtype(cfg.dtype)
    if "embeds" in batch:
        return logical_constraint(batch["embeds"].to(dt), RESIDUAL_AXES)
    x = embed_lookup(params["embed"], batch["tokens"]).to(dt)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return logical_constraint(x, RESIDUAL_AXES)


def encoder_apply(params, cfg, batch, train=False):
    """The whisper-style encoder over ``batch["enc_embeds"]`` (B, Se, d):
    bidirectional blocks at positions ``0..Se-1`` (RoPE applies, as in the
    reference), then the encoder's final norm.  Runs under the ambient
    numerics; every layer resolves under the one unindexed
    ``encoder.blocks`` path, as the reference's scanned encoder does, so
    a policy cannot tell the layers apart and the calibration tap sees
    each site ``cfg.encoder_layers`` times.  ``train=True`` runs each
    layer under ``cfg.remat``."""
    x = logical_constraint(batch["enc_embeds"].to(torch_dtype(cfg.dtype)),
                           RESIDUAL_AXES)
    B, S = x.shape[:2]
    positions = _positions_for(cfg, {}, B, S, 0, x.device)
    block = functools.partial(_encoder_block, cfg=cfg, spec=_enc_spec(cfg),
                              positions=positions)
    for p in _unstack(params["blocks"], cfg.encoder_layers):
        with layer_scope("encoder.blocks"):
            x = (checkpointed(block, p, x, remat=cfg.remat) if train
                 else block(p, x))
    return rmsnorm(params["norm"], x, cfg.norm_eps)


def _encoder_block(p, x, cfg, spec, positions):
    return _block_apply(p, x, cfg, spec, positions, causal=False)[0]


def backbone(params, cfg, batch, caches=None, q_offset=0, train=False,
             enc=None):
    """Embeds -> (encoder) -> decoder stack -> final norm, under
    ``cfg.numerics``.

    Without ``caches`` (prefill) every block returns its fresh cache (k/v,
    or an SSD block's conv tail and final state), stacked over repeats;
    with ``caches`` (decode / chunked prefill) each block updates its cache
    in place.  ``train=True`` keeps no cache and runs every block under
    ``cfg.remat`` (:func:`checkpointed`).  An encoder-decoder's blocks
    cross-attend ``enc``, the encoder's output, computed here from
    ``batch["enc_embeds"]`` when not given.  Returns ``(hidden, caches)``
    (``caches`` None in train mode)."""
    check_supported(cfg)
    with numerics_scope(cfg.numerics):
        if cfg.encoder_layers and enc is None:
            enc = encoder_apply(params["encoder"], cfg, batch, train=train)
        x = _embed_inputs(params, cfg, batch)
        B, S = x.shape[:2]
        positions = _positions_for(cfg, batch, B, S, q_offset, x.device)
        new_caches = []
        layer = 0
        for si, (repeats, pattern) in enumerate(cfg.segments):
            P = len(pattern)
            collected = {pi: [] for pi in range(P)}
            # a shared entry hands its one weight set to every repeat
            stacks = {pi: ([params[f"seg{si}_p{pi}"]] * repeats
                           if spec.shared
                           else _unstack(params[f"seg{si}_p{pi}"], repeats))
                      for pi, spec in enumerate(pattern)}
            for r in range(repeats):
                for pi, spec in enumerate(pattern):
                    p = stacks[pi][r]
                    c = (None if caches is None
                         else _take(caches[si][pi], r))
                    with layer_scope(f"blocks.{layer + r * P + pi}"):
                        if train:
                            x = checkpointed(
                                functools.partial(_train_block, cfg=cfg,
                                                  spec=spec,
                                                  positions=positions,
                                                  enc=enc),
                                p, x, remat=cfg.remat)
                            continue
                        x, nc = _block_apply(p, x, cfg, spec, positions,
                                             cache=c, q_offset=q_offset,
                                             enc=enc)
                    collected[pi].append(nc)
            layer += repeats * P
            if train:
                continue
            if caches is None:
                new_caches.append({
                    pi: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                    for pi, cs in collected.items()})
            else:
                new_caches.append(caches[si])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, (None if train else new_caches)


def _train_block(p, x, cfg, spec, positions, enc=None):
    return _block_apply(p, x, cfg, spec, positions, train=True, enc=enc)[0]


@fp64_sums(False)
def _plain_head(params, cfg, hidden):
    """A plain config's head: a bf16 dot with fp32 sums (in a serving step
    too, on either route: K1's sums), outside nmatmul as
    in the reference, which is the segmented matmul at one pass
    (:func:`repro_torch.kernels.dispatch.matmul`, the Hopper kernel on the
    card: a row's logits do not depend on how many rows the call has).
    The tied table (V, d) is the kernel's ``x`` and the hidden's transpose
    its ``w``: an element depends only on its row and column, so the
    logits of a token do not depend on the other tokens either, and the
    table is read as it lies (``embed.T`` as ``w`` would be a copy of the
    whole table a call)."""
    from repro_torch.kernels import dispatch   # lazy: kernels import core

    backend = cfg.numerics.backend
    if not cfg.tie_embeddings:
        return sharding.placed_product(
            lambda h, w: dispatch.matmul(h, w, 1, backend=backend), hidden,
            params["unembed"])

    def tied(h, w):
        # h (..., d) and w = table.T (d, V) as placed_product lays them out
        h_t = sharding.rows(h).to(torch.float32).T
        out = dispatch.matmul(w.T, h_t, 1, backend=backend)   # (V, rows)
        return sharding.reshape(out.T.contiguous(), *h.shape[:-1],
                                w.shape[1])

    return sharding.placed_product(tied, hidden, params["embed"].T)


def logits_fn(params, cfg, hidden):
    if isinstance(cfg.numerics, NumericsConfig):
        logits = _plain_head(params, cfg, hidden)
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        # a policy resolves the head as ``lm_head`` like any projection
        with numerics_scope(cfg.numerics), layer_scope("lm_head"):
            logits = nmatmul(hidden, w)
    if cfg.tie_embeddings:
        # the tied table has unit-variance rows: d**-0.5 puts the logits
        # at the untied head's scale
        logits = logits * (cfg.d_model ** -0.5)
    logits = logical_constraint(logits, ("batch", "seq", "vocab"))
    return softcap(logits, cfg.logit_softcap)


@fp64_sums(False)
def loss_fn(params, cfg, batch, batch_chunks=None) -> torch.Tensor:
    """Causal-LM cross-entropy, mean over valid targets (``targets >= 0``).

    Chunked over the BATCH dim into ``cfg.loss_batch_chunks`` pieces (one
    piece when they do not divide it), each piece's logits recomputed in
    the backward instead of kept: a full-width vocabulary makes them the
    largest activation.  Placed, each rank's share of each piece is cut
    from its own block (:func:`~repro_torch.distributed.sharding.
    loss_pieces`).  The reference's fp32 sums throughout, whatever the
    caller's :func:`~.layers.fp64_sums`."""
    hidden, _ = backbone(params, cfg, batch, train=True)
    targets = batch["targets"]
    B = targets.shape[0]
    if batch_chunks is None:
        batch_chunks = cfg.loss_batch_chunks
    nb = batch_chunks if B % batch_chunks == 0 else 1

    def chunk_loss(h, t):
        lg = logits_fn(params, cfg, h)
        idx = t.clamp(min=0).long()[..., None]
        if sharding.is_dtensor(lg) and any(p.is_shard(lg.dim() - 1)
                                           for p in lg.placements):
            # over vocab-sharded logits: the max and the sum of exps as
            # partial reductions (DTensor's logsumexp would gather the
            # whole vocabulary)
            m = lg.amax(dim=-1, keepdim=True).detach()
            lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
        else:
            lse = torch.logsumexp(lg, dim=-1)
        # the gold logit from each rank's block (sharding.take_last)
        nll = lse - sharding.take_last(lg, idx)[..., 0]
        valid = (t >= 0).to(torch.float32)
        return (nll * valid).sum(), valid.sum()

    tot = cnt = 0.0
    for h, t in sharding.loss_pieces(hidden, targets, nb):
        nll, n = checkpointed(chunk_loss, h, t)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


@fp64_sums()
def prefill(params, cfg, batch, max_len=None):
    """Process the prompt, ``tokens`` or ``embeds`` (and ``positions``, an
    encoder-decoder's ``enc_embeds``); returns (last-token logits, serving
    state).  Runs under :func:`~.layers.fp64_sums`, as
    :func:`decode_step` does, so a prompt prefilled whole and one
    prefilled in chunks over the cache give the same bits."""
    first = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, S = first.shape[:2]
    max_len = max_len or S
    enc = None
    if cfg.encoder_layers:
        with numerics_scope(cfg.numerics):
            enc = encoder_apply(params["encoder"], cfg, batch)
    hidden, run = backbone(params, cfg, batch, enc=enc)
    placed = sharding.is_dtensor(hidden)
    # a placed step's state is laid out by the state's rules, each rank
    # making and writing its own block
    state = init_state(cfg, B, max_len, dtype=torch_dtype(cfg.dtype),
                       device=hidden.device, zeros=sharding.zeros_by_rules(
                           lambda key, rank: STATE_AXES.get(
                               (key, rank), (None,) * rank),
                           hidden.device) if placed else None)
    if enc is not None:
        state["enc_out"] = enc   # in cfg.dtype, at its own length
    for seg, run_seg, (_, pattern) in zip(state["layers"], run, cfg.segments):
        for pi, cache in seg.items():
            for k, leaf in cache.items():
                new = run_seg[pi][k].to(leaf.dtype)
                if pattern[pi].kind == "ssm":   # no sequence axis
                    sharding.copy_into_(leaf, new)
                else:
                    sharding.update_rows_(leaf, new, 0, dim=2)
    return logits_fn(params, cfg, hidden[:, -1:]), state


@fp64_sums()
def decode_step(params, cfg, batch, state, pos):
    """One step over ``batch['token']`` (B, S) at absolute position ``pos``.

    ``pos`` is a scalar for a lockstep batch (``Session.generate``; with
    S > 1 this is a chunked prefill) or a ``(B,)`` tensor when each row
    sits at its own position (the serving engine).  ``state`` is updated
    in place and returned.  An encoder-decoder's blocks cross-attend
    ``state["enc_out"]``.  Runs under :func:`~.layers.fp64_sums`: a row's
    logits do not depend on the rows it is decoded with."""
    hidden, _ = backbone(params, cfg, {"tokens": batch["token"]},
                         caches=state["layers"], q_offset=pos,
                         enc=state.get("enc_out"))
    return logits_fn(params, cfg, hidden), state
