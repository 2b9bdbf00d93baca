"""Abstract inputs of every (arch x shape) cell (``repro.launch.specs``
counterpart).

Abstract tensors live on ``torch.device("meta")``: a shape and a dtype,
no data, no device memory.  Parameters are built from
:func:`repro_torch.models.transformer.param_shapes` and never drawn
(``transformer.init`` draws on a ``torch.Generator``, which has no meta
device, and a full-size deepseek-v3 would take 2.7 TB in fp32).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.numerics import torch_dtype
from repro_torch.models import transformer

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_of(shape) -> dict:
    """A shape name of :data:`SHAPES`, or a ``{kind, seq, batch}`` dict
    itself (a cell of the caller's own size)."""
    return SHAPES[shape] if isinstance(shape, str) else dict(shape)


def shape_applicable(cfg, shape_name: str):
    """(ok, reason): long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "skipped(full-attention)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def abstract_params(cfg, dtype=None):
    """(params tree, logical-axes specs tree) of meta tensors in the JAX
    package's layout, fp32 unless ``dtype`` (a torch dtype or its name)."""
    dt = torch.float32 if dtype is None else torch_dtype(dtype) \
        if isinstance(dtype, str) else dtype
    params = transformer.unflatten(
        {name: _meta(shape, dt)
         for name, (shape, _) in transformer.param_shapes(cfg).items()})
    return params, transformer.unflatten(transformer.param_specs(cfg))


def abstract_state(cfg, batch: int, max_len: int):
    """The serving state of ``batch`` rows and ``max_len`` positions, on
    meta, in the config's activation dtype (SSM states in fp32)."""
    return transformer.init_state(cfg, batch, max_len,
                                  dtype=torch_dtype(cfg.dtype), device=META)


def batch_specs(cfg, shape):
    """Abstract batch of a train / prefill cell (tokens or stub embeds),
    int32 token ids and bf16 embeddings as in the JAX package."""
    sh = shape_of(shape)
    B, S = sh["batch"], sh["seq"]
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.frontend == "audio_stub":
        out = {"enc_embeds": _meta((B, S, cfg.d_model), bf16),
               "tokens": _meta((B, cfg.decoder_len), i32)}
        if sh["kind"] == "train":
            out["targets"] = _meta((B, cfg.decoder_len), i32)
        return out
    if cfg.frontend == "vision_stub":
        out = {"embeds": _meta((B, S, cfg.d_model), bf16)}
        if cfg.mrope_sections:
            out["positions"] = _meta((B, S, 3), i32)
        if sh["kind"] == "train":
            out["targets"] = _meta((B, S), i32)
        return out
    out = {"tokens": _meta((B, S), i32)}
    if sh["kind"] == "train":
        out["targets"] = _meta((B, S), i32)
    return out


BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "embeds": ("batch", "seq", None),
    "enc_embeds": ("batch", "seq", None),
    "positions": ("batch", "seq", None),
    "token": ("batch", None),
}

# serving-state leaves -> logical axes (the model's own table)
STATE_AXES = transformer.STATE_AXES
state_axes_tree = transformer.state_axes

#: the logits a prefill or decode step returns, (B, S, vocab)
LOGITS_AXES = ("batch", None, "vocab")


def batch_axes_tree(batch_abs):
    return {k: BATCH_AXES.get(k, (None,) * v.dim())[:v.dim()]
            for k, v in batch_abs.items()}


def opt_state_specs(opt_state, pspecs):
    """The optimizer state's logical axes from the params' (the reference's
    ``make_optimizer`` specs): AdamW's moments take the params' axes;
    Adafactor's factored moments their rows' and columns' axes."""
    from repro_torch.optim import adafactor, adamw

    if isinstance(opt_state, adamw.OptState):
        return adamw.OptState(step=(), mu=pspecs, nu=pspecs)

    def one(axes):
        return adafactor.FactoredMoment(
            row=tuple(axes[:-1]), col=tuple(axes[:-2]) + tuple(axes[-1:]),
            full=tuple(axes))

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return one(t)

    return adafactor.AdafactorState(step=(), v=walk(pspecs))


def cell_config(cfg, shape):
    """Shape-dependent config changes (whisper's encoder length)."""
    sh = shape_of(shape)
    if cfg.frontend == "audio_stub":
        cfg = dataclasses.replace(cfg, enc_len=sh["seq"])
    return cfg


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS for the roofline: 6*N_active*D (train) / 2*N_active*D
    (inference forward) + the causal attention's quadratic terms."""
    sh = shape_of(shape)
    B, S = sh["batch"], sh["seq"]
    n_active = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    attn_layers = [s for s in cfg.layer_specs() if s.attn not in ("none",)]
    if cfg.frontend == "audio_stub":
        # the decoder runs on decoder_len tokens; the encoder on S
        dec_T = B * cfg.decoder_len
        enc_flops_tok = cfg.encoder_layers * (4 * cfg.d_model ** 2
                                              + 3 * cfg.d_model * cfg.d_ff)
        if sh["kind"] == "train":
            base = 6 * n_active * dec_T + 6 * enc_flops_tok * B * S
        elif sh["kind"] == "prefill":
            base = 2 * n_active * dec_T + 2 * enc_flops_tok * B * S
        else:
            base = (2 * n_active * B
                    + 4 * B * S * cfg.n_heads * hd * len(attn_layers))
        return float(base)

    def span(sp):
        return min(S, sp.window if sp.attn == "local" else S)

    if sh["kind"] == "train":
        base = 6 * n_active * B * S
        attn = sum(6 * B * span(sp) * S * cfg.n_heads * hd
                   for sp in attn_layers)
        return float(base + attn)
    if sh["kind"] == "prefill":
        base = 2 * n_active * B * S
        attn = sum(2 * B * span(sp) * S * cfg.n_heads * hd
                   for sp in attn_layers)
        return float(base + attn)
    # decode: one token against an S-deep cache
    base = 2 * n_active * B
    attn = sum(4 * B * span(sp) * cfg.n_heads * hd for sp in attn_layers)
    return float(base + attn)
