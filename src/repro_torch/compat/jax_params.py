"""Carry the JAX package's parameters across to the port.

The JAX package keeps a decoder's weights as a nested tree with the
stacked-layer layout of ``tests/golden/compat/qwen3-4b_reference.npz``:
``embed`` ``(vocab, d)``, ``final_norm.scale``, ``seg0_p0.attn.wq``
``(repeats, d, H * hd)`` and so on; an SSD stack's blocks carry
``seg0_p0.ln1.scale`` and ``seg0_p0.ssm.{in_proj, conv_w, conv_b, A_log,
dt_bias, norm, out_proj}`` (mamba2-130m); a shared block entry (zamba2-7b's
``seg0_p5``) has no repeats axis; an encoder-decoder's decoder blocks add
``cross.{wq, wk, wv, wo}`` and ``ln_cross.scale``, and its encoder is
``encoder.blocks.*`` stacked over the encoder's layers plus
``encoder.norm.scale`` (whisper-tiny); a MoE block's MLP is
``mlp.router`` (d, E), the expert stacks ``mlp.{wi, wg, wo}``
``(repeats, E, ...)`` and ``mlp.shared.{wi, wg, wo}`` (llama4,
deepseek-v3), and an MLA block's attention ``attn.{wq_a, q_a_norm, wq_b,
wkv_a, kv_a_norm, wk_b, wv_b, wo}`` (deepseek-v3).  The port uses the same layout
(:func:`repro_torch.models.transformer.param_shapes`), so carrying weights
across is a check of names and shapes plus a copy.  The ResNet's
``(params, state)`` trees carry across the same way
(:func:`resnet_from_numpy`, against :func:`repro_torch.models.resnet.shapes`).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree, prefix="") -> dict:
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _carry(flat: dict, want: dict, what: str, device) -> dict:
    """``flat`` checked against ``want`` ``{name: (shape, init)}`` by names
    and shapes, as fp32 tensors on ``device``, flat."""
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter names differ from {what}'s: "
                         f"missing {missing}, unexpected {extra}")
    out = {}
    for name, (shape, _) in want.items():
        arr = np.asarray(flat[name], np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(shape)}")
        out[name] = torch.from_numpy(arr.copy()).to(device or "cpu")
    return out


def params_from_numpy(tree, cfg, device=None) -> dict:
    """The port's params for ``cfg`` from a parameter tree of numpy arrays
    (nested dicts, or flat dotted names), e.g.
    ``jax.tree.map(np.asarray, jax_session.params)``.

    Names and shapes must match :func:`transformer.param_shapes` exactly;
    a missing, extra or mis-shaped leaf raises :class:`ValueError`."""
    from repro_torch.models import transformer

    return transformer.unflatten(_carry(
        _flatten(tree), transformer.param_shapes(cfg), cfg.arch_id, device))


def resnet_from_numpy(params, state, cfg, device=None):
    """The port's ResNet ``(params, state)`` for ``cfg`` (a
    :class:`repro_torch.models.resnet.ResNetConfig`) from the JAX
    package's trees of numpy arrays, e.g. ``jax.tree.map(np.asarray,
    unzip(resnet.init(cfg, key)[0])[0])`` and its batch-norm state.
    Names and shapes must match :func:`resnet.shapes` exactly."""
    from repro_torch.models import resnet, transformer

    p_want, s_want = resnet.shapes(cfg)
    return (transformer.unflatten(_carry(_flatten(params), p_want,
                                         "resnet params", device)),
            transformer.unflatten(_carry(_flatten(state), s_want,
                                         "resnet state", device)))
