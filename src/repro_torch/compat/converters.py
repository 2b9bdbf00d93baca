"""Per-family pretrained-checkpoint converters.

The port's counterpart of ``repro.compat.converters``.  A
:class:`Converter` binds one checkpoint family (a foreign naming scheme)
to one of the port's model families through a
:class:`~repro_torch.compat.state_dict.Mapping` built from the config.
Registered so far:

=============  =========================================  ==============
family         foreign layout                             native model
=============  =========================================  ==============
``qwen3-4b``   HF ``Qwen3ForCausalLM`` (``model.layers.   decoder LM,
               {i}.self_attn.q_proj...``, tied lm_head)   ``seg{s}_p{p}``
``whisper-tiny`` HF ``WhisperForConditionalGeneration``   enc-dec LM
               (``model.encoder/decoder.layers.{i}...``)  + ``encoder.*``
``resnet18``   torchvision ``resnet18`` state dict        CIFAR ResNet
               (``layer{1..4}.{b}``, OIHW convs)          + bn state
=============  =========================================  ==============

As in the reference, the whisper mapping reads an extension key
(``...layers.{i}.fc_gate.weight``) for the gate of the model's gated MLP,
which real Whisper checkpoints do not have; their LayerNorm and attention
biases have no native counterpart (``unknown="ignore"`` drops them).

:func:`load_pretrained` reads the checkpoint (safetensors single or
sharded, or a torch pickle by extension), builds the family mapping for
the resolved config, renames and adapts into the native state dict, and
validates every leaf against a template built from the model's own shapes
(:func:`repro_torch.models.transformer.param_shapes`,
:func:`repro_torch.models.resnet.shapes`).  :func:`export_pretrained`
is the exact inverse.  Both work on host numpy arrays; the caller puts
them on a device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

from .safetensors_io import load_checkpoint, read_torch_checkpoint
from .state_dict import (CompatError, Leaf, MapRule, Mapping, flatten_tree,
                         unflatten_tree)

__all__ = ["Converter", "DecoderLMConverter", "LoadedCheckpoint",
           "ResNet18Converter", "WhisperConverter",
           "converter_for", "export_pretrained", "families",
           "load_pretrained", "register_converter"]

FORMAT_TAG = "repro-compat/1"

_TORCH_SUFFIXES = (".pt", ".pth", ".bin")


@dataclasses.dataclass(frozen=True)
class LoadedCheckpoint:
    """The result of :func:`load_pretrained`, ready for a Session."""

    family: str
    kind: str                 # "lm" | "resnet"
    cfg: object               # ArchConfig | ResNetConfig
    params: dict              # nested numpy arrays
    state: Optional[dict]     # resnet batch-norm running statistics
    metadata: Dict[str, str]


# ---------------------------------------------------------------------------
# transformer block mapping rules
# ---------------------------------------------------------------------------

# foreign key templates of the HF qwen/llama naming scheme, relative to the
# layer prefix
_QWEN_NAMES = {
    "ln1": "input_layernorm.weight",
    "ln2": "post_attention_layernorm.weight",
    "attn.wq": "self_attn.q_proj.weight",
    "attn.wk": "self_attn.k_proj.weight",
    "attn.wv": "self_attn.v_proj.weight",
    "attn.wo": "self_attn.o_proj.weight",
    "attn.q_norm": "self_attn.q_norm.weight",
    "attn.k_norm": "self_attn.k_norm.weight",
    "mlp.wi": "mlp.up_proj.weight",
    "mlp.wg": "mlp.gate_proj.weight",
    "mlp.wo": "mlp.down_proj.weight",
}

_WHISPER_NAMES = {
    "ln1": "self_attn_layer_norm.weight",
    "ln2": "final_layer_norm.weight",
    "attn.wq": "self_attn.q_proj.weight",
    "attn.wk": "self_attn.k_proj.weight",
    "attn.wv": "self_attn.v_proj.weight",
    "attn.wo": "self_attn.out_proj.weight",
    "mlp.wi": "fc1.weight",
    "mlp.wg": "fc_gate.weight",      # extension: the model's MLP is gated
    "mlp.wo": "fc2.weight",
    "cross.wq": "encoder_attn.q_proj.weight",
    "cross.wk": "encoder_attn.k_proj.weight",
    "cross.wv": "encoder_attn.v_proj.weight",
    "cross.wo": "encoder_attn.out_proj.weight",
    "ln_cross": "encoder_attn_layer_norm.weight",
}

# norms store HF's raw weight as our ``1 + scale``: an import shift
_NORM_SHIFT = -1.0


def _block_rules(prefix, dst_prefix, names, stack_kw, *, qk_norm=False,
                 cross=False):
    """MapRules for one (stacked) transformer block position."""
    def mk(slot, dst, **kw):
        return MapRule(prefix + names[slot], dst_prefix + dst,
                       **stack_kw, **kw)

    rules = [
        mk("ln1", "ln1.scale", shift=_NORM_SHIFT),
        mk("ln2", "ln2.scale", shift=_NORM_SHIFT),
        mk("attn.wq", "attn.wq", transpose=True),
        mk("attn.wk", "attn.wk", transpose=True),
        mk("attn.wv", "attn.wv", transpose=True),
        mk("attn.wo", "attn.wo", transpose=True),
    ]
    if qk_norm:
        rules += [mk("attn.q_norm", "attn.q_norm.scale", shift=_NORM_SHIFT),
                  mk("attn.k_norm", "attn.k_norm.scale", shift=_NORM_SHIFT)]
    if cross:
        rules += [mk("cross.wq", "cross.wq", transpose=True),
                  mk("cross.wk", "cross.wk", transpose=True),
                  mk("cross.wv", "cross.wv", transpose=True),
                  mk("cross.wo", "cross.wo", transpose=True),
                  mk("ln_cross", "ln_cross.scale", shift=_NORM_SHIFT)]
    rules += [
        mk("mlp.wi", "mlp.wi", transpose=True),
        mk("mlp.wg", "mlp.wg", transpose=True),
        mk("mlp.wo", "mlp.wo", transpose=True),
    ]
    return rules


def _decoder_stack_rules(cfg, layer_tpl, names, *, cross=False):
    """Rules for every ``seg{s}_p{p}`` against global HF layer indices."""
    rules = []
    base = 0
    for si, (repeats, pattern) in enumerate(cfg.segments):
        period = len(pattern)
        for pi, spec in enumerate(pattern):
            if spec.kind != "dense" or spec.attn not in ("global", "local"):
                raise CompatError(
                    f"no pretrained converter for layer kind="
                    f"{spec.kind!r} attn={spec.attn!r} "
                    f"(seg{si}_p{pi} of {cfg.arch_id})")
            if spec.shared:
                raise CompatError(f"no pretrained converter for shared "
                                  f"blocks (seg{si}_p{pi} of {cfg.arch_id})")
            stack_kw = dict(stack=repeats, start=base + pi, stride=period)
            rules += _block_rules(layer_tpl, f"seg{si}_p{pi}.", names,
                                  stack_kw, qk_norm=cfg.qk_norm, cross=cross)
        base += repeats * period
    return rules


class Converter:
    """One checkpoint family.  Subclasses provide the mapping and config
    resolution; the base class owns load and export."""

    family: str
    kind: str

    def mapping(self, cfg) -> Mapping:
        raise NotImplementedError

    def default_config(self, reduced: bool):
        raise NotImplementedError

    def config_json(self, cfg) -> str:
        raise NotImplementedError

    def config_from_json(self, text: str):
        raise NotImplementedError

    def templates(self, cfg):
        """(params_template, state_template | None) of :class:`Leaf`\\ s."""
        raise NotImplementedError

    def resolve_config(self, cfg, metadata: Dict[str, str], reduced: bool):
        if cfg is not None:
            return cfg
        meta_fam = metadata.get("repro.family")
        if meta_fam is not None and meta_fam != self.family:
            raise CompatError(f"checkpoint metadata says family "
                              f"{meta_fam!r}, loader asked for "
                              f"{self.family!r}")
        blob = metadata.get("repro.config")
        if blob is not None:
            try:
                return self.config_from_json(blob)
            except (json.JSONDecodeError, TypeError, ValueError,
                    KeyError) as e:
                raise CompatError(f"bad repro.config metadata for "
                                  f"{self.family}: {e}") from None
        return self.default_config(reduced)

    def export_metadata(self, cfg) -> Dict[str, str]:
        return {"format": FORMAT_TAG, "repro.family": self.family,
                "repro.config": self.config_json(cfg)}

    def build(self, cfg, native: Dict[str, np.ndarray],
              metadata: Dict[str, str], *, cast: bool) -> LoadedCheckpoint:
        params_tpl, state_tpl = self.templates(cfg)
        params = unflatten_tree(params_tpl, native, cast=cast)
        state = (unflatten_tree(state_tpl, native, cast=cast)
                 if state_tpl is not None else None)
        return LoadedCheckpoint(self.family, self.kind, cfg, params, state,
                                metadata)


class DecoderLMConverter(Converter):
    """HF decoder-only causal LM (qwen/llama naming scheme)."""

    kind = "lm"

    def __init__(self, family: str):
        self.family = family

    def default_config(self, reduced: bool):
        from repro_torch.configs import get_arch
        base = get_arch(self.family)
        return base.reduced() if reduced else base

    def config_json(self, cfg) -> str:
        return json.dumps({"arch_id": cfg.arch_id,
                           "reduced": cfg.d_model == 64})

    def config_from_json(self, text: str):
        from repro_torch.configs import get_arch
        spec = json.loads(text)
        base = get_arch(spec["arch_id"])
        return base.reduced() if spec.get("reduced") else base

    def templates(self, cfg):
        from repro_torch.models import transformer

        f32 = np.dtype(np.float32)
        return transformer.unflatten(
            {k: Leaf(tuple(shape), f32)
             for k, (shape, _) in transformer.param_shapes(cfg).items()}), None

    def mapping(self, cfg) -> Mapping:
        rules = [MapRule("model.embed_tokens.weight", "embed")]
        rules += _decoder_stack_rules(cfg, "model.layers.{i}.", _QWEN_NAMES)
        rules.append(MapRule("model.norm.weight", "final_norm.scale",
                             shift=_NORM_SHIFT))
        if not cfg.tie_embeddings:
            rules.append(MapRule("lm_head.weight", "unembed",
                                 transpose=True))
        return Mapping(rules)


class WhisperConverter(DecoderLMConverter):
    """HF whisper encoder-decoder (the ``model.encoder/decoder.layers.{i}``
    split)."""

    def mapping(self, cfg) -> Mapping:
        if not cfg.encoder_layers:
            raise CompatError(f"{self.family}: whisper converter needs an "
                              f"encoder (encoder_layers=0 in config)")
        rules = [MapRule("model.decoder.embed_tokens.weight", "embed")]
        rules += _decoder_stack_rules(cfg, "model.decoder.layers.{i}.",
                                      _WHISPER_NAMES, cross=True)
        rules.append(MapRule("model.decoder.layer_norm.weight",
                             "final_norm.scale", shift=_NORM_SHIFT))
        if not cfg.tie_embeddings:
            rules.append(MapRule("proj_out.weight", "unembed",
                                 transpose=True))
        # the encoder's layers are one stacked block set
        enc_stack = dict(stack=cfg.encoder_layers, start=0, stride=1)
        rules += _block_rules("model.encoder.layers.{i}.", "encoder.blocks.",
                              _WHISPER_NAMES, enc_stack,
                              qk_norm=cfg.qk_norm, cross=False)
        rules.append(MapRule("model.encoder.layer_norm.weight",
                             "encoder.norm.scale", shift=_NORM_SHIFT))
        return Mapping(rules)


class ResNet18Converter(Converter):
    """torchvision ``resnet18`` naming onto the CIFAR ResNet family."""

    kind = "resnet"

    def __init__(self, family: str = "resnet18"):
        self.family = family

    def default_config(self, reduced: bool):
        from repro_torch.models.resnet import ResNetConfig
        return ResNetConfig()

    def config_json(self, cfg) -> str:
        return json.dumps({"num_classes": cfg.num_classes,
                           "widths": list(cfg.widths),
                           "blocks": list(cfg.blocks)})

    def config_from_json(self, text: str):
        from repro_torch.models.resnet import ResNetConfig
        spec = json.loads(text)
        return ResNetConfig(num_classes=spec["num_classes"],
                            widths=tuple(spec["widths"]),
                            blocks=tuple(spec["blocks"]))

    def templates(self, cfg):
        from repro_torch.models import resnet
        from repro_torch.models.transformer import unflatten

        f32 = np.dtype(np.float32)
        return tuple(unflatten({k: Leaf(tuple(shape), f32)
                                for k, (shape, _) in flat.items()})
                     for flat in resnet.shapes(cfg))

    def mapping(self, cfg) -> Mapping:
        conv = dict(permute=(2, 3, 1, 0))  # torch OIHW -> our HWIO
        rules = [MapRule("conv1.weight", "stem", **conv)]
        rules += self._bn_rules("bn1.", "bn_stem.")
        cin = cfg.widths[0]
        for si, (w, n) in enumerate(zip(cfg.widths, cfg.blocks)):
            for bi in range(n):
                src = f"layer{si + 1}.{bi}."
                dst = f"s{si}b{bi}."
                stride = 2 if (si > 0 and bi == 0) else 1
                rules += [MapRule(src + "conv1.weight", dst + "conv1",
                                  **conv),
                          MapRule(src + "conv2.weight", dst + "conv2",
                                  **conv)]
                rules += self._bn_rules(src + "bn1.", dst + "bn1.")
                rules += self._bn_rules(src + "bn2.", dst + "bn2.")
                if stride != 1 or cin != w:
                    rules.append(MapRule(src + "downsample.0.weight",
                                         dst + "proj", **conv))
                    rules += self._bn_rules(src + "downsample.1.",
                                            dst + "bn_proj.")
                cin = w
        rules += [MapRule("fc.weight", "fc", transpose=True),
                  MapRule("fc.bias", "fc_b")]
        return Mapping(rules)

    @staticmethod
    def _bn_rules(src, dst):
        # weight/bias live in params, running statistics in the state
        # tree: one flat native namespace, split by the two templates
        return [MapRule(src + "weight", dst + "scale"),
                MapRule(src + "bias", dst + "bias"),
                MapRule(src + "running_mean", dst + "mean"),
                MapRule(src + "running_var", dst + "var")]


_CONVERTERS: Dict[str, Converter] = {}


def register_converter(conv: Converter) -> Converter:
    _CONVERTERS[conv.family] = conv
    return conv


def converter_for(family: str) -> Converter:
    try:
        return _CONVERTERS[family]
    except KeyError:
        raise CompatError(f"no checkpoint converter registered for "
                          f"{family!r} (have: "
                          f"{', '.join(sorted(_CONVERTERS))})") from None


def families() -> list:
    return sorted(_CONVERTERS)


register_converter(DecoderLMConverter("qwen3-4b"))
register_converter(WhisperConverter("whisper-tiny"))
register_converter(ResNet18Converter("resnet18"))


def _read_foreign(path):
    p = os.fspath(path)
    if p.endswith(_TORCH_SUFFIXES):
        return read_torch_checkpoint(p), {}
    return load_checkpoint(p)


def load_pretrained(family: str, path, *, cfg=None, reduced: bool = True,
                    unknown: str = "error", cast: bool = True
                    ) -> LoadedCheckpoint:
    """Load a pretrained checkpoint into native (numpy) trees.

    ``path``: a ``.safetensors`` file, a sharded
    ``*.safetensors.index.json`` (or a directory holding either), or a
    torch pickle (by extension).  ``cfg`` overrides the architecture;
    otherwise it comes from the checkpoint's ``repro.config`` metadata
    when present, else the family's default.  ``unknown`` is the
    strict-vs-ignore mode for unmapped foreign keys; ``cast=True``
    converts leaf dtypes to the template's.
    """
    conv = converter_for(family)
    foreign, metadata = _read_foreign(path)
    cfg = conv.resolve_config(cfg, metadata, reduced)
    native = conv.mapping(cfg).to_native(foreign, unknown=unknown)
    return conv.build(cfg, native, metadata, cast=cast)


def export_pretrained(family: str, cfg, params, state=None):
    """Native trees (tensors on any device, or arrays) ->
    ``(foreign_state_dict, metadata)`` for this family (the exact inverse
    of :func:`load_pretrained`)."""
    conv = converter_for(family)
    native = flatten_tree(params)
    if state is not None:
        native.update(flatten_tree(state))
    return conv.mapping(cfg).to_foreign(native), conv.export_metadata(cfg)
