"""Architecture configuration: :class:`ArchConfig` built from
:class:`LayerSpec` patterns, with the paper's numerics as a first-class
field.

Layer patterns are ``segments``: a list of ``(repeats, [LayerSpec, ...])``.
Parameters of a segment are stacked on a leading ``repeats`` axis, as in
the JAX package; the port runs the repeats in a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.numerics import NumericsConfig


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "dense"          # dense | moe | ssm
    attn: str = "global"         # global | local | mla | none
    window: int = 4096           # local-attention window
    shared: bool = False         # reuse one weight set across repeats


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 1
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 128
    head_dim: int = 64
    expansion: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Tuple[Tuple[int, Tuple[LayerSpec, ...]], ...]
    head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    encoder_layers: int = 0
    decoder_len: int = 256
    enc_len: int = 1500
    frontend: str = "none"
    dense_d_ff: Optional[int] = None
    # the paper's knob: one global NumericsConfig or a NumericsPolicy
    numerics: object = NumericsConfig(mode="exact")
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "float32"
    optimizer: str = "adamw"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    grad_accum: int = 1
    loss_batch_chunks: int = 8
    remat: str = "full"
    fsdp: bool = False
    seq_shard_activations: bool = True
    sharding_overrides: Optional[Tuple[Tuple[str, object], ...]] = None
    moment_dtype: str = "float32"
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(r * len(p) for r, p in self.segments)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dense_ff(self) -> int:
        return self.dense_d_ff or self.d_ff

    def param_count(self) -> int:
        """Approximate parameter count (embeddings plus blocks; norms are
        not counted), the reference's formula term for term.  As there, a
        dense block's MLP counts ``d_ff`` wide, not ``dense_ff``: for
        llama4 and deepseek-v3, whose dense layers are wider than their
        experts, this undercounts them (``transformer.param_shapes`` has
        the true shapes)."""
        d, hd, ff = self.d_model, self.resolved_head_dim, self.d_ff
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for repeats, pattern in self.segments:
            seg = 0
            for spec in pattern:
                if spec.kind == "ssm":
                    s = self.ssm
                    din = s.expansion * d
                    nheads = din // s.head_dim
                    seg += d * (2 * din + 2 * s.state_size + nheads) + din * d
                    seg += s.conv_width * din + 2 * nheads
                elif spec.kind in ("dense", "moe"):
                    if spec.attn == "mla":
                        m = self.mla
                        qd = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                        seg += d * m.q_lora_rank + m.q_lora_rank * qd
                        seg += d * (m.kv_lora_rank + m.rope_head_dim)
                        seg += m.kv_lora_rank * self.n_heads * (
                            m.nope_head_dim + m.v_head_dim)
                        seg += self.n_heads * m.v_head_dim * d
                    elif spec.attn != "none":
                        seg += (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                                + self.n_heads * hd * d)
                    if spec.kind == "moe":
                        e = self.moe
                        seg += d * e.n_experts   # router
                        seg += 3 * d * ff * (e.n_experts + e.n_shared)
                    else:
                        seg += 3 * d * ff
                else:
                    raise ValueError(spec.kind)
            total += seg * (1 if all(s.shared for s in pattern) else repeats)
        if self.encoder_layers:
            # the whisper-style encoder's blocks and the decoder's
            # cross-attention (norms not counted, as in the reference)
            total += self.encoder_layers * (4 * d * d + 3 * d * self.d_ff)
            total += self.n_layers * 4 * d * d
        return total

    def layer_specs(self) -> list:
        """Flat list of LayerSpec in execution order (for counting)."""
        return [spec for repeats, pattern in self.segments
                for _ in range(repeats) for spec in pattern]

    def active_param_count(self) -> int:
        """Params a token touches (MoE: top_k routed experts and the
        shared ones), the reference's formula: :meth:`param_count` with
        ``n_experts`` set to ``top_k``."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        return dataclasses.replace(
            self, moe=dataclasses.replace(e, n_experts=e.top_k)).param_count()

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        def cut_pattern(pattern):
            return tuple(
                dataclasses.replace(s, window=min(s.window, 64)) for s in pattern
            )

        segs = tuple((min(r, 2), cut_pattern(p)) for r, p in self.segments)
        small_heads = max(2, min(4, self.n_heads))
        kv = max(1, min(self.n_kv_heads, small_heads))
        return dataclasses.replace(
            self,
            d_model=64,
            n_heads=small_heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab=256,
            segments=segs,
            moe=dataclasses.replace(self.moe, n_experts=4,
                                    top_k=min(2, self.moe.top_k),
                                    capacity_factor=4.0)
            if self.moe
            else None,
            mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                          nope_head_dim=16, v_head_dim=16)
            if self.mla
            else None,
            ssm=dataclasses.replace(self.ssm, state_size=16, head_dim=8, chunk=16)
            if self.ssm
            else None,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            encoder_layers=min(self.encoder_layers, 2),
            decoder_len=32,
            enc_len=64,
            grad_accum=1,
            fsdp=False,
            seq_shard_activations=False,
            dtype="float32",   # tight numerics for CPU smoke assertions
            dense_d_ff=128 if self.dense_d_ff else None,
            remat="none",
        )


_REGISTRY: dict = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_arch(arch_id: str) -> ArchConfig:
    from repro_torch import configs as _c  # noqa: F401  (registers archs)

    if arch_id not in _REGISTRY:
        raise ValueError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)
