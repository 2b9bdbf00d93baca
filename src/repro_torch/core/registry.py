"""Multiplier registry -- the "operator library" of the compiler flow.

The port's counterpart of ``repro.core.registry``: every multiplier design
(exact, AC-n-n, ACL-n, MMBS-k, CSS-m, NC/LPC/HPC) is registered under the
paper's label and resolvable by name from model/benchmark configs.

AFPM-family entries also record their :class:`AFPMConfig`, so
:func:`get_elementwise` can route them through the kernel substrate
(:func:`repro_torch.kernels.dispatch.multiply`): the Hopper kernel for CUDA
tensors, the plain datapath for CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import afpm, baselines
from .exact_mult import exact_mult_f32

MultFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, MultFn] = {}
_AFPM_CONFIGS: Dict[str, afpm.AFPMConfig] = {}


def register(name: str, fn: MultFn,
             afpm_cfg: afpm.AFPMConfig | None = None) -> None:
    _REGISTRY[name.lower()] = fn
    if afpm_cfg is not None:
        _AFPM_CONFIGS[name.lower()] = afpm_cfg


def get_multiplier(name: str) -> MultFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError as e:
        raise ValueError(
            f"unknown multiplier {name!r}; available: {sorted(_REGISTRY)}"
        ) from e


def available() -> list[str]:
    return sorted(_REGISTRY)


def afpm_config(name: str) -> afpm.AFPMConfig | None:
    """The :class:`AFPMConfig` registered under ``name`` (None for a
    design that is not of the AFPM family)."""
    return _AFPM_CONFIGS.get(name.lower())


def get_elementwise(name: str, backend: str = "auto") -> MultFn:
    """Backend-aware elementwise multiplier.

    AFPM-family names (AC-n-n / ACL-n / AC-<fmt>) dispatch through the
    kernel substrate under ``backend``; other designs have no kernel and
    run their registered plain PyTorch function.
    """
    cfg = afpm_config(name)
    if cfg is None:
        return get_multiplier(name)
    from repro_torch.kernels import dispatch  # lazy: kernels import core

    return lambda x, y: dispatch.multiply(x, y, cfg, backend=backend)


def _register_defaults() -> None:
    register("exact", exact_mult_f32)
    for n in (3, 4, 5, 6, 7):
        cfg = afpm.AFPMConfig(n=n, mode="ac")
        register(f"AC{n}-{n}", lambda x, y, c=cfg: afpm.afpm_mult_f32(x, y, c), cfg)
    for n in (4, 5, 6, 8):
        cfg = afpm.AFPMConfig(n=n, mode="acl")
        register(f"ACL{n}", lambda x, y, c=cfg: afpm.afpm_mult_f32(x, y, c), cfg)
    # narrower storage formats (paper: FP16..FP32 supported by the framework)
    for fmtname, nmax in (("fp16", 5), ("afp24", 7), ("bf16", 3)):
        cfg = afpm.AFPMConfig(n=min(nmax, 5), mode="ac", fmt=fmtname)
        register(f"AC-{fmtname}", lambda x, y, c=cfg: afpm.afpm_mult_f32(x, y, c), cfg)
    for k in (5, 6, 7):
        cfg = baselines.MMBSConfig(k=k)
        register(f"MMBS{k}", lambda x, y, c=cfg: baselines.mmbs_mult_f32(x, y, c))
    for m in (12, 14, 16, 18):
        cfg = baselines.CSSConfig(m=m)
        register(f"CSS{m}", lambda x, y, c=cfg: baselines.css_mult_f32(x, y, c))
    for comp in ("nc", "lpc", "hpc"):
        cfg = baselines.LogConfig(comp=comp)
        register(comp.upper(), lambda x, y, c=cfg: baselines.log_mult_f32(x, y, c))


_register_defaults()
