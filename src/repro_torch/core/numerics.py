"""Numerics configuration + matmul dispatch: the "compiler integration" layer.

Every projection of the model zoo routes through :func:`nmatmul`, which
resolves its :class:`NumericsConfig` from the ambient
:func:`~repro_torch.core.scope.numerics_scope`.

Modes
-----
``exact``
    bf16 operands, fp32 accumulation (``compute_dtype`` / ``accum_dtype``):
    the reference's bf16 dot, which is the segmented matmul at one pass
    (AC only), so it runs through
    :func:`repro_torch.kernels.dispatch.matmul` with ``passes=1`` under
    ``backend``: on the card the Hopper kernel, whose rows do not depend
    on how many rows a call has; on the CPU its plain version, an fp32
    matmul of the bf16-rounded operands (every bf16 x bf16 product is
    exact in fp32).  Other dtypes (fp32 operands: ResNet's default) run
    ``torch.matmul`` on the operands cast to ``compute_dtype`` and
    ``accum_dtype``.
``segmented``
    Split-float (hi/lo bf16) matmul with term skipping, ``seg_passes`` =
    1, 2 or 3 tensor-core passes, backed by
    :mod:`repro_torch.kernels.dispatch` and selected by ``backend``:

    ``auto``    the Hopper kernel for CUDA tensors, the plain PyTorch
                version for CPU tensors (the default)
    ``hopper``  force the hand-written CUDA kernel (CUDA tensors only)
    ``torch``   force the plain PyTorch version

    On the plain route both modes sum a serving step's products in fp64
    (under :func:`~repro_torch.core.scope.fp64_sums`), exactly, and round
    once after a placed product's partial sums are reduced: a product's
    bits then depend neither on how many rows a call has nor on how its
    contraction or its output is split over ranks.  The kernel sums in
    fp32.
``emulated``
    Every scalar product goes through the bit-level multiplier selected by
    ``multiplier``, summed in fp32 in chunks of 64 along K.  AC-n-n /
    ACL-n (``seg_n`` wide) and the AC-<fmt> registry entries (their
    registered config, storage format kept; no gradient, as the registry's
    function has none) go through
    :func:`repro_torch.kernels.dispatch.emulated_matmul` under ``backend``:
    on the card the bit-level kernel's matmul entry, on the CPU (or with
    ``torch``) the plain :func:`~repro_torch.core.afpm.afpm_matmul_emulated`
    (where the reference computes the same function in jnp).  Any other
    registry name (the baselines) runs its registered function chunk by
    chunk (:func:`~repro_torch.core.afpm.chunked_emulated_matmul`), plain
    on either device: O(M*N*K) elementwise work.

:func:`apply_elementwise` is the image-processing path: an elementwise
product under a named multiplier, the AFPM family through the bit-level
Hopper kernel (:func:`repro_torch.kernels.dispatch.multiply`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import placed_product, reduced

from . import scope as _scope
from .afpm import AFPMConfig, chunked_emulated_matmul
from .registry import afpm_config, get_elementwise, get_multiplier

BACKENDS = ("auto", "hopper", "torch")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    mode: str = "exact"             # exact | emulated | segmented
    multiplier: str = "AC5-5"       # registry name, for emulated mode
    seg_passes: int = 3             # segmented mode: 1=ACL-like, 3=AC-like
    seg_n: int = 5                  # segment width for emulated AC modes
    backend: str = "auto"           # kernel backend: auto|hopper|torch
    compute_dtype: str = "bfloat16"  # exact-mode operand dtype
    accum_dtype: str = "float32"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}")

    def afpm(self) -> AFPMConfig:
        mode = "acl" if self.multiplier.lower().startswith("acl") else "ac"
        return AFPMConfig(n=self.seg_n, mode=mode)


EXACT = NumericsConfig(mode="exact")


# The calibration tap of repro_torch.core.sensitivity: while one is
# installed, nmatmul reports (full layer path, x, w) for every call site.
_OPERAND_TAP = None


def set_operand_tap(tap):
    """Install (``tap(path, x, w)``) or clear (``tap=None``) the call-site
    operand recorder; returns the previously installed tap so callers can
    restore it."""
    global _OPERAND_TAP
    prev = _OPERAND_TAP
    _OPERAND_TAP = tap
    return prev


def operand_tap_active() -> bool:
    """True while a calibration tap is installed: call sites that bypass
    nmatmul for exact numerics (the native conv) route through it then, so
    the pass records their operands."""
    return _OPERAND_TAP is not None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named by a config string (``bfloat16``, ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def nmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Numerics-aware matmul: ``x (..., K) @ w (K, N)`` under the ambient
    numerics scope.

    The config comes from the innermost ``numerics_scope`` (EXACT outside
    any scope).  A non-config ambient value is duck-typed as a policy and
    resolved per call site with ``amb.lookup(path)`` against the full path
    of the active ``layer_scope`` stack.  An installed operand tap sees
    ``(full path, x, w)`` first.  A placed product's partial sums (a
    contraction over a sharded dim) are reduced here, in the product's
    dtype (:func:`~repro_torch.distributed.sharding.reduced`), scattered
    over the sequence of a (B, S, N) product.  Where a placed product's
    operands are laid out, and whether it runs on each rank's rows, is
    :func:`~repro_torch.distributed.sharding.placed_product`'s choice.
    A product the plain route summed in fp64 (a serving step's,
    :func:`~repro_torch.kernels.dispatch.matmul`) is rounded to fp32
    here, after its partial sums are reduced.
    """
    if _OPERAND_TAP is not None:
        # a scoped-policy ambient carries a prefix: the tap sees the
        # absolute path, while resolution stays relative
        amb, rel = _scope.current_numerics(), _scope.current_path()
        _OPERAND_TAP(amb.full_path(rel) if hasattr(amb, "full_path") else rel,
                     x, w)
    cfg = _scope.resolve_here()
    out = placed_product(lambda a, b: _nmatmul(a, b, cfg), x, w)
    # a row-parallel product's partial sums scatter over the sequence of
    # a (B, S, N) output, where the residual stream is sharded next
    out = reduced(out, 1 if out.dim() >= 3 else None)
    # the plain route's fp64 sums, partial sums included, rounded once
    return out.to(torch.float32) if out.dtype == torch.float64 else out


def _nmatmul(x, w, cfg):
    if cfg.mode == "exact":
        cdt = torch_dtype(cfg.compute_dtype)
        adt = torch_dtype(cfg.accum_dtype)
        if (cdt, adt) == (torch.bfloat16, torch.float32):
            from repro_torch.kernels import dispatch  # lazy, as below

            return dispatch.matmul(x, w, 1, backend=cfg.backend)
        return torch.matmul(x.to(cdt).to(adt), w.to(cdt).to(adt))
    if cfg.mode == "segmented":
        from repro_torch.kernels import dispatch  # lazy: kernels import core

        return dispatch.matmul(x, w, cfg.seg_passes, backend=cfg.backend)
    if cfg.mode == "emulated":
        name = cfg.multiplier.lower()
        if name.startswith(("ac", "acl")) and not name.startswith("ac-"):
            from repro_torch.kernels import dispatch  # lazy: kernels import core

            return dispatch.emulated_matmul(x, w, cfg.afpm(),
                                            backend=cfg.backend)
        fmt_cfg = afpm_config(name)
        if fmt_cfg is not None:   # AC-<fmt>: its registered storage format
            from repro_torch.kernels import dispatch

            # detached: the registry's bit-level function has no gradient
            return dispatch.emulated_matmul(x.detach(), w.detach(), fmt_cfg,
                                            backend=cfg.backend)
        # generic registry multiplier: chunked elementwise matmul
        return chunked_emulated_matmul(x, w, get_multiplier(cfg.multiplier))
    raise ValueError(f"unknown numerics mode {cfg.mode!r}")


def apply_elementwise(x, y, multiplier: str, backend: str = "auto"):
    """Elementwise product under a named multiplier (image-processing path).

    AFPM-family multipliers route through the kernel substrate (the Hopper
    kernel for CUDA tensors); everything else runs its registered plain
    PyTorch function.
    """
    return get_elementwise(multiplier, backend=backend)(x, y)
