"""Backend dispatch for the kernel substrate.

One audited entry point per kernel (``matmul`` for the segmented matmul,
``multiply`` for the bit-level AFPM multiply, ``emulated_matmul`` for the
matmul whose every product is that multiply, ``ssd`` for the SSD chunked
scan), each with a ``backend`` knob
(``repro_torch.core.numerics.NumericsConfig.backend``):

  ``auto``    the Hopper kernel for CUDA tensors, the plain version for CPU
  ``hopper``  the Hopper kernel; a CPU tensor raises
  ``torch``   the plain PyTorch version (``ref.afpm_matmul_ref``,
              ``ref.afpm_bitwise_ref``, ``core.afpm.afpm_matmul_emulated``,
              ``ref.ssd_scan_chunked_ref``), on either device

Each kernel's launch shape comes from the active tuning table
(:mod:`.autotune`) where it has an entry for the operand's device kind,
else from the static rule; ``matmul(tile=)``, ``multiply(block=)`` and
``ssd(chunk=)`` take one explicitly (what a tuner's ``measure_fn`` times).

The kernel route calls each kernel through its custom op
(:mod:`.custom_ops`) where an operand is a DTensor (which the op's rules
shard) or autograd records the call, and through its wrapper directly
otherwise.  Under
autograd the kernel route of ``matmul``, ``emulated_matmul`` and ``ssd``
is differentiable (:mod:`.autograd`): the forward is still the kernel,
and the backward computes what ``jax.grad`` of the JAX package's
reference computes.  The plain route of ``matmul`` at two or three
passes takes the same backward (:class:`.autograd.PlainSegmentedMatmul`:
four products, as ``jax.grad`` runs, where PyTorch's autograd of the
plain version would run six); at one pass (the exact tier's product) and
on the other plain routes PyTorch's autograd differentiates the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.core.afpm import AFPMConfig, afpm_matmul_emulated
from repro_torch.core.numerics import BACKENDS
from repro_torch.core.scope import fp64_sums_on
from repro_torch.distributed.sharding import current_mesh_rules

from . import autograd, autotune, custom_ops, ref
from .autotune import shape_bucket


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """Resolve a backend request for operand ``x`` to ``hopper | torch``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "hopper" if x.is_cuda else "torch"
    if backend == "hopper" and not x.is_cuda:
        raise ValueError("backend='hopper' needs CUDA tensors; use 'torch' "
                         "(or 'auto') for CPU tensors")
    return backend


# Static SSD chunk table, the JAX package's: ``hopper`` takes its ``pallas``
# rows and ``torch`` its ``xla`` rows; a tuned table's ``ssd`` entries come
# first.
SCAN_CHUNKS = {
    ("hopper", "small"): 128,
    ("hopper", "medium"): 128,
    ("hopper", "large"): 256,
    ("torch", "small"): 128,
    ("torch", "medium"): 128,
    ("torch", "large"): 256,
}


def scan_chunk(backend: str, L: int, device=None) -> int:
    """The SSD chunk for a resolved backend (``hopper | torch``), sequence
    length ``L`` and the operands' ``device``: the active tuning table's,
    else :data:`SCAN_CHUNKS`."""
    bucket = shape_bucket(L)
    tuned = autotune.lookup("ssd", backend, bucket, device)
    return tuned if tuned is not None else SCAN_CHUNKS[(backend, bucket)]


def _plain_sums(x: torch.Tensor) -> torch.dtype:
    """The dtype the segmented matmul's plain version sums in: fp64 under
    :func:`~repro_torch.core.scope.fp64_sums` (a serving step), where every
    segment product and its sum are exact, so that a product's bits depend
    neither on how many rows a call has nor on how its contraction or its
    output is split over ranks; else fp32.  Meta blocks over CUDA ranks
    (the dry-run's count of a card's placed step) stand in for the
    kernel's fp32 sums; an unplaced count has no ranks to say which device
    it stands for and sums as the CPU does."""
    if not fp64_sums_on():
        return torch.float32
    state = current_mesh_rules()
    dmesh = getattr(state[0], "device_mesh", None) if state else None
    if x.is_meta and dmesh is not None and dmesh.device_type == "cuda":
        return torch.float32
    return torch.float64


def matmul(x: torch.Tensor, w: torch.Tensor, passes: int = 3, *,
           backend: str = "auto", tile=None) -> torch.Tensor:
    """Segmented approximate matmul ``x (..., K) @ w (K, N)`` -> fp32.

    Validation and 1-D promotion happen here, before the backend branch,
    so every backend accepts the same inputs; leading batch dims of ``x``
    are kept (the kernel flattens them into its rows).  ``tile`` is the
    kernel's (:func:`.afpm_matmul.plan`); the plain version takes none.
    The plain version sums as :func:`_plain_sums` says: a serving step's
    products in fp64, returned in fp64 for the caller to round once,
    after a placed product's partial sums are reduced.  The kernel sums
    in fp32."""
    backend = resolve_backend(backend, x)
    if x.dim() < 1 or w.dim() != 2:
        raise ValueError(f"need x (..., K) @ w (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    vec = x.dim() == 1
    if vec:
        x = x[None, :]
    if backend == "torch" and passes == 1:
        # one product: PyTorch's autograd of it runs jax.grad's two, and a
        # checkpointed block's recompute may stop before it
        out = ref.afpm_matmul_ref(x, w, 1, _plain_sums(x))
    elif backend == "torch":
        out = autograd.PlainSegmentedMatmul.apply(x, w, passes,
                                                  _plain_sums(x))
    else:
        out = custom_ops.segmented_matmul(x.contiguous(), w.contiguous(),
                                        passes, tile)
    return out[0] if vec else out


def _as_operand(t, device) -> torch.Tensor:
    """``t`` as an fp32 tensor; a Python number or a 0-d CPU tensor joins
    the other operand's device, as PyTorch's own scalar rule allows."""
    if not isinstance(t, torch.Tensor) or (t.dim() == 0 and t.device.type == "cpu"):
        return torch.as_tensor(t, dtype=torch.float32, device=device)
    return t.to(torch.float32)


def multiply(x, y, cfg: AFPMConfig = AFPMConfig(), *,
             backend: str = "auto", block=None) -> torch.Tensor:
    """Elementwise bit-level AFPM multiply under ``cfg`` -> fp32.

    Operands are broadcast first (a 0-d scalar included), so every backend
    takes the same inputs; the kernel itself needs equal shapes.
    ``block`` is the kernel's CTA shape (:func:`.afpm_bitwise.launch_block`)."""
    tensors = [t for t in (x, y) if isinstance(t, torch.Tensor)]
    shaped = [t for t in tensors if t.dim() > 0] or tensors
    dev = shaped[0].device if shaped else torch.device("cpu")
    x, y = torch.broadcast_tensors(_as_operand(x, dev), _as_operand(y, dev))
    backend = resolve_backend(backend, x)
    if backend == "torch":
        return ref.afpm_bitwise_ref(x, y, cfg)
    return custom_ops.bitwise(x.contiguous(), y.contiguous(), cfg, block)


def emulated_matmul(x, w, cfg: AFPMConfig = AFPMConfig(), k_chunk: int = 64,
                    *, backend: str = "auto") -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` -> fp32 with every product the bit-level
    AFPM multiply under ``cfg``, summed in fp32 chunk by chunk over K
    (``k_chunk`` products a chunk).

    Validation happens here, before the backend branch, so every backend
    accepts the same inputs; leading dims of ``x`` are kept (the kernel
    flattens them into its rows)."""
    backend = resolve_backend(backend, x)
    if x.dim() < 1 or w.dim() != 2:
        raise ValueError(f"need x (..., K) @ w (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if backend == "torch":
        return afpm_matmul_emulated(x, w, cfg, k_chunk)
    return custom_ops.emulated_matmul(x.to(torch.float32).contiguous(),
                                      w.to(torch.float32).contiguous(), cfg,
                                      k_chunk)


def ssd(x, dt, A, B, C, *, chunk=None, backend: str = "auto") -> torch.Tensor:
    """Mamba2 SSD chunked scan ``(L,H,P),(L,H),(H,),(L,N),(L,N) -> (L,H,P)``
    fp32, with an optional leading batch dimension on ``x``, ``dt``, ``B``
    and ``C``.

    ``chunk=None`` takes :func:`scan_chunk` for the resolved backend and
    the operands' device.  Any
    length is accepted: with ``Q = min(chunk, L)``, a length that is not a
    multiple of ``Q`` is padded with dt = 0 steps (exact: no decay
    increment and no input weight), and the padding is sliced off after.
    """
    backend = resolve_backend(backend, x)
    f = torch.float32
    x, dt, A, B, C = (t.to(f) for t in (x, dt, A, B, C))
    vec = x.dim() == 3
    if vec:
        x, dt, B, C = x[None], dt[None], B[None], C[None]
    L = x.shape[1]
    if chunk is None:
        chunk = scan_chunk(backend, L, x.device)
    Q = min(chunk, L) if L else chunk
    pad = (-L) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                    for t in (dt, B, C))
    if backend == "torch":
        out = ref.ssd_scan_chunked_ref(x, dt, A, B, C, Q)
    else:
        out = custom_ops.ssd(x, dt, A, B, C, Q)
    if pad:
        out = out[:, :L]
    return out[0] if vec else out
