"""Gradients of the segmented matmul (K1), the emulated AFPM matmul (K2's
matmul entry) and the SSD scan (K3): the backwards of their custom ops
(:mod:`.custom_ops`).

The JAX package has no backward kernel: ``jax.grad`` differentiates its
plain references (``repro.kernels.ref.afpm_matmul_ref``,
``repro.core.afpm.afpm_matmul_emulated`` with its straight-through
``custom_jvp``, ``ssd_scan_chunked_ref``) with XLA ops.  Each op runs the
hand-written kernel forward, unchanged (its wrapper takes the plain
version only for CPU tensors), and each function here computes what that
``jax.grad`` computes from the op's saved inputs and the cotangent.  The
backwards are plain PyTorch by design: they are the counterpart of XLA's
autodiff of the references, not ports of a TPU kernel.
"""
from __future__ import annotations

import torch

from . import ref


def _bf16_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A sum of two bf16 cotangents, rounded to bf16 as JAX adds them."""
    return (a.to(torch.float32) + b.to(torch.float32)).to(torch.bfloat16)


def _seg_grad(p: torch.Tensor, q: torch.Tensor, r, passes: int,
              lo_passes: int) -> torch.Tensor:
    """One operand's cotangent under ``jax.grad`` of the reference.

    ``p`` is its bf16-rounded product with the hi segment of the other
    operand (``g @ hi(w)^T`` or ``hi(x)^T @ g``), ``r`` with the other
    operand's lo segment, taken at ``passes >= lo_passes`` only.  In the
    reference's jaxpr every product's cotangent is rounded to bf16, the
    hi segment's cotangents add in bf16, and ``lo = bf16(x - f32(hi))``
    passes its cotangent ``c`` to ``x`` directly and ``-c`` to ``hi``;
    ``q`` is that ``c`` (the cotangent of this operand's own lo segment,
    bf16) or None where the reference drops the segment."""
    hi = p if r is None or passes < lo_passes else _bf16_add(r, p)
    if q is None:
        return hi.to(torch.float32)
    qf = q.to(torch.float32)
    return qf + _bf16_add(hi, (-qf).to(torch.bfloat16)).to(torch.float32)


def segmented_matmul_grads(x, w, passes: int, g, needs=(True, True)):
    """``(dx, dw)`` of ``x (..., K) @ w (K, N)`` through K1 (None where
    ``needs`` says no): ``jax.grad`` of ``afpm_matmul_ref``.

    With ``A = bf16(hi(x)^T g)``, ``B = bf16(lo(x)^T g)``, ``Z = bf16(g
    hi(w)^T)`` and ``U = bf16(g lo(w)^T)`` (fp32 products of the bf16
    segments), the reference's jaxpr gives

    - passes 1: ``dx = Z``, ``dw = A``;
    - passes 2: ``dx = Z`` (``Z + bf16(-Z) = 0``), ``dw = bf16(B + A)``;
    - passes 3: ``dx = Z + bf16(bf16(U + Z) - Z)``,
      ``dw = A + bf16(bf16(B + A) - A)``;

    every sum in fp32 unless marked.  ``dx`` is returned in ``x``'s dtype
    (a bf16 ``x`` rounds it, as the reference's input cast does)."""
    f, bf = torch.float32, torch.bfloat16
    g = g.to(f)
    K, N = w.shape
    xh, xl = ref.split_hi_lo_ref(x, needs[1] and passes >= 2)
    wh, wl = ref.split_hi_lo_ref(w, needs[0] and passes >= 3)
    dx = dw = None
    if needs[0]:
        Z = torch.matmul(g, wh.to(f).T).to(bf)
        U = (torch.matmul(g, wl.to(f).T).to(bf) if passes >= 3 else None)
        # x's own lo segment gets Z at passes >= 2
        dx = _seg_grad(Z, Z if passes >= 2 else None, U, passes, 3)
        dx = dx.to(x.dtype)
    if needs[1]:
        g2 = g.reshape(-1, N)
        A = torch.matmul(xh.reshape(-1, K).to(f).T, g2).to(bf)
        B = (torch.matmul(xl.reshape(-1, K).to(f).T, g2).to(bf)
             if passes >= 2 else None)
        # w's lo segment gets A at passes 3
        dw = _seg_grad(A, A if passes >= 3 else None, B, passes, 2)
    return dx, dw


class PlainSegmentedMatmul(torch.autograd.Function):
    """K1's plain version (``ref.afpm_matmul_ref``) with K1's backward
    (:func:`segmented_matmul_grads`): the plain route under autograd.
    PyTorch's autograd of the plain version would run six products where
    ``jax.grad`` of the reference and the kernel route run four (the
    products of the cotangent with ``hi(w)`` and ``hi(x)`` serve both
    segments)."""

    @staticmethod
    def forward(ctx, x, w, passes: int, sums=torch.float32):
        ctx.save_for_backward(x, w)
        ctx.passes = passes
        return ref.afpm_matmul_ref(x, w, passes, sums)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = segmented_matmul_grads(x, w, ctx.passes, g,
                                        ctx.needs_input_grad[:2])
        return dx, dw, None, None


def emulated_matmul_grads(x, w, g, needs=(True, True)):
    """``(dx, dw)`` of ``x (..., K) @ w (K, N)`` through K2's emulated
    matmul: the straight-through product rule of the reference's
    ``afpm_mult_ste`` (every AFPM product differentiated as an exact one),
    ``dx = g @ w^T`` and ``dw = x^T @ g``, fp32 matmuls (TF32 off, as the
    port's entry points set it)."""
    g = g.to(torch.float32)
    dx = dw = None
    if needs[0]:
        dx = torch.matmul(g, w.T)
    if needs[1]:
        K, N = w.shape
        dw = torch.matmul(x.reshape(-1, K).T, g.reshape(-1, N))
    return dx, dw


def ssd_grads(saved, chunk: int, g, needs):
    """The cotangents of the SSD scan's five inputs ``saved`` = ``(x, dt,
    A, B, C)`` (None where ``needs`` says no): ``jax.grad`` of
    ``ssd_scan_chunked_ref``.  The plain chunked version is recomputed
    from the saved inputs under autograd and differentiated: the exact
    counterpart of XLA's autodiff of the reference, plain PyTorch by
    design."""
    ins = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
    want = [t for t in ins if t.requires_grad]
    with torch.enable_grad():
        y = ref.ssd_scan_chunked_ref(*ins, chunk)
        grads = iter(torch.autograd.grad(y, want, g))
    return tuple(next(grads) if t.requires_grad else None for t in ins)
