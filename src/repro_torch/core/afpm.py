"""Mantissa-segmentation approximate floating-point multiplier (paper §III-B).

The port's counterpart of ``repro.core.afpm``: the paper's AC-n-n and
ACL-n designs, bit for bit, as plain PyTorch ops.

* the explicit mantissa is segmented into a high part ``A`` (top ``n``
  bits) and a low part ``B`` (next ``n`` bits); lower bits are truncated
  (Eq. 5);
* partial products: ``AC`` always exact; ``AD``/``BC`` conditionally
  executed -- bypassed when the low-segment operand (``D`` resp. ``B``)
  has its upper ``n-2`` bits all zero, with a shift-based compensation
  ``A<<1`` / ``C<<1`` when the bypassed operand is non-zero;
* special cases: ``A==0 & B,C!=0`` forces ``BC``; ``C==0 & A,D!=0``
  forces ``AD``;
* the ``BD`` partial product is always omitted (Eq. 6);
* shift-and-add accumulation into a ``3n``-fractional-bit accumulator;
  the linear terms ``1 + Mx + My`` use the mantissas truncated to their
  upper ``3n`` bits (Fig. 3);
* normalization decided by the two integer bits of the accumulator
  (product in ``[1, 4)``), mantissa zero-padded back to the format width.

The ``ACL-n`` low-precision mode replaces the mantissa-product term with
the bitwise-AND first-order approximation ``A_x + A_y + (A_x & A_y)`` at
weight ``2^-n`` with an ``n``-bit accumulator.

Approximate modes flush subnormal inputs/outputs to zero and propagate
inf/nan IEEE-style.  The datapath is the reference's uint32 one, carried
in int64 lanes masked to 32 bits (see :mod:`repro_torch.core.formats`):
each value is masked before it is shifted right or compared, which is
where a wrapped uint32 and an unmasked int64 would part.  The result is
assembled as bits, so a NaN comes out as ``0x7fc00000``, the reference's
``jnp.nan``.

This is the plain version of the Hopper kernel
``repro_torch/kernels/csrc/afpm_bitwise.cu`` (its elementwise and its
emulated-matmul entry); the kernel's wrapper takes it for CPU tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from .formats import U32, FloatFormat, bits_to_f32, f32_to_bits, get_format

_INF = 0x7F800000
_NAN = 0x7FC00000


def _decode(x: torch.Tensor, fmt: FloatFormat):
    """float32 -> (sign, biased exp field, mantissa field aligned to fmt.man_bits)."""
    bits = f32_to_bits(x)
    man32 = bits & ((1 << 23) - 1)
    exp32 = (bits >> 23) & 0xFF
    sign = bits >> 31
    if fmt.man_bits == 23 and fmt.exp_bits == 8:
        return sign, exp32, man32
    # operate in the narrower storage format: truncate mantissa, rebias exp
    man = man32 >> (23 - fmt.man_bits)
    exp = torch.clamp(exp32 - 127 + fmt.bias, 0, fmt.max_exp_field)
    # flush values outside fmt's normal range (approx path flushes subnormals)
    man = torch.where((exp == 0) | (exp == fmt.max_exp_field), 0, man)
    # preserve inf/nan class from fp32
    exp = torch.where(exp32 == 255, fmt.max_exp_field, exp)
    man = torch.where((exp32 == 255) & (man32 != 0), 1, man)
    return sign, exp, man


def _encode_bits(sign, e_unb, man_fmt, fmt: FloatFormat) -> torch.Tensor:
    """(sign, unbiased exp, fmt-width mantissa) -> float32 bits (int64),
    wrapping as the reference's uint32 does for an out-of-range exponent
    (those lanes are overwritten by the exception rules)."""
    man32 = (man_fmt << (23 - fmt.man_bits)) & U32
    exp32 = (e_unb + 127) & U32
    return (sign << 31) | ((exp32 << 23) & U32) | man32


@dataclasses.dataclass(frozen=True)
class AFPMConfig:
    """Configuration knob exposed to the compiler flow (paper §III-B)."""

    n: int = 5                 # segment width
    mode: str = "ac"           # "ac" (AC-n-n) or "acl" (low-precision mode)
    fmt: str = "fp32"          # storage format name (fp32/bf16/fp16/afp24/...)
    skip_bd: bool = True       # paper: BD always omitted (kept as a knob for ablation)
    conditional: bool = True   # conditional execution of AD/BC
    compensation: bool = True  # shift-based compensation of bypassed terms

    @property
    def label(self) -> str:
        if self.mode == "acl":
            return f"ACL{self.n}"
        return f"AC{self.n}-{self.n}"

    def format(self) -> FloatFormat:
        return get_format(self.fmt)


def check_config(cfg: AFPMConfig) -> FloatFormat:
    """The storage format of ``cfg``; raises ``ValueError`` for a config the
    datapath cannot run (the reference raises the same, the negative
    segment width through Python's negative shift count)."""
    fmt = cfg.format()
    n, M = cfg.n, fmt.man_bits
    if cfg.mode not in ("ac", "acl"):
        raise ValueError(f"unknown AFPM mode {cfg.mode!r}")
    if cfg.mode == "ac" and M < 2 * n:
        raise ValueError(f"mantissa of {fmt.name} too narrow for 2 segments of n={n}")
    if cfg.mode == "acl" and M < n:
        raise ValueError(f"mantissa of {fmt.name} too narrow for n={n}")
    if n < 0:
        raise ValueError(f"negative segment width n={n}")
    return fmt


def _ac_mantissa_product(mx, my, n: int, M: int, cfg: AFPMConfig):
    """Approximate cross term ``Mx*My`` in units of ``2^-3n`` (uint32 pattern).

    ``mx``/``my`` are the explicit mantissa fields (width ``M``).
    Returns an integer ``cross`` such that ``Mx*My ~= cross * 2^-3n``.
    """
    # segments (Eq. 5): A/C = top n bits, B/D = next n bits
    A = mx >> (M - n)
    B = (mx >> max(M - 2 * n, 0)) & ((1 << n) - 1)
    C = my >> (M - n)
    D = (my >> max(M - 2 * n, 0)) & ((1 << n) - 1)

    AC = A * C
    AD = A * D
    BC = B * C
    BD = B * D

    if cfg.conditional:
        # bypass when the upper (n-2) bits of the low operand are all zero
        d_small = (D >> 2) == 0
        b_small = (B >> 2) == 0
        # special-case forcing (paper): A==0 & B,C!=0 -> force BC;
        #                               C==0 & A,D!=0 -> force AD
        force_ad = (C == 0) & (A != 0) & (D != 0)
        force_bc = (A == 0) & (C != 0) & (B != 0)
        exec_ad = ~d_small | force_ad
        exec_bc = ~b_small | force_bc
        if cfg.compensation:
            # bypassed multiply ~ operand approximated by the constant 2 -> A<<1
            comp_ad = torch.where((A != 0) & (D != 0), A << 1, 0)
            comp_bc = torch.where((C != 0) & (B != 0), C << 1, 0)
        else:
            comp_ad = comp_bc = torch.zeros_like(AD)
        ad_term = torch.where(exec_ad, AD, comp_ad)
        bc_term = torch.where(exec_bc, BC, comp_bc)
    else:
        ad_term, bc_term = AD, BC

    cross = ((AC << n) + ad_term + bc_term) & U32
    if not cfg.skip_bd:
        cross = (cross + (BD >> n)) & U32  # BD sits n bits below the accumulator lsb
    return cross


def afpm_mult_f32(x, y, cfg: AFPMConfig) -> torch.Tensor:
    """Elementwise approximate multiply, bit-faithful to the paper's datapath.

    Operates on float32 carriers (broadcasting); if ``cfg.fmt`` is narrower
    the operands are first truncated into that storage format (the CiM
    array stores them at that width).
    """
    fmt = check_config(cfg)
    n, M = cfg.n, fmt.man_bits
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    sx, ex, mx = _decode(x, fmt)
    sy, ey, my = _decode(y, fmt)
    s_res = sx ^ sy

    if cfg.mode == "ac":
        T = min(3 * n, M)  # accumulator fractional width (3n, clipped to mantissa)
        U = 1 << T
        cross = _ac_mantissa_product(mx, my, n, M, cfg)
        cross_t = (cross >> (3 * n - T) if 3 * n > T
                   else (cross << (T - 3 * n)) & U32)
        # linear terms use mantissas truncated to their upper 3n bits (Fig. 3)
        mx_t = mx >> (M - T)
        my_t = my >> (M - T)
        acc = (U + mx_t + my_t + cross_t) & U32  # (1 + Mx)(1 + My), 2^-T units
    else:  # ACL-n: partial sum = A_x + A_y + (A_x & A_y), n-bit accumulator
        T = n
        U = 1 << T
        A = mx >> (M - n)
        Cseg = my >> (M - n)
        acc = U + A + Cseg + (A & Cseg)

    # normalization from the two integer bits of the accumulator (prod in [1,4))
    ge2 = acc >= (U << 1)
    acc_n = torch.where(ge2, acc >> 1, acc)  # in [U, 2U)
    man_acc = (acc_n - U) & U32  # T fractional bits
    # zero-padded back to the format mantissa width (T <= M always here)
    man_res = (man_acc << (M - T)) & U32

    e_unb = ex - fmt.bias + ey - fmt.bias + ge2.to(torch.int64)
    res = _encode_bits(s_res, e_unb, man_res, fmt)

    # exception handling (overflow -> inf, underflow -> 0; paper §III-A rules)
    e_min = 1 - fmt.bias
    e_max = fmt.max_exp_field - 1 - fmt.bias
    signed_zero = s_res << 31
    signed_inf = signed_zero | _INF
    res = torch.where(e_unb > e_max, signed_inf, res)
    res = torch.where(e_unb < e_min, signed_zero, res)

    # special operands: zero/subnormal-flush, inf, nan (classed on the fp32
    # carriers, as the reference's isfinite/isinf/isnan do)
    xa = f32_to_bits(x) & 0x7FFFFFFF
    ya = f32_to_bits(y) & 0x7FFFFFFF
    x_fin, y_fin = xa < _INF, ya < _INF
    inf_in = (xa == _INF) | (ya == _INF)
    any_zero = (ex == 0) | (ey == 0)  # true zero or flushed subnormal
    res = torch.where(any_zero & x_fin & y_fin, signed_zero, res)
    res = torch.where(inf_in, signed_inf, res)
    res = torch.where((xa > _INF) | (ya > _INF) | (inf_in & any_zero), _NAN, res)
    return bits_to_f32(res)


# -- straight-through estimator wrapper (lets emulated numerics live in -----
# -- a training graph: forward = AFPM, backward = exact product rule) -------

class _AFPMSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, cfg):
        ctx.save_for_backward(x, y)
        return afpm_mult_f32(x, y, cfg)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = (g * y).sum_to_size(x.shape) if ctx.needs_input_grad[0] else None
        gy = (g * x).sum_to_size(y.shape) if ctx.needs_input_grad[1] else None
        return gx, gy, None


def afpm_mult_ste(x, y, cfg: AFPMConfig) -> torch.Tensor:
    """AFPM forward, exact product-rule backward (straight-through)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    return _AFPMSte.apply(x, y, cfg)


def afpm_matmul_emulated(x, w, cfg: AFPMConfig, k_chunk: int = 64) -> torch.Tensor:
    """Matmul where every scalar product goes through the bit-level AFPM.

    Memory-bounded by chunking the contraction axis: per chunk the
    elementwise products ``x[..., k] * w[k, :]`` are materialized as a
    ``(..., k_chunk, N)`` block and summed in fp32.  This is the
    paper-faithful semantics for Tables III/IV (accumulation in the CiM
    macro is exact; only the multipliers are approximate).

    The plain version of the emulated-matmul kernel
    (``repro_torch/kernels/afpm_bitwise.py::emulated_matmul``), which
    ``kernels.dispatch.emulated_matmul`` takes on the card.
    """
    return chunked_emulated_matmul(
        x, w, lambda a, b: afpm_mult_ste(a, b, cfg), k_chunk)


def chunked_emulated_matmul(x, w, mult, k_chunk: int = 64) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` with every product from ``mult``, summed
    in fp32 chunk by chunk over ``K`` (zero-padded to ``k_chunk``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    K = x.shape[-1]
    if w.shape[0] != K:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    pad = (-K) % k_chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    out = torch.zeros(x.shape[:-1] + w.shape[-1:], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, K + pad, k_chunk):
        xk = x[..., k0:k0 + k_chunk]          # (..., k_chunk)
        wk = w[k0:k0 + k_chunk]               # (k_chunk, N)
        out = out + mult(xk[..., :, None], wk).sum(dim=-2)
    return out
