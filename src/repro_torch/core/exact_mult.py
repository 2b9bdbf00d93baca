"""Exact IEEE 754-compliant floating-point multiplier (paper §III-A).

The port's counterpart of ``repro.core.exact_mult``: the correctness-
preserving baseline of the paper -- sign XOR, exponent accumulation with
bias correction, full significand product, normalization, and
round-to-nearest ties-to-even with overflow/underflow handling.

* :func:`np_exact_mult_bits` -- bit-level numpy oracle (a copy of the
  reference's), generic over :class:`~repro_torch.core.formats.FloatFormat`
  (int64 headroom covers the 48-bit single-precision significand product).
* :func:`exact_mult_f32` -- device-side exact multiply.  On IEEE hardware
  (CPU and GPU fp32) the native multiply *is* the exact multiplier, so this
  is ``x * y`` in float32: the registry's "exact" entry, the paper's
  baseline row.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import (FP32, FloatFormat, np_bits_to_f32, np_decode, np_encode,
                      np_f32_to_bits)


def _normalize_subnormal(exp: np.ndarray, man: np.ndarray, fmt: FloatFormat):
    """Return (unbiased_exp, significand) for possibly-subnormal operands."""
    man = man.astype(np.int64)
    is_sub = exp == 0
    # normal: sig = 1.man, unbiased e = exp - bias
    sig_n = man | (1 << fmt.man_bits)
    e_n = exp.astype(np.int64) - fmt.bias
    # subnormal: 0.man * 2^(1-bias): renormalize by shifting the leading one
    # up to the hidden-bit position (shift = man_bits + 1 - bit_length(man)).
    blen = np.vectorize(lambda v: int(v).bit_length(), otypes=[np.int64])(man)
    shift = fmt.man_bits + 1 - blen
    sig_s = np.where(man > 0, man << np.maximum(shift, 0), 0)
    e_s = (1 - fmt.bias) - shift
    sig = np.where(is_sub, sig_s, sig_n)
    e = np.where(is_sub, e_s, e_n)
    return e, sig


def np_exact_mult_bits(xb: np.ndarray, yb: np.ndarray, fmt: FloatFormat = FP32) -> np.ndarray:
    """Multiply two ``fmt``-encoded integer arrays; return ``fmt``-encoded bits."""
    xb = np.asarray(xb, np.int64)
    yb = np.asarray(yb, np.int64)
    sx, ex, mx = np_decode(xb, fmt)
    sy, ey, my = np_decode(yb, fmt)
    s_res = sx ^ sy  # Eq. (2)

    x_zero = (ex == 0) & (mx == 0)
    y_zero = (ey == 0) & (my == 0)
    x_inf = (ex == fmt.max_exp_field) & (mx == 0)
    y_inf = (ey == fmt.max_exp_field) & (my == 0)
    x_nan = (ex == fmt.max_exp_field) & (mx != 0)
    y_nan = (ey == fmt.max_exp_field) & (my != 0)

    e_x, sig_x = _normalize_subnormal(ex, mx, fmt)
    e_y, sig_y = _normalize_subnormal(ey, my, fmt)

    # significand product: [2^(2m), 2^(2m+2)) for normal inputs  -- Eq. (4)
    prod = sig_x * sig_y  # fits int64 for man_bits <= 23 (48 bits)
    m = fmt.man_bits
    carry = prod >= (1 << (2 * m + 1))
    e_res = e_x + e_y + carry.astype(np.int64)  # Eq. (3) done in unbiased space
    # align so the hidden bit sits at position 2m (after optional carry shift)
    prod_n = np.where(carry, prod, prod << 1)  # hidden bit now at 2m+1
    # prod_n in [2^(2m+1), 2^(2m+2)); significand value = prod_n * 2^-(2m+1)

    ebiased = e_res + fmt.bias

    # gradual underflow: if ebiased < 1, shift right extra (1 - ebiased) bits
    extra = np.clip(1 - ebiased, 0, 2 * m + 3)
    shift_total = (m + 1) + extra  # bits to drop from prod_n to keep man_bits+1
    kept = prod_n >> shift_total
    # round to nearest, ties to even
    round_bit = (prod_n >> (shift_total - 1)) & 1
    sticky = (prod_n & ((1 << (shift_total - 1)) - 1)) != 0
    round_up = (round_bit == 1) & (sticky | ((kept & 1) == 1))
    kept = kept + round_up.astype(np.int64)
    # post-round renormalization
    re_carry = kept >= (1 << (m + 1))
    kept = np.where(re_carry, kept >> 1, kept)
    ebiased = np.where((extra == 0) & re_carry, ebiased + 1, ebiased)

    is_sub_res = extra > 0
    # subnormal result that rounded up into the normal range
    sub_to_norm = is_sub_res & (kept >= (1 << m))
    man_res = np.where(is_sub_res & ~sub_to_norm, kept, kept & ((1 << m) - 1))
    exp_res = np.where(is_sub_res, np.where(sub_to_norm, 1, 0), ebiased)

    # overflow to inf
    ovf = exp_res >= fmt.max_exp_field
    exp_res = np.where(ovf, fmt.max_exp_field, exp_res)
    man_res = np.where(ovf, 0, man_res)
    # total underflow to zero
    uvf = (is_sub_res & (kept == 0)) | (extra >= 2 * m + 3)
    exp_res = np.where(uvf, 0, exp_res)
    man_res = np.where(uvf, 0, man_res)

    out = np_encode(s_res, exp_res, man_res, fmt)

    # special values
    zero_out = np_encode(s_res, 0, 0, fmt)
    inf_out = np_encode(s_res, fmt.max_exp_field, 0, fmt)
    nan_out = np_encode(0, fmt.max_exp_field, 1 << (m - 1), fmt)
    out = np.where(x_zero | y_zero, zero_out, out)
    out = np.where(x_inf | y_inf, inf_out, out)
    out = np.where((x_inf & y_zero) | (y_inf & x_zero), nan_out, out)
    out = np.where(x_nan | y_nan, nan_out, out)
    return out


def np_exact_mult_f32(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bit-exact fp32 multiply through the oracle datapath (returns float32)."""
    return np_bits_to_f32(np_exact_mult_bits(np_f32_to_bits(x), np_f32_to_bits(y), FP32))


def exact_mult_f32(x, y) -> torch.Tensor:
    """Device-side exact IEEE754 fp32 multiply = the hardware multiplier."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x * torch.as_tensor(y, dtype=torch.float32, device=x.device)
