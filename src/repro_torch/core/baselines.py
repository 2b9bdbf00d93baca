"""Baseline approximate FP multipliers the paper compares against (§II, Tables II-IV).

The port's counterpart of ``repro.core.baselines``, bit for bit:

* **MMBS-k** (Li et al., TENCON 2020) -- mantissa-bit-segmentation: both
  explicit mantissas cut to their top ``k`` bits with a half-ULP
  compensation constant; the cross product is exact on the k-bit segments
  and the linear terms stay exact.
* **CSS-m** (Di Meo et al., Electronics 2022) -- static segmentation: the
  significand product on two balanced static segments of ``m/2 + 2`` bits
  per operand with an LSB ``1`` compensation term.
* **NC / LPC / HPC** (Li et al., TCAS-II 2024) -- Mitchell logarithmic
  multiplier with no / low-precision / high-precision error compensation.

All of them share the exact sign/exponent path and the paper's exception
rules (overflow to inf, underflow/subnormal flush to zero).  Like
:mod:`repro_torch.core.afpm` they run the reference's uint32 datapath in
int64 lanes masked to 32 bits and assemble the result as bits.
"""
from __future__ import annotations

import dataclasses

import torch

from .formats import U32, bits_to_f32, decode_f32, f32_to_bits

_INF = 0x7F800000
_NAN = 0x7FC00000


def _operands(x, y):
    x = torch.as_tensor(x, dtype=torch.float32)
    return x, torch.as_tensor(y, dtype=torch.float32, device=x.device)


def _assemble(sign, e_unb, man23, x, y, ex, ey):
    """Shared exception handling + assembly for all baselines (fp32)."""
    exp32 = (e_unb + 127) & U32
    res = (sign << 31) | ((exp32 << 23) & U32) | (man23 & U32)
    signed_zero = sign << 31
    signed_inf = signed_zero | _INF
    res = torch.where(e_unb > 127, signed_inf, res)
    res = torch.where(e_unb < -126, signed_zero, res)
    xa = f32_to_bits(x) & 0x7FFFFFFF
    ya = f32_to_bits(y) & 0x7FFFFFFF
    zero_in = (ex == 0) | (ey == 0)
    res = torch.where(zero_in & (xa < _INF) & (ya < _INF), signed_zero, res)
    inf_in = (xa == _INF) | (ya == _INF)
    res = torch.where(inf_in, signed_inf, res)
    res = torch.where((xa > _INF) | (ya > _INF) | (inf_in & zero_in), _NAN, res)
    return bits_to_f32(res)


def _norm_from_frac(frac_num, frac_den_log2):
    """Normalize ``1+Mx+My+P`` style sums: value = frac_num * 2^-frac_den_log2 in [1,4)."""
    U = 1 << frac_den_log2
    ge2 = frac_num >= (U << 1)
    acc = (torch.where(ge2, frac_num >> 1, frac_num) - U) & U32
    return ge2.to(torch.int64), acc


# ---------------------------------------------------------------------------
# MMBS-k
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MMBSConfig:
    k: int = 6

    @property
    def label(self) -> str:
        return f"MMBS{self.k}"


def mmbs_mult_f32(x, y, cfg: MMBSConfig) -> torch.Tensor:
    k = cfg.k
    x, y = _operands(x, y)
    sx, ex, mx = decode_f32(x)
    sy, ey, my = decode_f32(y)
    s_res = sx ^ sy

    # top-k segments with half-ULP (in segment units: +0.5 -> fixed-point x2)
    A = mx >> (23 - k)
    C = my >> (23 - k)
    # cross product on compensated segments: (A+0.5)(C+0.5) in 2^-2k units
    # = AC + (A+C)/2 + 0.25  -> scale x4 to stay integral: 4AC + 2(A+C) + 1
    cross4 = (((A * C) << 2) + ((A + C) << 1) + 1) & U32  # units 2^-(2k+2)
    T = min(2 * k + 2, 23)
    mx_t = mx >> (23 - T)
    my_t = my >> (23 - T)
    acc = ((1 << T) + mx_t + my_t + (cross4 >> (2 * k + 2 - T))) & U32
    inc, man_acc = _norm_from_frac(acc, T)
    man_res = (man_acc << (23 - T)) & U32
    e_unb = ex - 127 + ey - 127 + inc
    return _assemble(s_res, e_unb, man_res, x, y, ex, ey)


# ---------------------------------------------------------------------------
# CSS-m
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSSConfig:
    m: int = 16  # total static-segment bits (m/2 per operand)

    @property
    def label(self) -> str:
        return f"CSS{self.m}"


def css_mult_f32(x, y, cfg: CSSConfig) -> torch.Tensor:
    # per-operand static segment width is m//2 + 2 significand bits (hidden
    # bit included) with a half-ULP compensation term, as in the reference
    s = cfg.m // 2 + 2
    x, y = _operands(x, y)
    sx, ex, mx = decode_f32(x)
    sy, ey, my = decode_f32(y)
    s_res = sx ^ sy

    sig_x = mx | (1 << 23)  # 24-bit significand 1.M
    sig_y = my | (1 << 23)
    A = sig_x >> (24 - s)  # top s bits, MSB=1 (static segment)
    C = sig_y >> (24 - s)
    # half-ULP compensated product: (A+.5)(C+.5) -> (2A+1)(2C+1) / 2^(2s)
    prod = (((A << 1) + 1) * ((C << 1) + 1)) & U32  # units 2^-2s
    inc, man_acc = _norm_from_frac(prod, 2 * s)
    T = min(2 * s, 23)
    man_res = ((man_acc >> max(2 * s - T, 0)) << (23 - T)) & U32
    e_unb = ex - 127 + ey - 127 + inc
    return _assemble(s_res, e_unb, man_res, x, y, ex, ey)


# ---------------------------------------------------------------------------
# NC / LPC / HPC (logarithmic, Mitchell-based)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LogConfig:
    comp: str = "nc"  # "nc" | "lpc" | "hpc"

    @property
    def label(self) -> str:
        return self.comp.upper()


def log_mult_f32(x, y, cfg: LogConfig) -> torch.Tensor:
    x, y = _operands(x, y)
    sx, ex, mx = decode_f32(x)
    sy, ey, my = decode_f32(y)
    s_res = sx ^ sy

    # Mitchell antilog: value = 2^(ex+ey) * (1 + L) for L < 1,
    #                   value = 2^(ex+ey+1) * (1 + (L-1)) for L >= 1
    # (the fraction is NOT halved in the carry case -- that is what makes
    # Mitchell's error one-sided in [-11.1%, 0]).
    U = 1 << 23
    L = mx + my  # units 2^-23, in [0, 2)
    carry = L >= U
    if cfg.comp == "nc":
        comp = torch.zeros_like(L)
    elif cfg.comp == "lpc":
        # low-precision: the optimal constant E[err] = 1/12 in both regions
        comp = torch.full_like(L, (1 << 23) // 12)
    elif cfg.comp == "hpc":
        # high-precision: half-ULP-compensated 3x3 product of the top
        # mantissa bits (complemented in the carry region)
        hx = torch.where(carry, ((U32 ^ mx) & (U - 1)) >> 20, mx >> 20)
        hy = torch.where(carry, ((U32 ^ my) & (U - 1)) >> 20, my >> 20)
        comp = (((hx << 1) + 1) * ((hy << 1) + 1)) << 15  # units 2^-23
    else:
        raise ValueError(cfg.comp)
    # in the carry region the result is renormalized by 2^1, so the error
    # (1-mx)(1-my) appears halved at the output mantissa scale
    comp = torch.where(carry, comp >> 1, comp)
    acc = torch.where(carry, L - U, L) + comp
    # compensation may push the fraction past 1.0 -- a true significand
    # overflow (unlike Mitchell's antilog carry), so the fraction halves
    acc_ovf = acc >= U
    man_acc = torch.where(acc_ovf, (acc - U) >> 1, acc)
    inc = carry.to(torch.int64) + acc_ovf.to(torch.int64)
    e_unb = ex - 127 + ey - 127 + inc
    return _assemble(s_res, e_unb, man_acc, x, y, ex, ey)
