"""Floating-point format descriptions and bit-level encode/decode helpers.

The port's counterpart of ``repro.core.formats``.  A format is a (sign,
exponent, mantissa) triple; the multipliers in ``repro_torch.core`` are
generic over :class:`FloatFormat`.

Two families of helpers live here:

* numpy (``np_*``) -- copies of the reference's oracle-side helpers, where
  int64 headroom makes the 48-bit significand product trivial;
* torch -- the device-side datapath.  Bits are carried in **int64 masked to
  32 bits** (``& 0xFFFFFFFF``): PyTorch on the CPU has no ``>>``, ``<<``,
  ``+``, ``-`` or ``>=`` for ``uint32``.  Every value a uint32 datapath
  would hold is the same number here, so the results are bit for bit the
  reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: The 32-bit mask that keeps an int64 lane a valid uint32 pattern.
U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """An IEEE-754-style binary format: 1 sign, ``exp_bits``, ``man_bits``."""

    name: str
    exp_bits: int
    man_bits: int

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def max_exp_field(self) -> int:
        """All-ones exponent field (inf/nan encoding)."""
        return (1 << self.exp_bits) - 1

    @property
    def sig_bits(self) -> int:
        """Significand width including the hidden bit."""
        return self.man_bits + 1

    @property
    def max_finite(self) -> float:
        return float(
            (2.0 - 2.0 ** (-self.man_bits)) * 2.0 ** (self.max_exp_field - 1 - self.bias)
        )

    @property
    def min_normal(self) -> float:
        return float(2.0 ** (1 - self.bias))


FP32 = FloatFormat("fp32", 8, 23)
BF16 = FloatFormat("bf16", 8, 7)
FP16 = FloatFormat("fp16", 5, 10)
FP8_E4M3 = FloatFormat("fp8_e4m3", 4, 3)
FP8_E5M2 = FloatFormat("fp8_e5m2", 5, 2)
# The paper's AFP16-32 family: arbitrary widths between 16 and 32 bits.
AFP24 = FloatFormat("afp24_e8m15", 8, 15)
AFP20 = FloatFormat("afp20_e8m11", 8, 11)

FORMATS = {f.name: f for f in [FP32, BF16, FP16, FP8_E4M3, FP8_E5M2, AFP24, AFP20]}
FORMATS["afp24"] = AFP24  # short aliases for the paper's AFP16-32 family
FORMATS["afp20"] = AFP20


def get_format(name: str) -> FloatFormat:
    try:
        return FORMATS[name]
    except KeyError as e:
        raise ValueError(f"unknown float format {name!r}; known: {sorted(FORMATS)}") from e


# ---------------------------------------------------------------------------
# numpy bit-level helpers (int64 headroom; oracle-side)
# ---------------------------------------------------------------------------

def np_f32_to_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32).astype(np.int64)


def np_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.int64).astype(np.uint32)).view(np.float32)


def np_decode(bits: np.ndarray, fmt: FloatFormat):
    """Split encoded integers into (sign, exp_field, mantissa_field)."""
    bits = np.asarray(bits, np.int64)
    man = bits & ((1 << fmt.man_bits) - 1)
    exp = (bits >> fmt.man_bits) & fmt.max_exp_field
    sign = (bits >> (fmt.man_bits + fmt.exp_bits)) & 1
    return sign, exp, man


def np_encode(sign: np.ndarray, exp: np.ndarray, man: np.ndarray, fmt: FloatFormat) -> np.ndarray:
    return (
        (np.asarray(sign, np.int64) << (fmt.man_bits + fmt.exp_bits))
        | (np.asarray(exp, np.int64) << fmt.man_bits)
        | np.asarray(man, np.int64)
    )


def np_decode_to_value(bits: np.ndarray, fmt: FloatFormat) -> np.ndarray:
    """Decode format-encoded integers to float64 real values (exact for <=52-bit sig)."""
    sign, exp, man = np_decode(bits, fmt)
    val = np.where(
        exp == 0,
        # subnormal: 0.man * 2^(1-bias)
        man.astype(np.float64) * 2.0 ** (1 - fmt.bias - fmt.man_bits),
        (man.astype(np.float64) * 2.0 ** -fmt.man_bits + 1.0)
        * 2.0 ** (exp.astype(np.float64) - fmt.bias),
    )
    val = np.where(exp == fmt.max_exp_field, np.where(man == 0, np.inf, np.nan), val)
    return np.where(sign == 1, -val, val)


def np_encode_from_value(x: np.ndarray, fmt: FloatFormat) -> np.ndarray:
    """Round float64 values to the nearest (ties-even) representable encoding."""
    x = np.asarray(x, np.float64)
    sign = (np.signbit(x)).astype(np.int64)
    ax = np.abs(x)

    nan = np.isnan(x)
    inf = np.isinf(x)
    # overflow threshold: midpoint between max finite and next step
    max_f = fmt.max_finite
    step = 2.0 ** (fmt.max_exp_field - 1 - fmt.bias - fmt.man_bits)
    ovf = ax >= max_f + step / 2

    # normal/subnormal path
    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        m, e = np.frexp(ax)  # ax = m * 2^e, m in [0.5, 1)
    # normalized exponent field = e - 1 + bias
    efield = e - 1 + fmt.bias
    # subnormal if efield < 1
    sub = efield < 1
    # quantize significand
    # normal: sig = m * 2^(man_bits+1)  (in [2^man_bits, 2^(man_bits+1)))
    shift = np.where(sub, 1 - efield, 0)
    scale = np.ldexp(np.ones_like(ax), fmt.man_bits + 1 - shift)
    sig = m * scale
    sig_r = np.rint(sig)  # ties-to-even
    # renormalize if rounding overflowed the significand (normal path only;
    # subnormal encodings are linear in the significand, incl. the promotion
    # to min-normal, so no shift is needed there)
    carry = ~sub & (sig_r >= np.ldexp(np.ones_like(ax), fmt.man_bits + 1))
    sig_r = np.where(carry, sig_r / 2.0, sig_r)
    efield = np.where(carry, efield + 1, efield)
    # subnormal that rounded up to min normal
    sub_to_norm = sub & (sig_r >= (1 << fmt.man_bits))
    efield = np.where(sub, np.where(sub_to_norm, 1, 0), efield)
    sig_r = np.nan_to_num(sig_r, nan=0.0, posinf=0.0, neginf=0.0)
    man = np.where(
        efield > 0,
        sig_r.astype(np.int64) - (1 << fmt.man_bits),
        sig_r.astype(np.int64),
    )
    man = np.clip(man, 0, (1 << fmt.man_bits) - 1)
    efield = np.clip(efield, 0, fmt.max_exp_field - 1)
    out = np_encode(sign, efield, man, fmt)
    out = np.where(ax == 0, np_encode(sign, 0, 0, fmt), out)
    out = np.where(ovf | inf, np_encode(sign, fmt.max_exp_field, 0, fmt), out)
    out = np.where(nan, np_encode(sign, fmt.max_exp_field, 1 << (fmt.man_bits - 1), fmt), out)
    return out


# ---------------------------------------------------------------------------
# torch bit-level helpers (int64 lanes masked to 32 bits; device-side)
# ---------------------------------------------------------------------------

def f32_to_bits(x) -> torch.Tensor:
    """float32 -> its bit pattern as int64 in ``[0, 2**32)``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x.view(torch.int32).to(torch.int64) & U32


def bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns (any value; the low 32 bits count) -> float32."""
    bits = bits & U32
    # patterns >= 2**31 are negative int32s: map them there explicitly
    signed = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def decode_f32(x):
    """Decode float32 tensors to (sign, exp_field, mantissa_field), int64."""
    bits = f32_to_bits(x)
    return bits >> 31, (bits >> 23) & 0xFF, bits & ((1 << 23) - 1)


def encode_f32(sign, exp, man) -> torch.Tensor:
    """(sign, exp_field, mantissa_field) -> float32, with uint32 wrapping."""
    return bits_to_f32(((sign << 31) & U32) | ((exp << 23) & U32) | (man & U32))


def quantize_to_format(x, fmt: FloatFormat) -> torch.Tensor:
    """Round-to-nearest-even quantization of float32 to ``fmt``, returned as float32.

    Used to model storage in narrower CiM formats.  Subnormals of the target
    format are flushed to zero (matching the approximate datapath).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    if fmt.name == "fp32":
        return x
    bits = f32_to_bits(x)
    drop = 23 - fmt.man_bits
    # RNE on the mantissa field (works across the exponent boundary because
    # the exponent field is contiguous above the mantissa in IEEE-754).
    lsb = (bits >> drop) & 1
    rnd = ((1 << (drop - 1)) - 1) + lsb
    rbits = ((bits + rnd) & U32) & (U32 ^ ((1 << drop) - 1))
    y = bits_to_f32(rbits)
    # clamp exponent range of the target format
    y = torch.where(y.abs() > fmt.max_finite, torch.sign(y) * torch.inf, y)
    y = torch.where(y.abs() < fmt.min_normal, torch.zeros_like(y), y)
    # preserve nan/inf of input
    return torch.where(torch.isfinite(x), y, x)


def truncate_mantissa(x, keep_bits: int) -> torch.Tensor:
    """Truncate (toward zero) a float32 mantissa to its top ``keep_bits`` bits."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if keep_bits >= 23:
        return x
    mask = U32 ^ ((1 << (23 - keep_bits)) - 1)
    return bits_to_f32(f32_to_bits(x) & mask)


def quantize(x, fmt_name: str) -> torch.Tensor:
    return quantize_to_format(x, get_format(fmt_name))
