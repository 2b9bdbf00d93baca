"""Plain PyTorch versions of the kernels: the semantics each kernel matches.

In the segmented matmul the bf16 x bf16 products are computed as fp32
matmuls of the bf16-rounded operands cast back up to fp32.  Each such
product is exact in fp32 and the
sum accumulates in fp32, which is the reference's bf16 dot with fp32
accumulation.  On CUDA this needs full-fp32 matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default;
the port's entry points set it).

``afpm_bitwise_ref`` is the bit-level AFPM datapath itself
(:func:`repro_torch.core.afpm.afpm_mult_f32`), integer throughout.
"""
from __future__ import annotations

import torch

from repro_torch.core.afpm import AFPMConfig, afpm_mult_f32


def split_hi_lo_ref(x: torch.Tensor):
    """fp32 -> (hi, lo) bf16 segments; hi = RNE bf16, lo = bf16(x - hi)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def afpm_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                    passes: int = 3) -> torch.Tensor:
    """Segmented (split-float) approximate matmul ``x (..., K) @ w (K, N)``.

    passes=3: AC + AD + BC (BD omitted, the paper's Eq. 6)
    passes=2: AC + AD (weight low bits dropped)
    passes=1: AC only (ACL-like)
    """
    xh, xl = split_hi_lo_ref(x)
    wh, wl = split_hi_lo_ref(w)
    f = torch.float32
    out = torch.matmul(xh.to(f), wh.to(f))
    if passes >= 2:
        out = out + torch.matmul(xl.to(f), wh.to(f))
    if passes >= 3:
        out = out + torch.matmul(xh.to(f), wl.to(f))
    return out


def afpm_bitwise_ref(x: torch.Tensor, y: torch.Tensor,
                     cfg: AFPMConfig) -> torch.Tensor:
    """Elementwise bit-level AFPM multiply: the core datapath itself."""
    return afpm_mult_f32(x, y, cfg)
