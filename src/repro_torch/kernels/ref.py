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

The SSD scan has two plain versions: ``ssd_scan_ref``, the sequential
recurrence (the oracle), and ``ssd_scan_chunked_ref``, the chunked
algorithm the kernel runs, with the same per-chunk dots.  Both take an
optional leading batch dimension (the reference ``vmap``s over it).
"""
from __future__ import annotations

import torch

from repro_torch.core.afpm import AFPMConfig, afpm_mult_f32


def split_hi_lo_ref(x: torch.Tensor, lo: bool = True):
    """fp32 -> (hi, lo) bf16 segments; hi = RNE bf16, lo = bf16(x - hi)
    (None unless ``lo``).  A bf16 ``x`` is its own hi segment."""
    hi = x.to(torch.bfloat16)
    if not lo:
        return hi, None
    f = torch.float32
    return hi, (x.to(f) - hi.to(f)).to(torch.bfloat16)


def afpm_matmul_ref(x: torch.Tensor, w: torch.Tensor, passes: int = 3,
                    sums: torch.dtype = torch.float32) -> torch.Tensor:
    """Segmented (split-float) approximate matmul ``x (..., K) @ w (K, N)``.

    passes=3: AC + AD + BC (BD omitted, the paper's Eq. 6)
    passes=2: AC + AD (weight low bits dropped)
    passes=1: AC only (ACL-like): the exact tier's bf16 dot, fp32 sums

    A segment is formed only where a pass reads it, so passes 1 makes one
    fp32 copy of each operand's rounding, as ``bf16(x) @ bf16(w)`` does.
    The passes are summed in ``sums`` and returned in it for the caller
    to round once.  In fp64 every segment product (16 significant bits)
    is exact, and so is the sum unless a dot's terms span more than about
    53 - 16 - log2(3K) binades: its bits do not depend on the order of
    the sum, nor on how K, the rows or the columns are split.
    """
    xh, xl = split_hi_lo_ref(x, passes >= 2)
    wh, wl = split_hi_lo_ref(w, passes >= 3)
    f = sums
    if f == torch.float64 and passes >= 2:
        # exact sums, so in any order: the passes accumulate in place,
        # one output's memory where the fp32 form holds three
        lead = xh.shape[:-1]
        xh, xl = xh.reshape(-1, xh.shape[-1]), xl.reshape(-1, xl.shape[-1])
        out = torch.mm(xh.to(f), wh.to(f))
        out.addmm_(xl.to(f), wh.to(f))
        if passes >= 3:
            out.addmm_(xh.to(f), wl.to(f))
        return out.reshape(*lead, out.shape[-1])
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


def chunk_decay(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per-chunk log cumulative decay ``l[t] = A_h * cumsum(dt)[t]``, the
    cumsum restarting at every chunk boundary.

    Computed once, outside the kernel and outside the chunked version, so
    both consume the same bits (the reference hoists it for the same
    reason: inside a fused body ``A * cumsum(dt)`` may be contracted
    differently in each lowering).

    dt: (..., L, H), A: (H,) -> l: (..., L, H); L must be a multiple of
    ``chunk``."""
    *lead, L, H = dt.shape
    if L % chunk:
        raise ValueError(f"seq len {L} not divisible by chunk {chunk}")
    dtc = dt.to(torch.float32).reshape(*lead, L // chunk, chunk, H)
    l = A.to(torch.float32) * torch.cumsum(dtc, dim=-2)
    return l.reshape(*lead, L, H)


def ssd_scan_ref(x, dt, A, B, C) -> torch.Tensor:
    """Mamba2 SSD scan oracle, a plain sequential recurrence.

    x (..., L, H, P), dt (..., L, H), A (H,), B and C (..., L, N), shared
    by every head -> y (..., L, H, P) fp32.  Per head h, state S (N, P):
    ``S_t = exp(A_h dt_t) S_{t-1} + dt_t B_t^T x_t`` and ``y_t = C_t S_t``.
    """
    f = torch.float32
    x, dt, A, B, C = (t.to(f) for t in (x, dt, A, B, C))
    *lead, L, H, P = x.shape
    N = B.shape[-1]
    decay = torch.exp(A * dt)                                  # (..., L, H)
    S = torch.zeros((*lead, H, N, P), dtype=f, device=x.device)
    ys = []
    for t in range(L):
        inp = B[..., t, None, :, None] * x[..., t, :, None, :]  # (..., H, N, P)
        S = decay[..., t, :, None, None] * S \
            + dt[..., t, :, None, None] * inp
        ys.append(torch.einsum("...n,...hnp->...hp", C[..., t, :], S))
    return torch.stack(ys, dim=-3)


def ssd_scan_chunked_ref(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD: the kernel's algorithm with the reference's per-chunk
    dots, each a (batched) fp32 matmul.

    Same shapes as :func:`ssd_scan_ref`; ``L`` must be a multiple of
    ``Q = min(chunk, L)``.  Per chunk and head, with ``l = chunk_decay``:
    ``M = where(t >= s, (C B^T) * exp(min(l_t - l_s, 0)) * dt_s, 0)``,
    ``y = M @ x + (C * exp(l)) @ S`` and
    ``S = exp(l_Q) S + (B * dt exp(l_Q - l))^T @ x``.
    """
    f = torch.float32
    x, dt, B, C = (t.to(f) for t in (x, dt, B, C))
    *lead, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"seq len {L} not divisible by chunk {Q}")
    l = chunk_decay(dt, A, Q)
    # head-major per chunk: (..., H, Q, .)
    xh = x.movedim(-2, -3)                      # (..., H, L, P)
    dth = dt.movedim(-1, -2)                    # (..., H, L)
    lh = l.movedim(-1, -2)                      # (..., H, L)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    S = torch.zeros((*lead, H, N, P), dtype=f, device=x.device)
    ys = []
    for c0 in range(0, L, Q):
        xq = xh[..., c0:c0 + Q, :]              # (..., H, Q, P)
        dq = dth[..., c0:c0 + Q]                # (..., H, Q)
        lq = lh[..., c0:c0 + Q]                 # (..., H, Q)
        Bq = B[..., None, c0:c0 + Q, :]         # (..., 1, Q, N)
        Cq = C[..., None, c0:c0 + Q, :]
        CB = Cq @ Bq.transpose(-1, -2)          # (..., 1, Q, Q)
        # clamp: only t >= s is used, where l_t - l_s <= 0; the clamp keeps
        # the masked upper triangle finite
        ratio = torch.exp(torch.clamp(lq[..., :, None] - lq[..., None, :],
                                      max=0.0))
        M = torch.where(causal, CB * ratio * dq[..., None, :], 0.0)
        y = M @ xq + (Cq * torch.exp(lq)[..., None]) @ S
        w = dq * torch.exp(lq[..., -1:] - lq)
        S = torch.exp(lq[..., -1])[..., None, None] * S \
            + (Bq * w[..., None]).transpose(-1, -2) @ xq
        ys.append(y)
    return torch.cat(ys, dim=-2).movedim(-3, -2)  # (..., L, H, P)
