"""Wrapper of the decode step's fused attention core
(``csrc/decode_attention.cu``).

Replaces no TPU kernel: the JAX package leaves attention, its norms, RoPE
and the cache update to XLA.  The kernel takes a decode step's q, k and v
as the projections returned them and does, in one launch a layer, what
the plain chain :func:`repro_torch.models.attention.decode_core_plain`
does op by op: qk-norm, RoPE, the cache write at each row's position and
grouped-query attention with every sum in fp64, the same roundings in the
same places.  The plain chain stays beside the dispatch that chooses
between them (``models/attention.py``), which needs the model's layout
rules that this module does not import; the CPU tests use it, and
``chip_smoke.py`` and the card's tests compare the kernel with it.

:func:`decode_core` launches the kernel or raises: it refuses CPU tensors
(the plain chain is for them) and anything else it does not take
(:func:`refusal` says why).  Every call adds one to
``decode_core.launches``.

What bounds it is bytes: each attended key's K and V row is read once;
the design is in the source's note.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.layers import rope_freqs

from . import _build

#: Query heads one CTA attends, the largest that divides the group.
GROUP_BLOCKS = (4, 2, 1)
#: A CTA keeps its scores in shared memory up to this many bytes; past it
#: they go to a scratch buffer the wrapper allocates (a long cache).
SCORES_SMEM = 64 * 1024
#: Head sizes the kernel takes: multiples of 8 (16-byte rows) up to 256.
MAX_HEAD_DIM = 256

_FN = None
_FREQS: dict = {}   # (head_dim, theta, device) -> the RoPE frequencies


def _launcher():
    """The kernel's ctypes function, built, loaded and typed once."""
    global _FN
    if _FN is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_double)
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, ll, ll, p, ll, p, i, p,
                       i, i, i, i, i, i, i, i, i, d, d, d, i, p]
        fn.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


def rope_table(head_dim: int, theta: float, device) -> torch.Tensor:
    """The RoPE frequencies, made once per (head_dim, theta, device) by
    :func:`~repro_torch.models.layers.rope_freqs`, the plain path's own
    expression, so their bits are the ones it uses."""
    key = (head_dim, float(theta), device)
    t = _FREQS.get(key)
    if t is None:
        t = _FREQS[key] = rope_freqs(head_dim, theta, device)
    return t


def group_block(group: int) -> int:
    """Query heads a CTA attends for a group of ``group`` heads."""
    return next(g for g in GROUP_BLOCKS if group % g == 0)


def refusal(q, k, v, k_cache, v_cache, positions, pos, out_dtype,
            scales=None) -> Optional[str]:
    """Why :func:`decode_core` would not take these operands, or None.

    It takes, on one CUDA device and with no gradient to record: q (B, 1,
    H, D), k and v (B, 1, KH, D), fp32 and contiguous; caches (B, S, KH,
    D), bf16 or fp32, contiguous and 16-byte aligned, not DTensors;
    ``positions`` (B, 1) int64 (the RoPE positions, any strides); ``pos``
    a Python int or a (B,) int64 tensor; qk-norm ``scales`` (D,) each, or
    None; D a multiple of 8 up to 256; ``out_dtype`` bf16 or fp32."""
    if q.device.type != "cuda":
        return f"operands on {q.device}, not on a CUDA device"
    if any(is_dtensor(t) for t in (q, k, v, k_cache, v_cache)):
        return "a DTensor operand (a placed step)"
    tensors = [q, k, v, k_cache, v_cache, positions] + list(scales or ())
    if isinstance(pos, torch.Tensor):
        tensors.append(pos)
    if any(t.device != q.device for t in tensors):
        return "operands on more than one device"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "an operand records a gradient (the kernel has none)"
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        return f"q, k, v must be fp32, got {q.dtype}, {k.dtype}, {v.dtype}"
    if k_cache.dtype not in (torch.bfloat16, torch.float32) or \
            v_cache.dtype != k_cache.dtype:
        return (f"caches must both be bf16 or fp32, got {k_cache.dtype}, "
                f"{v_cache.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        return f"output dtype must be bf16 or fp32, got {out_dtype}"
    if q.dim() != 4 or k_cache.dim() != 4:
        return f"need q (B, 1, H, D) and caches (B, S, KH, D); got " \
               f"{tuple(q.shape)}, {tuple(k_cache.shape)}"
    B, S1, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    if S1 != 1 or k.shape != (B, 1, KH, D) or v.shape != k.shape or \
            k_cache.shape != (B, S, KH, D) or v_cache.shape != k_cache.shape \
            or H % KH:
        return (f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                f"{tuple(v.shape)}, caches {tuple(k_cache.shape)}, "
                f"{tuple(v_cache.shape)}")
    if D % 8 or D > MAX_HEAD_DIM:
        return f"head dim {D}: the kernel takes multiples of 8 up to 256"
    if not all(t.is_contiguous() for t in (q, k, v, k_cache, v_cache)):
        return "q, k, v and the caches must be contiguous"
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        return "the caches must be 16-byte aligned"
    if positions.dtype != torch.int64 or positions.shape != (B, 1):
        return (f"positions must be (B, 1) int64, got "
                f"{tuple(positions.shape)} {positions.dtype}")
    if isinstance(pos, torch.Tensor) and (pos.dtype != torch.int64 or
                                          pos.shape != (B,)):
        return f"pos must be (B,) int64, got {tuple(pos.shape)} {pos.dtype}"
    if scales is not None and any(
            s.dtype != torch.float32 or s.shape != (D,)
            or not s.is_contiguous() for s in scales):
        return "qk-norm scales must be (D,) fp32, contiguous"
    if not isinstance(pos, torch.Tensor) and not 0 <= int(pos) < S:
        return f"position {pos} outside a cache of {S}"
    return None


def decode_core(q, k, v, k_cache, v_cache, pos, positions, *, scales=None,
                eps: float = 1e-6, theta: float = 10000.0,
                window: Optional[int] = None, cap: Optional[float] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """One decode step's attention core in one launch: ``q`` (B, 1, H, D),
    ``k`` / ``v`` (B, 1, KH, D) as the projections returned them, qk-norm
    by ``scales = (q_scale, k_scale)`` (or none), RoPE at ``positions``
    (B, 1), k and v written into ``k_cache`` / ``v_cache`` (B, S, KH, D)
    in place at ``pos`` (an int for every row, or a (B,) tensor), and the
    attention over keys ``[max(0, pos - window + 1), pos]`` with an
    optional softcap.  Returns (B, 1, H, D) in ``out_dtype``.  Raises on
    what :func:`refusal` names (a scalar ``pos`` outside the cache among
    them); a row whose position lies outside it reads NaN."""
    why = refusal(q, k, v, k_cache, v_cache, positions, pos, out_dtype,
                  scales)
    if why is not None:
        raise ValueError(f"decode_core: {why}")
    return launch(q, k, v, k_cache, v_cache, pos, positions, scales, eps,
                  theta, window, cap, out_dtype)


def launch(q, k, v, k_cache, v_cache, pos, positions, scales, eps, theta,
           window, cap, out_dtype) -> torch.Tensor:
    """:func:`decode_core` on operands that :func:`refusal` has taken,
    with no check of its own (the model's dispatch has just made them)."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    fn = _launcher()
    gb = group_block(H // KH)
    in_smem = gb * S * 8 <= SCORES_SMEM
    out = torch.empty((B, 1, H, D), dtype=out_dtype, device=dev)
    scratch = None if in_smem else torch.empty(B * H * S, dtype=torch.float64,
                                               device=dev)
    if isinstance(pos, torch.Tensor):
        pos_p, pos_stride, pos_scalar = pos.data_ptr(), pos.stride(0), 0
    else:
        pos_p, pos_stride, pos_scalar = None, 0, int(pos)
    q_scale = k_scale = None
    if scales is not None:
        q_scale, k_scale = (s.data_ptr() for s in scales)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_scale, k_scale,
            rope_table(D, theta, dev).data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), int(k_cache.dtype == torch.bfloat16), pos_p,
            pos_stride, pos_scalar, positions.data_ptr(), positions.stride(0),
            out.data_ptr(), int(out_dtype == torch.bfloat16),
            None if scratch is None else scratch.data_ptr(), B, S, H, KH, D,
            gb, int(window or 0), int(scales is not None), int(in_smem),
            float(eps), D ** -0.5, float(cap or 0.0), dev.index, stream)
    if rc != 0:
        msg = _build.load("decode_attention").decode_attention_error_string(
            rc).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} "
                           f"({rc})")
    decode_core.launches += 1
    return out


decode_core.launches = 0
