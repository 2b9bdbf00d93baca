"""Wrapper of the Hopper SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan_pallas``.
:func:`ssd_scan` launches the CUDA kernels for CUDA tensors and takes the
plain version (:func:`ssd_scan_plain`) only for CPU tensors; it never falls
back from the kernels.  Every call adds one to ``ssd_scan.launches``.
A placed or differentiated call reaches it through the custom op
``repro_torch::ssd_scan`` (:mod:`.custom_ops`), which DTensor shards by
batch or by head.

A call runs the plain ``chunk_decay`` (a cumsum and a product, as the
reference hoists it) and then launches two kernels: ``chunk_kernel`` forms
``C B^T`` once per (batch row, chunk) and each chunk's state contribution
``dS`` per head, all chunks in parallel, and the last CTA of each state
tile to finish walks the chunks in order into the states ``S_c``;
``output_kernel`` then forms every chunk's ``y = M @ x + (C e^l) @ S_c``,
again all chunks in parallel.

What bounds it on an H100 is operations, not bytes (:func:`fmas`, all fp32
on the CUDA cores).  To come near that bound with few heads and short
prompts, chunks run in parallel (only the ``N x P`` elementwise walk is
serial), ``C B^T`` is formed once for all heads, each thread owns a 4 x 4
register tile of every dot, slabs arrive by ``cp.async`` four deep, the
grid has 192 output CTAs for a batch-1 prefill of 256 steps
(:func:`plan`), and no work goes to the last chunk's state or the first
chunk's carry.  What holds it back is in the source's note.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, ref

#: Shared memory a block can use on Hopper (bytes).
_MAX_SMEM = 232448
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2 ** 31 - 1
#: Output tiles of chunk_kernel (TILE x TILE) and of output_kernel (ROWS x
#: TILE), as in csrc/ssd_scan.cu.
TILE = 64
ROWS = 32


class Plan(NamedTuple):
    kernels: int   # kernels a call launches (besides chunk_decay's ops)
    grid_a: int    # chunk_kernel CTAs a batch row
    grid_b: int    # output_kernel CTAs a batch row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(L: int, Q: int, H: int, P: int, N: int) -> Plan:
    """The kernels' tiles and grids for one batch row.  They depend on the
    shapes alone, never on the batch size (the batch is the grid's second
    dimension), so every element's arithmetic is the same at any batch."""
    if Q < 1 or L % Q:
        raise ValueError(f"seq len {L} not divisible by chunk {Q}")
    nc, tq = L // Q, _cdiv(Q, TILE)
    tp = _cdiv(P, TILE)
    grid_a = nc * tq * (tq + 1) // 2 + (nc - 1) * H * _cdiv(N, TILE) * tp
    return Plan(2, grid_a, nc * H * _cdiv(Q, ROWS) * tp)


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """The plain PyTorch version: the chunked algorithm, dot by dot."""
    return ref.ssd_scan_chunked_ref(x, dt, A, B, C, chunk)


def fmas(batch: int, L: int, H: int, P: int, N: int, Q: int) -> int:
    """Fused multiply-adds that ``y`` needs for these shapes: per batch row
    and chunk ``Q(Q+1)/2 N`` for the causal half of ``C B^T`` (shared by
    the heads) and per head ``Q(Q+1)/2 P`` for ``M @ x``, ``Q N P`` for the
    carry on every chunk but the first and ``Q N P`` for the state update
    on every chunk but the last."""
    nc = L // Q
    tri = Q * (Q + 1) // 2
    per_row = nc * (tri * N + H * tri * P) + 2 * (nc - 1) * H * Q * N * P
    return batch * per_row


_LIB = None
_COUNTS: dict = {}   # (device, stream) -> zeroed int32 tile counters


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("ssd_scan")
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [ptr, ll, ll, ll, ptr, ll, ll, ll, ptr,
                                        ptr, ll, ll, ptr, ll, ll, ptr,
                                        ptr, ptr, ptr, i, i, i, i, i, i, i, i, i,
                                        ptr]
        lib.ssd_scan_smem_bytes.argtypes = [i]
        lib.ssd_scan_smem_bytes.restype = ll
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _counters(device, stream: int, n: int) -> int:
    """Pointer to ``n`` zeroed tile counters, kept for the next call on the
    same stream (the kernel leaves them zero) and grown as needed."""
    key = (device.index, stream)
    buf = _COUNTS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTS[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                         device=device)
    return buf.data_ptr()


def _rows16(t: torch.Tensor, dims: int) -> int:
    """1 when every row of ``t`` (its last dim) starts 16-byte aligned."""
    return int(t.data_ptr() % 16 == 0
               and all(st % 4 == 0 for st in t.stride()[:dims]))


def ssd_scan(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """SSD chunked scan ``x (b, L, H, P), dt (b, L, H), A (H,), B, C
    (b, L, N) -> y (b, L, H, P)`` fp32, with ``Q = min(chunk, L)`` dividing
    ``L`` (:func:`repro_torch.kernels.dispatch.ssd` pads any ``L``).

    CPU tensors take the plain version.  CUDA tensors launch the kernels
    (two, see the module's docstring): fp32, on one device, the last dim of
    ``x``, ``B`` and ``C`` contiguous (the other dims are read through
    their strides); anything else raises."""
    ts = (x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan needs every operand on one CUDA device "
                         f"(or all on the CPU); got {[t.device for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan takes fp32 operands; got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 4:
        raise ValueError(f"x must be (batch, L, H, P); got {tuple(x.shape)}")
    b, L, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (b, L, H) or A.shape != (H,) or B.shape != (b, L, N) \
            or C.shape != (b, L, N):
        raise ValueError(f"ssd_scan shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("ssd_scan needs the last dim of x, B and C "
                         "contiguous")
    Q = min(chunk, L) if L else chunk
    if Q < 1 or (L and L % Q):
        raise ValueError(f"seq len {L} not divisible by chunk {Q}")
    y = torch.empty((b, L, H, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    p = plan(L, Q, H, P, N)
    if b > _MAX_GRID_Y or max(p.grid_a, p.grid_b) > _MAX_GRID_X:
        raise ValueError(f"ssd_scan: batch {b} or grids ({p.grid_a}, "
                         f"{p.grid_b}) exceed the launch limits")
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(Q)
    if smem > _MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {Q} needs {smem} bytes of shared "
                         f"memory, more than {_MAX_SMEM}")
    nc = L // Q
    l = ref.chunk_decay(dt, A, Q).contiguous()
    # workspaces: C B^T a chunk (Q rows of Q, padded to a multiple of 4) and
    # the states (N rows of P, padded alike), so their rows copy 16 bytes at
    # a time
    cbt = torch.empty(b * nc * Q * _cdiv(Q, 4) * 4, dtype=torch.float32,
                      device=x.device)
    ds = torch.empty(b * (nc - 1) * H * N * _cdiv(P, 4) * 4,
                     dtype=torch.float32, device=x.device)
    vec = _rows16(x, 3) | _rows16(B, 2) << 1
    dev = x.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    count = _counters(dev, stream, b * H * _cdiv(N, TILE) * _cdiv(P, TILE))
    with torch.cuda.device(dev):
        rc = lib.ssd_scan_launch(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
            dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
            l.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1),
            C.data_ptr(), C.stride(0), C.stride(1), y.data_ptr(),
            cbt.data_ptr(), ds.data_ptr(), count, b, L, H, P, N, Q, vec,
            p.grid_a, p.grid_b, stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({rc})")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
