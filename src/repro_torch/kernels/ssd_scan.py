"""Wrapper of the Hopper SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan_pallas``.
:func:`ssd_scan` launches the CUDA kernel for CUDA tensors and takes the
plain version (:func:`ssd_scan_plain`) only for CPU tensors; it never falls
back from the kernel.  Every launch adds one to ``ssd_scan.launches``.

What bounds it on an H100 is operations, not bytes: per batch row, chunk
and head the causal half of ``C B^T`` and ``M @ x`` plus the carry and the
state update (:func:`fmas`), all fp32 on the CUDA cores.  The kernel keeps
the ``(N, P)`` state in shared memory across the chunk loop and forms the
masked decay matrix 16 rows at a time; one CTA per (head, batch row) is
only 24 CTAs for a batch-1 prefill, which leaves most of the card idle
(see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

#: Shared memory a block can use on Hopper (bytes).
_MAX_SMEM = 232448
_MAX_GRID = 65535


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """The plain PyTorch version: the chunked algorithm, dot by dot."""
    return ref.ssd_scan_chunked_ref(x, dt, A, B, C, chunk)


def fmas(batch: int, L: int, H: int, P: int, N: int, Q: int) -> int:
    """Fused multiply-adds the scan needs for these shapes: per batch row,
    chunk and head ``Q(Q+1)/2 (N + P)`` for the causal half of ``C B^T``
    and ``M @ x`` and ``2 Q N P`` for the carry and the state update."""
    per = Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P
    return batch * (L // Q) * H * per


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ll, ll, ll, ptr, ll, ll, ll, ptr,
                       ptr, ll, ll, ptr, ll, ll, ptr,
                       i, i, i, i, i, i, ptr]
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
        lib.ssd_scan_smem_bytes.restype = ll
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """SSD chunked scan ``x (b, L, H, P), dt (b, L, H), A (H,), B, C
    (b, L, N) -> y (b, L, H, P)`` fp32, with ``Q = min(chunk, L)`` dividing
    ``L`` (:func:`repro_torch.kernels.dispatch.ssd` pads any ``L``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    fp32, on one device, the last dim of ``x``, ``B`` and ``C`` contiguous
    (the other dims are read through their strides); anything else
    raises."""
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
    if H > _MAX_GRID or b > _MAX_GRID:
        raise ValueError(f"ssd_scan: grid ({H}, {b}) exceeds {_MAX_GRID}")
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(N, P, Q)
    if smem > _MAX_SMEM:
        raise ValueError(f"ssd_scan: N {N}, P {P}, Q {Q} need {smem} bytes "
                         f"of shared memory, more than {_MAX_SMEM}")
    y = torch.empty((b, L, H, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    l = ref.chunk_decay(dt, A, Q).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
            dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
            l.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1),
            C.data_ptr(), C.stride(0), C.stride(1), y.data_ptr(),
            b, L, H, P, N, Q, stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({rc})")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
