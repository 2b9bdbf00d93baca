"""Wrapper of the Hopper segmented matmul kernel (``csrc/afpm_matmul.cu``).

Replaces the TPU kernel ``src/repro/kernels/afpm_matmul.py::
afpm_matmul_pallas``.  :func:`afpm_matmul` launches the CUDA kernel for
CUDA tensors and takes the plain version (:func:`afpm_matmul_plain`) only
for CPU tensors; it never falls back from the kernel.  Every launch adds
one to ``afpm_matmul.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

#: Kernel rows per CTA (``BM`` in the source): the grid's y extent caps M.
_BM = 32
_MAX_GRID_Y = 65535


def afpm_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      passes: int = 3) -> torch.Tensor:
    """The plain PyTorch version: what the kernel computes, op by op."""
    return ref.afpm_matmul_ref(x, w, passes)


def _lib():
    lib = _build.load("afpm_matmul")
    fn = lib.afpm_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.afpm_matmul_error_string.argtypes = [ctypes.c_int]
        lib.afpm_matmul_error_string.restype = ctypes.c_char_p
    return lib


def afpm_matmul(x: torch.Tensor, w: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """Segmented matmul ``x (..., M, K) @ w (K, N) -> (..., M, N)`` fp32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    ``x`` fp32 or bf16 and ``w`` fp32, both contiguous and on one device;
    anything else raises."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return afpm_matmul_plain(x, w, passes)
    if x.device.type != "cuda" or x.device != w.device:
        raise ValueError(f"afpm_matmul needs x and w on one CUDA device (or "
                         f"both on the CPU); got {x.device} and {w.device}")
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if x.dim() < 2 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"need x (..., M, K) @ w (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("afpm_matmul needs contiguous x and w")
    *lead, M, K = x.shape
    N = w.shape[1]
    rows = M
    for d in lead:
        rows *= d
    if -(-rows // _BM) > _MAX_GRID_Y:
        raise ValueError(f"afpm_matmul: {rows} rows exceed the kernel grid")
    out = torch.empty((*lead, M, N), dtype=torch.float32, device=x.device)
    if rows == 0 or N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.afpm_matmul_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            out.data_ptr(), rows, K, N, passes, stream)
    if rc != 0:
        msg = lib.afpm_matmul_error_string(rc).decode()
        raise RuntimeError(f"afpm_matmul kernel launch failed: {msg} ({rc})")
    afpm_matmul.launches += 1
    return out


afpm_matmul.launches = 0
