"""Wrapper of the Hopper bit-level AFPM kernel (``csrc/afpm_bitwise.cu``).

Replaces the TPU kernel ``src/repro/kernels/afpm_bitwise.py::
afpm_bitwise_pallas``.  :func:`afpm_bitwise` launches the CUDA kernel for
CUDA tensors and takes the plain version (:func:`afpm_bitwise_plain`) only
for CPU tensors; it never falls back from the kernel.  Every launch adds
one to ``afpm_bitwise.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.afpm import AFPMConfig, check_config

from . import _build, ref


def afpm_bitwise_plain(x: torch.Tensor, y: torch.Tensor,
                       cfg: AFPMConfig = AFPMConfig()) -> torch.Tensor:
    """The plain PyTorch version: the datapath the kernel runs, op by op."""
    return ref.afpm_bitwise_ref(x, y, cfg)


def _lib():
    lib = _build.load("afpm_bitwise")
    fn = lib.afpm_bitwise_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.afpm_bitwise_error_string.argtypes = [ctypes.c_int]
        lib.afpm_bitwise_error_string.restype = ctypes.c_char_p
    return lib


def afpm_bitwise(x: torch.Tensor, y: torch.Tensor,
                 cfg: AFPMConfig = AFPMConfig()) -> torch.Tensor:
    """Elementwise AFPM multiply of two equal-shape tensors (any rank) -> fp32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    both on one device, of one shape, contiguous once cast to fp32;
    anything else raises, as does a config the datapath cannot run."""
    fmt = check_config(cfg)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return afpm_bitwise_plain(x, y, cfg)
    if x.device.type != "cuda" or x.device != y.device:
        raise ValueError(f"afpm_bitwise needs x and y on one CUDA device (or "
                         f"both on the CPU); got {x.device} and {y.device}")
    if x.shape != y.shape:
        raise ValueError(f"afpm_bitwise: shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("afpm_bitwise needs contiguous x and y")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    full = fmt.man_bits == 23 and fmt.exp_bits == 8
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.afpm_bitwise_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), out.numel(), cfg.n,
            fmt.man_bits, fmt.bias, fmt.max_exp_field, int(cfg.mode == "acl"),
            int(full), int(cfg.conditional), int(cfg.compensation),
            int(cfg.skip_bd), stream)
    if rc != 0:
        msg = lib.afpm_bitwise_error_string(rc).decode()
        raise RuntimeError(f"afpm_bitwise kernel launch failed: {msg} ({rc})")
    afpm_bitwise.launches += 1
    return out


afpm_bitwise.launches = 0
