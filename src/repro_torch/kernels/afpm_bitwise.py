"""Wrapper of the Hopper bit-level AFPM kernels (``csrc/afpm_bitwise.cu``).

Replaces the TPU kernel ``src/repro/kernels/afpm_bitwise.py::
afpm_bitwise_pallas``, and computes on the card what the JAX package's
``src/repro/core/afpm.py::afpm_matmul_emulated`` computes in jnp around
it.  Two entries, one datapath:

* :func:`afpm_bitwise`, the elementwise product;
* :func:`emulated_matmul`, ``x (..., K) @ w (K, N)`` with every product
  the elementwise one, summed in fp32 chunk by chunk over K.

Each launches its CUDA kernel for CUDA tensors and takes its plain version
(:func:`afpm_bitwise_plain`, ``core/afpm.py::afpm_matmul_emulated``) only
for CPU tensors; neither falls back from the kernel.  Every launch adds one to
the entry's ``launches``.  ``dispatch`` reaches them, for a placed or
differentiated call, through the custom ops ``repro_torch::afpm_bitwise``
and ``repro_torch::afpm_emulated_matmul`` (:mod:`.custom_ops`), which
DTensor shards by the ops' rules.

:func:`plan` cuts an emulated matmul into CTAs; it never changes the
arithmetic.  K is cut into chunks of ``k_chunk`` from 0 whatever M and N
are, so an output element depends only on its row of x, its column of w,
K and ``k_chunk``, and a row's result is the same at every M.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.afpm import (AFPMConfig, afpm_matmul_emulated,
                                   check_config)

from . import _build, autotune, ref

#: rows and columns of an output tile (one CTA), as in the source
TILE = 64
#: the elementwise entry's static CTA shape: threads a CTA, most CTAs
STATIC_BLOCK = autotune.BITWISE_STATIC
#: SMs of an H100
SMS = 132
#: split mode's workspace (chunks x M x N fp32) is at most this many bytes;
#: a larger one runs whole mode, the same arithmetic in one CTA a tile
MAX_SPLIT_BYTES = 256 << 20
#: M, K and N are at most this (the source's int index arithmetic)
MAX_DIM = 1 << 30
_MAX_GRID_YZ = 65535


class Plan(NamedTuple):
    """How one emulated matmul is cut: ``group`` chunks of K a CTA, and
    ``grid`` = (row tiles, column tiles, groups); one group is whole mode
    (a CTA walks every chunk of its tile), more is split mode (the tile's
    last CTA folds every chunk's sum)."""
    split: bool
    group: int
    grid: tuple


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, k_chunk: int = 64) -> Plan:
    """The kernel's grid for ``x (M, K) @ w (K, N)``.

    The cost of a plan is its waves of CTAs (a wave: one CTA an SM) times
    the chunks a CTA sums.  Split mode takes the group of chunks a CTA
    with the least cost (then the fewest CTAs), and runs when that cost is
    below 9/10 of whole mode's and the workspace fits
    :data:`MAX_SPLIT_BYTES`.  (On an H100 the cost follows the kernel's
    times at ResNet-18's shapes: a lone CTA keeps most of an SM busy, and
    an SM that holds one CTA more than another sets the call's time.)  The
    result is the same bits in either mode.  Raises beyond the kernel's
    limits: M, K, N in [0, 2**30]
    and ``k_chunk`` in [1, 2**30], at most 65535 column tiles."""
    if min(M, K, N) < 0 or max(M, K, N) > MAX_DIM:
        raise ValueError(f"emulated_matmul: M, K, N = {M}, {K}, {N} out of "
                         f"range [0, {MAX_DIM}]")
    if not 1 <= k_chunk <= MAX_DIM:
        raise ValueError(f"emulated_matmul: k_chunk must be in [1, {MAX_DIM}], "
                         f"got {k_chunk}")
    tiles_m, tiles_n = -(-M // TILE), -(-N // TILE)
    if tiles_n > _MAX_GRID_YZ:
        raise ValueError(f"emulated_matmul: N = {N} exceeds the kernel grid "
                         f"({_MAX_GRID_YZ} tiles of {TILE} columns)")
    chunks = -(-K // k_chunk)
    whole = max(chunks, 1)
    groups = set()   # chunks a CTA that split a tile's chunks 2 ways or more
    if chunks > 1 and chunks * M * N * 4 <= MAX_SPLIT_BYTES:
        groups = {-(-chunks // s) for s in range(2, min(chunks, _MAX_GRID_YZ) + 1)}

    def cost(group):   # (waves x chunks a CTA, CTAs)
        ctas = tiles_m * tiles_n * -(-whole // group)
        return -(-ctas // SMS) * group, ctas

    best = min(groups, key=cost) if groups else whole
    # a split must win by a tenth: its partials cost too
    split = 10 * cost(best)[0] < 9 * cost(whole)[0]
    group = best if split else whole
    return Plan(split, group, (tiles_m, tiles_n, -(-whole // group)))


def afpm_bitwise_plain(x: torch.Tensor, y: torch.Tensor,
                       cfg: AFPMConfig = AFPMConfig()) -> torch.Tensor:
    """The plain PyTorch version: the datapath the kernel runs, op by op."""
    return ref.afpm_bitwise_ref(x, y, cfg)


@functools.lru_cache(maxsize=None)
def _config_args(cfg: AFPMConfig) -> tuple:
    """The datapath's integer arguments for ``cfg`` (checked once; a config
    the datapath cannot run raises on every call)."""
    fmt = check_config(cfg)
    full = fmt.man_bits == 23 and fmt.exp_bits == 8
    return (cfg.n, fmt.man_bits, fmt.bias, fmt.max_exp_field,
            int(cfg.mode == "acl"), int(full), int(cfg.conditional),
            int(cfg.compensation), int(cfg.skip_bd))


_FNS = None
_WORKSPACE: dict = {}   # (device, stream) -> (partials, counters, pointers)


def _launchers():
    """The kernels' ctypes functions, built, loaded and typed once."""
    global _FNS
    if _FNS is None:
        lib = _build.load("afpm_bitwise")
        p, i = ctypes.c_void_p, ctypes.c_int
        ew = lib.afpm_bitwise_launch
        ew.argtypes = [p, p, p, ctypes.c_longlong] + [i] * 12 + [p]
        ew.restype = i
        mm = lib.afpm_emulated_launch
        mm.argtypes = [p] * 5 + [i] * 16 + [p]
        mm.restype = i
        lib.afpm_bitwise_error_string.argtypes = [i]
        lib.afpm_bitwise_error_string.restype = ctypes.c_char_p
        _FNS = (ew, mm, lib.afpm_bitwise_error_string)
    return _FNS


def _raise_failed(what: str, rc: int):
    msg = _launchers()[2](rc).decode()
    raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _workspace(device, stream: int, n_part: int, n_count: int):
    """Pointers to split mode's partials and zeroed tile counters, kept for
    the next call on the same stream (the kernel leaves the counters zero)
    and grown as needed."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_count:
        part = torch.empty(max(n_part, 1 << 20), dtype=torch.float32,
                           device=device)
        count = torch.zeros(max(n_count, 4096), dtype=torch.int32,
                            device=device)
        ws = _WORKSPACE[key] = (part, count, part.data_ptr(), count.data_ptr())
    return ws[2], ws[3]


def launch_block(nelems: int, device=None) -> tuple:
    """The elementwise entry's CTA shape ``(threads, ctas)`` for ``nelems``
    elements on ``device``: the active tuning table's ``bitwise/hopper``
    entry for the bucket of the square the elements tile (as the JAX
    package buckets them), else :data:`STATIC_BLOCK`."""
    side = math.isqrt(max(nelems, 1))
    if side * side < nelems:
        side += 1
    tuned = autotune.lookup("bitwise", "hopper", autotune.shape_bucket(side),
                            device)
    return tuned if tuned is not None else STATIC_BLOCK


def afpm_bitwise(x: torch.Tensor, y: torch.Tensor,
                 cfg: AFPMConfig = AFPMConfig(), block=None) -> torch.Tensor:
    """Elementwise AFPM multiply of two equal-shape tensors (any rank) -> fp32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    both on one device, of one shape, contiguous once cast to fp32;
    anything else raises, as does a config the datapath cannot run.
    ``block`` = ``(threads, ctas)`` overrides :func:`launch_block` (a shape
    the kernel cannot launch raises); no shape changes a product."""
    args = _config_args(cfg)
    dev = x.device
    if dev.type == "cpu" and y.device.type == "cpu":
        return afpm_bitwise_plain(x, y, cfg)
    if dev.type != "cuda" or dev != y.device:
        raise ValueError(f"afpm_bitwise needs x and y on one CUDA device (or "
                         f"both on the CPU); got {dev} and {y.device}")
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
    threads, ctas = block or launch_block(out.numel(), dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = _launchers()[0](x.data_ptr(), y.data_ptr(), out.data_ptr(),
                         out.numel(), *args, threads, ctas, dev.index, stream)
    if rc != 0:
        _raise_failed("afpm_bitwise", rc)
    afpm_bitwise.launches += 1
    return out


afpm_bitwise.launches = 0


def emulated_matmul(x: torch.Tensor, w: torch.Tensor,
                    cfg: AFPMConfig = AFPMConfig(),
                    k_chunk: int = 64) -> torch.Tensor:
    """Emulated AFPM matmul ``x (..., K) @ w (K, N) -> (..., N)`` fp32.

    CPU tensors take the plain version (``core/afpm.py::
    afpm_matmul_emulated``).  CUDA tensors launch the kernel: both on one
    device, ``w`` 2-D, contiguous once cast to fp32; anything else raises,
    as does a config the datapath cannot run."""
    args = _config_args(cfg)
    dev = x.device
    if dev.type == "cpu" and w.device.type == "cpu":
        return afpm_matmul_emulated(x, w, cfg, k_chunk)
    if dev.type != "cuda" or dev != w.device:
        raise ValueError(f"emulated_matmul needs x and w on one CUDA device "
                         f"(or both on the CPU); got {dev} and {w.device}")
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"emulated_matmul needs x (..., K) @ w (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("emulated_matmul needs contiguous x and w")
    K, N = w.shape
    rows = x.shape[:-1].numel()
    p = plan(rows, K, N, k_chunk)
    out = torch.empty((*x.shape[:-1], N), dtype=torch.float32, device=dev)
    if rows == 0 or N == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = count = None
    if p.split:
        part, count = _workspace(dev, stream, -(-K // k_chunk) * rows * N,
                                 p.grid[0] * p.grid[1])
    rc = _launchers()[1](x.data_ptr(), w.data_ptr(), out.data_ptr(), part,
                         count, rows, K, N, k_chunk, p.group, p.grid[2],
                         *args, dev.index, stream)
    if rc != 0:
        _raise_failed("emulated_matmul", rc)
    emulated_matmul.launches += 1
    return out


emulated_matmul.launches = 0
