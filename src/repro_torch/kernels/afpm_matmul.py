"""Wrapper of the Hopper segmented matmul kernel (``csrc/afpm_matmul.cu``).

Replaces the TPU kernel ``src/repro/kernels/afpm_matmul.py::
afpm_matmul_pallas``.  :func:`afpm_matmul` launches the CUDA kernel for
CUDA tensors and takes the plain version (:func:`afpm_matmul_plain`) only
for CPU tensors; it never falls back from the kernel.  Every launch adds
one to ``afpm_matmul.launches``.  A placed or differentiated call reaches
it through the custom op ``repro_torch::afpm_matmul`` (:mod:`.custom_ops`),
which DTensor shards by the op's rules.

:func:`plan` chooses the kernel's tiles from ``(M, K, N)``; it never
changes the arithmetic.  K is cut into chunks of :data:`KCHUNK` whatever
M and N are (:func:`chunk_bounds`), so an output element depends only on
its row of x, its column of w and K, and a row's result is the same at
every M.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, autotune, ref

#: K of one chunk (the canonical split of K, folded in order with IEEE
#: adds), as in the source
KCHUNK = 512
#: columns of w a CTA (16 a warp, 4 warps); WIDE_BN (8 warps) for up to
#: 32 rows where the grid still gives every SM two CTAs or more: longer
#: contiguous rows for the memory to stream (at 64 rows a CTA of 8 warps
#: holds a whole SM's registers)
BN = 64
WIDE_BN = 128
#: rows of x a CTA holds (8 * MT, MT n8 tiles); more rows take more CTAs
MAX_TILE_ROWS = 64
#: the grid's y and z extents (chunks, row blocks) are at most this
MAX_GRID_YZ = 65535
#: SMs of an H100
SMS = 132
#: output columns (tiles x BN) below which the tiles alone keep too little
#: of the weight streaming, so K is split: two 64-column tiles an SM
_FILL_COLUMNS = 2 * BN * SMS
#: split mode's workspace (chunks x M x N fp32) is at most this many bytes;
#: a larger one runs whole mode, the same arithmetic in one CTA a tile
MAX_SPLIT_BYTES = 64 << 20
_INT32_MAX = 2 ** 31 - 1


class Plan(NamedTuple):
    """How one call is cut: ``mt`` n8 tiles of rows a CTA (8 * mt rows),
    ``bn`` columns a CTA (16 a warp), ``split`` (one chunk of K a CTA,
    partials folded by the tile's last CTA) or whole mode (every chunk in
    one CTA), and the grid."""
    mt: int
    bn: int
    split: bool
    grid: tuple


def chunk_bounds(K: int) -> list:
    """The canonical K chunks ``[(begin, end), ...]``: a function of K
    alone, the same for every M, N and plan."""
    return [(c, min(K, c + KCHUNK)) for c in range(0, max(K, 1), KCHUNK)]


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, tile=None) -> Plan:
    """The kernel's tiles for ``x (M, K) @ w (K, N)``; raises beyond the
    kernel's limits (M, K and N below 2**31, at most 65535 chunks of K and
    65535 blocks of rows).

    ``tile`` = ``(rows, bn, split)`` bounds the rule's free choices (the
    autotuner's ``matmul/hopper`` block, :mod:`.autotune`): the rows a CTA
    still follow M, up to ``rows`` (8, 16, 32 or 64); ``bn`` 64 keeps every
    tile 64 columns wide, 128 lets the rule widen it; ``split`` 1 keeps
    whole mode, 2 lets the rule split K.  None, or
    :data:`autotune.MATMUL_STATIC`, is the rule untouched."""
    rows, bn_max, split_ok = tile or autotune.MATMUL_STATIC
    if rows not in (8, 16, 32, MAX_TILE_ROWS) or bn_max not in (BN, WIDE_BN) \
            or split_ok not in (1, 2):
        raise ValueError(f"afpm_matmul: bad tile {tile!r}; expected (rows in "
                         f"8/16/32/64, bn in {BN}/{WIDE_BN}, split in 1/2)")
    if min(M, K, N) < 0 or max(M, K, N) > _INT32_MAX:
        raise ValueError(f"afpm_matmul: M, K, N = {M}, {K}, {N} out of range")
    chunks = len(chunk_bounds(K))
    mt = 1
    while mt < rows // 8 and 8 * mt < M:
        mt *= 2
    mblocks = -(-M // (8 * mt))
    if chunks > MAX_GRID_YZ or mblocks > MAX_GRID_YZ:
        raise ValueError(f"afpm_matmul: (M, K) = ({M}, {K}) exceeds the "
                         f"kernel grid ({MAX_GRID_YZ} chunks of {KCHUNK}, "
                         f"{MAX_GRID_YZ} blocks of {8 * mt} rows)")
    split = (split_ok == 2 and chunks > 1 and N * mblocks < _FILL_COLUMNS
             and chunks * M * N * 4 <= MAX_SPLIT_BYTES)
    gy = chunks if split else 1
    bn = (WIDE_BN if bn_max == WIDE_BN and mt <= 4
          and -(-N // WIDE_BN) * gy * mblocks >= 2 * SMS else BN)
    return Plan(mt, bn, split, (-(-N // bn), gy, mblocks))


def tuned_tile(M: int, K: int, N: int, device=None):
    """The active tuning table's ``matmul/hopper`` block for this shape's
    bucket on ``device``, or None (the static rule)."""
    return autotune.lookup("matmul", "hopper", autotune.shape_bucket(M, K, N),
                           device)


def afpm_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      passes: int = 3) -> torch.Tensor:
    """The plain PyTorch version: what the kernel computes, op by op."""
    return ref.afpm_matmul_ref(x, w, passes)


_FN = None
_WORKSPACE: dict = {}   # (device, stream) -> (partials, counters)


def _launcher():
    """The kernel's ctypes function, built, loaded and typed once."""
    global _FN
    if _FN is None:
        lib = _build.load("afpm_matmul")
        fn = lib.afpm_matmul_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        lib.afpm_matmul_error_string.argtypes = [i]
        lib.afpm_matmul_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


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


def afpm_matmul(x: torch.Tensor, w: torch.Tensor, passes: int = 3,
                tile=None) -> torch.Tensor:
    """Segmented matmul ``x (..., M, K) @ w (K, N) -> (..., M, N)`` fp32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel:
    ``x`` fp32 or bf16 and ``w`` fp32, both contiguous and on one device;
    anything else raises.  ``tile`` overrides :func:`tuned_tile` (see
    :func:`plan`); no tile changes an element's arithmetic."""
    dev = x.device
    if dev.type == "cpu" and w.device.type == "cpu":
        return afpm_matmul_plain(x, w, passes)
    if dev.type != "cuda" or dev != w.device:
        raise ValueError(f"afpm_matmul needs x and w on one CUDA device (or "
                         f"both on the CPU); got {dev} and {w.device}")
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if x.dim() < 2 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"need x (..., M, K) @ w (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and x.dtype != torch.float32:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("afpm_matmul needs contiguous x and w")
    K, N = w.shape
    rows = x.shape[:-1].numel()
    x_bytes = 2 if bf16 else 4
    if tile is None:
        tile = tuned_tile(rows, K, N, dev)
    p = plan(rows, K, N, None if tile is None else tuple(tile))
    out = torch.empty((*x.shape[:-1], N), dtype=torch.float32, device=dev)
    if rows == 0 or N == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = count = None
    if p.split:
        part, count = _workspace(dev, stream, p.grid[1] * rows * N,
                                 p.grid[0] * p.grid[2])
    xp, wp = x.data_ptr(), w.data_ptr()
    x_vec = xp % 16 == 0 and (K * x_bytes) % 16 == 0
    w_vec = wp % 16 == 0 and N % 4 == 0
    rc = _launcher()(xp, int(bf16), wp, out.data_ptr(), part, count, rows, K,
                     N, passes, p.mt, p.bn // 16, int(p.split), int(x_vec),
                     int(w_vec), dev.index, stream)
    if rc != 0:
        lib = _build.load("afpm_matmul")
        msg = lib.afpm_matmul_error_string(rc).decode()
        raise RuntimeError(f"afpm_matmul kernel launch failed: {msg} ({rc})")
    afpm_matmul.launches += 1
    return out


afpm_matmul.launches = 0
