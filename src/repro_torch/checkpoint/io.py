"""Fault-tolerant checkpoints (``repro.checkpoint.io`` counterpart), in
the JAX package's on-disk layout, so either package restores the other's.

Layout: ``<dir>/step_<N:09d>/shard_<k>.msgpack.zst`` plus
``MANIFEST.json``, written last: a step directory is written as
``step_<N>.tmp`` and renamed, and only a step with a manifest counts, so a
crash mid-write leaves the previous checkpoint in force.  Old steps are
pruned to the newest ``keep``.

A shard is ``{"version": 1, "leaves": [{"dtype", "shape", "data"}]}`` in
msgpack, the leaves in ``jax.tree`` order (:mod:`repro_torch.tree`: dict
keys sorted, an optimizer state's ``(step, mu, nu)`` in order), each
leaf's raw little-endian bytes (bf16 as its 16-bit pattern).  The port
writes that msgpack subset with its own encoder (:func:`packb`, the bytes
``msgpack.packb(..., use_bin_type=True)`` gives) and compresses with
stdlib ``zlib``.  It reads zstd shards too, where ``zstandard`` imports,
and raises the reference's error where it does not; the codec is told by
the blob's magic bytes whatever the file's suffix.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import time
import zlib

import numpy as np
import torch

from repro_torch import tree as tree_util

_CODEC_VERSION = 1
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


# ---------------------------------------------------------------------------
# msgpack: the subset a shard uses (map, array, str, bin, int, float, bool,
# nil), with msgpack-python's choice of the smallest encoding
# ---------------------------------------------------------------------------

def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj >= 0:
            for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32),
                                   (0xcf, ">Q", 1 << 64)):
                if obj < top:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise OverflowError(f"integer {obj} does not fit msgpack")
        else:
            for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                                   (0xd1, ">h", -(1 << 15)),
                                   (0xd2, ">i", -(1 << 31)),
                                   (0xd3, ">q", -(1 << 63))):
                if obj >= low:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise OverflowError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_head(len(raw), None, 0, (0xc4, 0xc5, 0xc6)) + raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, (None, 0xdc, 0xdd)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, (None, 0xde, 0xdf)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _head(n: int, fix, fix_limit: int, codes) -> bytes:
    """The header of a str, bin, array or map of length ``n``: the fixed
    form below ``fix_limit``, else 8-, 16- or 32-bit lengths."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack length {n} too large")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes, equal to ``msgpack.packb(obj,
    use_bin_type=True)`` for the subset a shard holds."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LENGTH = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
           0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
           0xdc: (">H", "array"), 0xdd: (">I", "array"),
           0xde: (">H", "map"), 0xdf: (">I", "map")}


def unpackb(blob: bytes):
    """The object of msgpack bytes holding map, array, str, bin, int,
    float, bool and nil."""
    view = memoryview(blob)
    pos = 0

    def take(n):
        nonlocal pos
        out = view[pos:pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        pos += n
        return out

    def read():
        b = take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            fmt = _FIXED[b]
            return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]
        if 0xa0 <= b < 0xc0:
            kind, n = "str", b & 0x1f
        elif 0x90 <= b < 0xa0:
            kind, n = "array", b & 0x0f
        elif 0x80 <= b < 0x90:
            kind, n = "map", b & 0x0f
        elif b in _LENGTH:
            fmt, kind = _LENGTH[b]
            n = struct.unpack(fmt, take(struct.calcsize(fmt)))[0]
        else:
            raise ValueError(f"msgpack type 0x{b:02x} is not read here")
        if kind == "str":
            return bytes(take(n)).decode("utf-8")
        if kind == "bin":
            return bytes(take(n))
        if kind == "array":
            return [read() for _ in range(n)]
        return {read(): read() for _ in range(n)}

    obj = read()
    if pos != len(blob):
        raise ValueError("trailing bytes after msgpack data")
    return obj


# ---------------------------------------------------------------------------
# codec and leaves
# ---------------------------------------------------------------------------

def _compress(raw: bytes) -> bytes:
    return zlib.compress(raw, 6)


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise ModuleNotFoundError(
                "checkpoint shard is zstd-compressed but the 'zstandard' "
                "package is not installed; pip install zstandard to restore it"
            ) from None
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.int32: "int32",
              torch.int64: "int64", torch.int8: "int8", torch.uint8: "uint8",
              torch.bool: "bool"}


def _encode_leaf(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"dtype": "bfloat16", "shape": list(t.shape),
                "data": t.view(torch.int16).numpy().tobytes()}
    if t.dtype not in _NP_DTYPES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return {"dtype": _NP_DTYPES[t.dtype], "shape": list(t.shape),
            "data": t.numpy().tobytes()}


def _decode_leaf(d: dict) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        arr = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])
    return torch.from_numpy(arr.copy())


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write a checkpoint of ``tree`` for ``step``; prunes all
    but the newest ``keep``.  One card is one process: shard 0 of 1."""
    step_dir = _step_dir(ckpt_dir, step)
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    payload = {"version": _CODEC_VERSION,
               "leaves": [_encode_leaf(t) for t in tree_util.leaves(tree)]}
    with open(os.path.join(tmp_dir, "shard_0.msgpack.zst"), "wb") as f:
        f.write(_compress(packb(payload)))
    manifest = {"step": step, "time": time.time(), "nshards": 1,
                "extra": extra or {}}
    with open(os.path.join(tmp_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_dir, step_dir)  # atomic commit
    for old in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)
    return step_dir


def all_steps(ckpt_dir: str) -> list:
    """Committed steps (a manifest present), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name[5:]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step_") and not name.endswith(".tmp")
                  and os.path.exists(os.path.join(ckpt_dir, name,
                                                  "MANIFEST.json")))


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like``, each leaf on the device
    of ``tree_like``'s leaf (shapes checked); returns ``(tree,
    manifest)``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoints under {ckpt_dir}")
    step_dir = _step_dir(ckpt_dir, step)
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(step_dir, "shard_0.msgpack.zst"), "rb") as f:
        payload = unpackb(_decompress(f.read()))
    if payload["version"] != _CODEC_VERSION:
        raise ValueError(f"codec version mismatch: {payload['version']}")
    like = tree_util.leaves(tree_like)
    if len(like) != len(payload["leaves"]):
        raise ValueError(f"checkpoint holds {len(payload['leaves'])} leaves, "
                         f"the tree {len(like)}")
    leaves = []
    for i, (d, ref) in enumerate(zip(payload["leaves"], like)):
        t = _decode_leaf(d)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(ref.shape)} in the tree")
        leaves.append(t.to(ref.device))
    return tree_util.unflatten(tree_like, leaves), manifest


# ---------------------------------------------------------------------------
# safetensors interchange (repro_torch.compat)
# ---------------------------------------------------------------------------

def save_safetensors(path, tree, metadata=None):
    """Export a params tree as ONE safetensors file through the compat
    state-dict model: dotted leaf paths, host arrays.  The interchange
    format, readable by any safetensors implementation, not the sharded
    training format; :func:`load_safetensors` reloads it bit for bit."""
    from repro_torch.compat import flatten_tree, write_safetensors

    write_safetensors(path, flatten_tree(tree), metadata)


def load_safetensors(path, tree_like=None, *, cast=False):
    """Load a safetensors checkpoint -> ``(tree, metadata)``.

    With ``tree_like`` (a tree of tensors) the flat state dict is rebuilt
    into its structure, every leaf checked against its shape and dtype
    (``cast=True`` converts dtypes), as tensors on its leaves' devices.
    Without it the flat ``{path: array}`` state dict comes back."""
    from repro_torch.compat import Leaf, load_checkpoint, unflatten_tree

    sd, meta = load_checkpoint(path)
    if tree_like is None:
        return sd, meta
    spec = tree_util.map(lambda t: Leaf(tuple(t.shape),
                                        np.dtype(_NP_DTYPES[t.dtype])),
                         tree_like)
    arrays = unflatten_tree(spec, sd, cast=cast)
    return tree_util.map(lambda a, t: torch.from_numpy(np.array(a)).to(
        t.device), arrays, tree_like), meta
