"""Dependency-free safetensors reader/writer + torch-pickle reader.

The port's copy of ``repro.compat.safetensors_io`` (no ``safetensors``
package is needed).  The container is

    [8-byte little-endian u64: N][N bytes of JSON header][raw data]

where the header maps ``name -> {"dtype", "shape", "data_offsets"}``
(offsets relative to the start of the data section) plus an optional
``"__metadata__"`` string->string dict.  Reading is zero-copy: tensors
are ``np.frombuffer`` views into one ``bytes`` object.

Sharded checkpoints follow the HF convention: a
``*.safetensors.index.json`` with ``{"weight_map": {name: shard_file}}``
next to the shard files; :func:`load_checkpoint` accepts a single
``.safetensors`` file, an index file, or a directory holding either.

``bfloat16`` tensors need ``ml_dtypes``; without it they raise a
:class:`CompatError` instead of being mis-decoded.  All malformed-input
paths raise one-line :class:`CompatError`\\ s naming the file.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .state_dict import CompatError

try:  # bfloat16 as a numpy dtype; optional
    import ml_dtypes as _ml_dtypes
except ImportError:
    _ml_dtypes = None

__all__ = ["read_safetensors", "write_safetensors", "load_checkpoint",
           "write_sharded_checkpoint", "read_torch_checkpoint",
           "INDEX_SUFFIX"]

INDEX_SUFFIX = ".safetensors.index.json"

_FIXED_DTYPES = {
    "F64": np.dtype(np.float64), "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "I64": np.dtype(np.int64), "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16), "I8": np.dtype(np.int8),
    "U64": np.dtype(np.uint64), "U32": np.dtype(np.uint32),
    "U16": np.dtype(np.uint16), "U8": np.dtype(np.uint8),
    "BOOL": np.dtype(np.bool_),
}


def _dtype_from_tag(tag: str, path: str) -> np.dtype:
    if tag in _FIXED_DTYPES:
        return _FIXED_DTYPES[tag]
    if tag == "BF16":
        if _ml_dtypes is None:
            raise CompatError(f"{path}: BF16 tensor needs ml_dtypes, which "
                              f"is not installed")
        return np.dtype(_ml_dtypes.bfloat16)
    raise CompatError(f"{path}: unsupported safetensors dtype {tag!r}")


def _tag_from_dtype(dtype: np.dtype, name: str) -> str:
    for tag, dt in _FIXED_DTYPES.items():
        if dtype == dt:
            return tag
    if _ml_dtypes is not None and dtype == np.dtype(_ml_dtypes.bfloat16):
        return "BF16"
    raise CompatError(f"tensor {name!r}: dtype {dtype} has no safetensors "
                      f"encoding")


# ---------------------------------------------------------------------------
# single-file read/write
# ---------------------------------------------------------------------------

def read_safetensors(path) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Read one ``.safetensors`` file -> ``(state_dict, metadata)``.

    Tensors are zero-copy read-only views into the file buffer.
    """
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CompatError(f"{path}: cannot read ({e})") from None
    if len(raw) < 8:
        raise CompatError(f"{path}: truncated ({len(raw)} bytes, need at "
                          f"least an 8-byte header length)")
    hlen = int.from_bytes(raw[:8], "little")
    if 8 + hlen > len(raw):
        raise CompatError(f"{path}: header length {hlen} overruns the "
                          f"{len(raw)}-byte file")
    try:
        header = json.loads(raw[8:8 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CompatError(f"{path}: bad JSON header ({e})") from None
    data = memoryview(raw)[8 + hlen:]

    meta = header.pop("__metadata__", {}) or {}
    sd: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        try:
            dtag, shape = spec["dtype"], tuple(spec["shape"])
            beg, end = spec["data_offsets"]
        except (TypeError, KeyError) as e:
            raise CompatError(f"{path}: tensor {name!r} has a malformed "
                              f"header entry (missing {e})") from None
        dtype = _dtype_from_tag(dtag, path)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if not (0 <= beg <= end <= len(data)) or end - beg != nbytes:
            raise CompatError(f"{path}: tensor {name!r} offsets "
                              f"[{beg}, {end}) do not match dtype {dtag} "
                              f"shape {shape} ({nbytes} bytes)")
        sd[name] = np.frombuffer(data[beg:end], dtype=dtype).reshape(shape)
    return sd, dict(meta)


def write_safetensors(path, sd: Mapping[str, np.ndarray],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write a flat state dict as one ``.safetensors`` file (atomic)."""
    path = os.fspath(path)
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    chunks = []
    offset = 0
    for name in sd:
        arr = np.ascontiguousarray(sd[name])
        tag = _tag_from_dtype(arr.dtype, name)
        buf = arr.tobytes()
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(buf)]}
        chunks.append(buf)
        offset += len(buf)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".st_tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(len(hjson).to_bytes(8, "little"))
            f.write(hjson)
            for buf in chunks:
                f.write(buf)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# sharded checkpoints (HF *.safetensors.index.json convention)
# ---------------------------------------------------------------------------

def write_sharded_checkpoint(directory, sd: Mapping[str, np.ndarray],
                             metadata: Optional[Mapping[str, str]] = None,
                             *, basename: str = "model",
                             max_shard_bytes: int = 1 << 30) -> str:
    """Write ``sd`` as N shard files + an index; returns the index path.

    Shards split greedily at ``max_shard_bytes`` (a tensor never spans
    shards).  Metadata is duplicated into every shard, so any single
    shard — and the whole — is self-describing.
    """
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    groups, cur, cur_bytes = [], [], 0
    for name in sd:
        nbytes = np.asarray(sd[name]).nbytes
        if cur and cur_bytes + nbytes > max_shard_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
    if cur or not groups:
        groups.append(cur)

    n = len(groups)
    weight_map: Dict[str, str] = {}
    total = 0
    for gi, names in enumerate(groups):
        fname = f"{basename}-{gi + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(os.path.join(directory, fname),
                          {k: sd[k] for k in names}, metadata)
        for k in names:
            weight_map[k] = fname
            total += np.asarray(sd[k]).nbytes
    index = {"metadata": {"total_size": total},
             "weight_map": weight_map}
    index_path = os.path.join(directory, basename + INDEX_SUFFIX)
    with open(index_path, "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
    return index_path


def _load_index(index_path) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    index_path = os.fspath(index_path)
    try:
        with open(index_path) as f:
            index = json.load(f)
        weight_map = index["weight_map"]
    except (OSError, json.JSONDecodeError, KeyError) as e:
        raise CompatError(f"{index_path}: bad shard index ({e})") from None
    base = os.path.dirname(index_path)
    sd: Dict[str, np.ndarray] = {}
    meta: Dict[str, str] = {}
    for fname in sorted(set(weight_map.values())):
        shard, smeta = read_safetensors(os.path.join(base, fname))
        sd.update(shard)
        meta.update(smeta)
    missing = [k for k in weight_map if k not in sd]
    if missing:
        raise CompatError(f"{index_path}: shard index names "
                          f"{len(missing)} tensor(s) absent from shards, "
                          f"first {missing[0]!r}")
    return sd, meta


def load_checkpoint(path) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Load a safetensors checkpoint -> ``(state_dict, metadata)``.

    ``path`` may be a single ``.safetensors`` file, a
    ``*.safetensors.index.json`` shard index, or a directory containing
    exactly one of either.
    """
    path = os.fspath(path)
    if os.path.isdir(path):
        entries = sorted(os.listdir(path))
        indexes = [e for e in entries if e.endswith(INDEX_SUFFIX)]
        if len(indexes) == 1:
            return _load_index(os.path.join(path, indexes[0]))
        if len(indexes) > 1:
            raise CompatError(f"{path}: {len(indexes)} shard indexes found "
                              f"({indexes[0]}, ...); pass one explicitly")
        singles = [e for e in entries if e.endswith(".safetensors")]
        if len(singles) == 1:
            return read_safetensors(os.path.join(path, singles[0]))
        raise CompatError(f"{path}: expected one .safetensors file or one "
                          f"{INDEX_SUFFIX} index, found {len(singles)} "
                          f"file(s)")
    if path.endswith(INDEX_SUFFIX):
        return _load_index(path)
    return read_safetensors(path)


# ---------------------------------------------------------------------------
# torch pickle (guarded)
# ---------------------------------------------------------------------------

def read_torch_checkpoint(path) -> Dict[str, np.ndarray]:
    """Read a torch-pickle weights file -> flat numpy state dict (tensors
    only, loaded with ``weights_only=True``)."""
    path = os.fspath(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch raises a zoo of types here
        raise CompatError(f"{path}: torch.load failed ({e})") from None
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise CompatError(f"{path}: expected a state dict, got "
                          f"{type(obj).__name__}")
    sd: Dict[str, np.ndarray] = {}
    for name, t in obj.items():
        if not torch.is_tensor(t):
            continue  # optimizer counters etc.
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            if _ml_dtypes is None:
                raise CompatError(f"{path}: BF16 tensor {name!r} needs "
                                  f"ml_dtypes, which is not installed")
            arr = t.view(torch.uint16).numpy().view(_ml_dtypes.bfloat16)
        else:
            arr = t.numpy()
        sd[str(name)] = arr
    return sd
