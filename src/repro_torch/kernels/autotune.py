"""Measure-and-cache kernel autotuner (``repro.kernels.autotune`` counterpart).

The port's kernels take their launch shapes from static rules: K1's tiles
from :func:`repro_torch.kernels.afpm_matmul.plan`, K2's elementwise CTA
shape from :data:`repro_torch.kernels.afpm_bitwise.STATIC_BLOCK`, K3's
chunk from :data:`repro_torch.kernels.dispatch.SCAN_CHUNKS`.  This module
is their measured replacement, as in the JAX package:

- :func:`sweep` times a small candidate grid per ``(kernel, backend,
  shape bucket)`` through an injected ``measure_fn`` (a callable returning
  a time, e.g. a median in microseconds) and records the winner per key;
- the winners persist as a versioned JSON artifact
  (``TUNE_<device_kind>.json``, schema :data:`SCHEMA`) written atomically;
- :func:`activate` installs a table process-wide; the kernels' wrappers
  consult it through :func:`lookup` and fall back to their static choice
  when no entry (or no table) exists.  A table tuned on another device
  kind never applies: :func:`lookup` keys on the operand's own device.

Tuning is never implicit: nothing on a call's path measures anything.
Activation is an explicit opt-in: the :data:`ENV_VAR` environment
variable, ``Session(tune=...)`` / ``--tune``, or :func:`activate`.  With no
table active every call takes its static launch shape, so its bits are
those of the untuned port.  No candidate changes a result's arithmetic
except the SSD chunk (a chunk of another length sums in another order, so
K3 candidates agree within the kernel's 64-ulp bound, not bit for bit).

The port's backends are ``hopper`` (the CUDA kernels) and ``torch`` (the
plain versions).  The blocks of each kernel:

- ``matmul`` (K1, ``hopper``): ``(rows, bn, split)``: the most rows a CTA
  holds (8, 16, 32 or 64; the rows a CTA still follow M up to that cap),
  the widest column tile (64, or 128 where the static rule takes it: at
  most 32 rows a CTA and two CTAs an SM), and split mode's permission (1:
  whole mode always, 2: split K where the static rule does);
- ``bitwise`` (K2's elementwise entry, ``hopper``): ``(threads, ctas)``,
  the threads a CTA and the most CTAs of its grid-stride loop;
- ``ssd`` (K3, ``hopper`` and the plain route ``torch``): the chunk.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Callable, Mapping, Optional, Sequence

#: Versioned schema tag written into every tuning artifact; loaders
#: refuse tables whose tag does not match.
SCHEMA = "repro-tune/1"

#: Environment variable naming a tuning artifact to activate lazily on the
#: first lookup.
ENV_VAR = "REPRO_TUNE_FILE"

KERNELS = ("matmul", "bitwise", "ssd")
BACKENDS = ("hopper", "torch")
BUCKETS = ("small", "medium", "large")
#: the JAX package's backend names: its artifacts do not apply here
JAX_BACKENDS = ("pallas", "interpret", "xla")


class TuneError(Exception):
    """Structured autotuner failure: bad artifact, bad key, bad grid."""


def shape_bucket(*dims: int) -> str:
    """Bucket a shape by its largest extent: small / medium / large."""
    m = max(dims) if dims else 0
    if m <= 256:
        return "small"
    if m <= 1024:
        return "medium"
    return "large"


def _sanitize(kind: str) -> str:
    return "_".join("".join(ch if ch.isalnum() else " " for ch in
                            kind.lower()).split()) or "none"


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    import torch

    return _sanitize(torch.cuda.get_device_name(index))


def device_kind(device=None) -> str:
    """The kind of ``device`` (a ``torch.device`` or its name), sanitised
    for filenames: a CUDA device's name (``NVIDIA H100 80GB HBM3`` ->
    ``nvidia_h100_80gb_hbm3``), ``cpu`` for anything else."""
    import torch

    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "cpu"
    return _cuda_kind(torch.cuda.current_device() if dev.index is None
                      else dev.index)


def artifact_name(device: Optional[str] = None) -> str:
    """Default artifact filename for a device kind: ``TUNE_<device>.json``."""
    return f"TUNE_{device or device_kind()}.json"


def entry_key(kernel: str, backend: str, bucket: str) -> str:
    """The table key ``kernel/backend/bucket`` (validated)."""
    if kernel not in KERNELS:
        raise TuneError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
    if backend not in BACKENDS:
        jax = " (a JAX package backend)" if backend in JAX_BACKENDS else ""
        raise TuneError(f"unknown backend {backend!r}{jax}; expected "
                        f"{'/'.join(BACKENDS)}")
    if bucket not in BUCKETS:
        raise TuneError(f"unknown bucket {bucket!r}; expected one of {BUCKETS}")
    return f"{kernel}/{backend}/{bucket}"


# -- candidate grids ---------------------------------------------------------
#
# Hopper's own grids, each holding the static choice first.  K1's entry
# is keyed on shape_bucket, which takes the largest extent: every LM
# projection lands in "large" whatever its M, so a K1 block caps the rows
# a CTA and never fixes them.

#: K1's static choice: the rule of ``afpm_matmul.plan`` untouched
MATMUL_STATIC = (64, 128, 2)
_MATMUL_GRID = [MATMUL_STATIC, (64, 64, 2), (64, 128, 1), (32, 128, 2),
                (16, 128, 2), (32, 64, 2)]
MATMUL_CANDIDATES = {"hopper": {b: list(_MATMUL_GRID) for b in BUCKETS}}

#: K2's static choice: 256 threads a CTA, at most 4096 CTAs
BITWISE_STATIC = (256, 4096)
_BITWISE_GRID = [BITWISE_STATIC, (128, 4096), (64, 4096), (256, 1056),
                 (256, 16384), (128, 16384)]
BITWISE_CANDIDATES = {"hopper": {b: list(_BITWISE_GRID) for b in BUCKETS}}

#: the JAX package's chunk grids: ``hopper`` takes its ``pallas`` rows,
#: ``torch`` its ``xla`` rows (each holds dispatch.SCAN_CHUNKS' choice)
SSD_CANDIDATES = {
    "hopper": {"small": [64, 128, 256], "medium": [64, 128, 256],
               "large": [128, 256, 512]},
    "torch": {"small": [32, 64, 128], "medium": [64, 128, 256],
              "large": [128, 256, 512]},
}

_GRIDS = {"matmul": MATMUL_CANDIDATES, "bitwise": BITWISE_CANDIDATES,
          "ssd": SSD_CANDIDATES}


def tunable(kernel: str, backend: str) -> bool:
    """Whether (kernel, backend) has a launch knob at all (the plain
    versions of K1 and K2 take none)."""
    return kernel in _GRIDS and backend in _GRIDS[kernel]


def candidates(kernel: str, backend: str, bucket: str,
               max_extent: Optional[int] = None) -> list:
    """The candidate blocks of one table key.  ``max_extent`` drops SSD
    chunks longer than the measured sequence (``Q = min(chunk, L)`` would
    repeat a candidate); K1's and K2's blocks are launch shapes, not
    extents, and are never dropped."""
    entry_key(kernel, backend, bucket)  # validate names
    if not tunable(kernel, backend):
        raise TuneError(f"kernel {kernel!r} has no tunable block on the "
                        f"{backend!r} backend")
    grid = list(_GRIDS[kernel][backend][bucket])
    if max_extent is not None and kernel == "ssd":
        grid = [c for c in grid if c <= max_extent] or grid[:1]
    return grid


# -- the table ---------------------------------------------------------------

@dataclasses.dataclass
class TuningTable:
    """One device kind's measured winners.

    ``entries`` maps :func:`entry_key` strings to ``{"block": [...]|int,
    "median_us": float, "candidates": {...}}``: the winner and every
    candidate's measured time, so a diff shows why a block was chosen."""

    device: str
    entries: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def lookup(self, kernel: str, backend: str, bucket: str):
        """The tuned block for a key (a tuple, or an int chunk), or None."""
        e = self.entries.get(f"{kernel}/{backend}/{bucket}")
        if e is None:
            return None
        block = e["block"]
        return tuple(block) if isinstance(block, list) else block

    def put(self, kernel: str, backend: str, bucket: str, block,
            median_us: float, measured: Optional[Mapping] = None) -> None:
        self.entries[entry_key(kernel, backend, bucket)] = {
            "block": list(block) if isinstance(block, (tuple, list)) else block,
            "median_us": float(median_us),
            "candidates": {_block_label(b): float(us)
                           for b, us in (measured or {}).items()},
        }

    def to_dict(self) -> dict:
        return {"schema": SCHEMA, "device": self.device,
                "meta": self.meta, "entries": self.entries}

    @classmethod
    def from_dict(cls, data: Mapping, source: str = "<dict>") -> "TuningTable":
        if not isinstance(data, Mapping):
            raise TuneError(f"{source}: tuning artifact is not a JSON object")
        schema = data.get("schema")
        if schema != SCHEMA:
            raise TuneError(f"{source}: schema {schema!r} does not match "
                            f"{SCHEMA!r}; regenerate with autotune.sweep")
        device = data.get("device")
        if not isinstance(device, str) or not device:
            raise TuneError(f"{source}: malformed artifact: missing 'device'")
        entries = data.get("entries")
        if not isinstance(entries, Mapping):
            raise TuneError(f"{source}: malformed artifact: missing 'entries'")
        for key, e in entries.items():
            parts = key.split("/")
            if len(parts) != 3:
                raise TuneError(f"{source}: malformed entry key {key!r} "
                                f"(expected kernel/backend/bucket)")
            try:
                entry_key(*parts)
            except TuneError as err:
                raise TuneError(f"{source}: entry {key!r}: {err}") from None
            if not isinstance(e, Mapping) or "block" not in e \
                    or "median_us" not in e:
                raise TuneError(f"{source}: malformed entry {key!r}: expected "
                                f"{{block, median_us, candidates}}")
            block = e["block"]
            if isinstance(block, list):
                if not block or not all(isinstance(d, int) and d > 0
                                        for d in block):
                    raise TuneError(f"{source}: entry {key!r}: bad block "
                                    f"{block!r}")
            elif not (isinstance(block, int) and block > 0):
                raise TuneError(f"{source}: entry {key!r}: bad block "
                                f"{block!r}")
        meta = data.get("meta")
        return cls(device=device, entries=dict(entries),
                   meta=dict(meta) if isinstance(meta, Mapping) else {})

    def save(self, path: str) -> None:
        """Atomic write (temp file + ``os.replace``): an interrupted sweep
        never leaves a half-written artifact behind."""
        path = os.fspath(path)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _block_label(block) -> str:
    if isinstance(block, (tuple, list)):
        return "x".join(str(d) for d in block)
    return str(block)


def load(path: str) -> TuningTable:
    """Load and validate a tuning artifact (one-line :class:`TuneError`)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as e:
        raise TuneError(f"cannot read tuning artifact {path!r}: "
                        f"{e.strerror or e}") from e
    except json.JSONDecodeError as e:
        raise TuneError(f"unreadable tuning artifact {path!r}: {e}") from e
    return TuningTable.from_dict(data, source=path)


# -- process-wide activation (what the wrappers consult) ---------------------

_active: Optional[TuningTable] = None
_source: Optional[str] = None
_env_checked = False


def activate(spec=None) -> Optional[TuningTable]:
    """Install a tuning table process-wide.

    ``spec`` is a :class:`TuningTable`, a path to an artifact, or None
    (activate :data:`ENV_VAR` if set, else keep the current state).
    Returns the active table (or None)."""
    global _active, _source, _env_checked
    _env_checked = True
    if spec is None:
        path = os.environ.get(ENV_VAR)
        if not path:
            return _active
        spec = path
    if isinstance(spec, TuningTable):
        _active, _source = spec, "<in-memory>"
    else:
        path = os.fspath(spec)
        _active, _source = load(path), path
    return _active


def deactivate() -> None:
    """Drop the active table: every call takes its static launch shape."""
    global _active, _source, _env_checked
    _active, _source, _env_checked = None, None, False


def active_table() -> Optional[TuningTable]:
    return _active


def active_source() -> Optional[str]:
    """Where the active table came from (path or ``<in-memory>``)."""
    return _source


def lookup(kernel: str, backend: str, bucket: str, device=None):
    """The tuned block for a key on ``device`` (the operand's device;
    None is the CPU), or None to take the static choice.  A pure cache
    read: it never measures and never builds.  A table tuned for another
    device kind never applies."""
    global _env_checked
    if _active is None:
        if _env_checked or not os.environ.get(ENV_VAR):
            return None
        activate(os.environ[ENV_VAR])
    table = _active
    if table is None or table.device != device_kind(device):
        return None
    return table.lookup(kernel, backend, bucket)


# -- the sweep core ----------------------------------------------------------

def sweep(measure_fn: Callable, *, kernels: Sequence[str] = KERNELS,
          backends: Sequence[str] = BACKENDS,
          buckets: Sequence[str] = BUCKETS,
          sizes: Optional[Mapping[str, int]] = None,
          device: Optional[str] = None, meta: Optional[dict] = None,
          verbose: bool = False) -> TuningTable:
    """Measure every candidate and cache the winners as a TuningTable.

    ``measure_fn(kernel, backend, bucket, block, size) -> time`` owns
    problem construction and timing.  ``sizes`` maps bucket ->
    representative extent (given to ``measure_fn``, and the SSD grid's
    clip).  Untunable (kernel, backend) pairs are skipped.  ``device`` is
    the table's device kind (default: that of the current CUDA device, or
    ``cpu``)."""
    if device is None:
        import torch

        device = device_kind("cuda" if torch.cuda.is_available() else "cpu")
    sizes = dict(sizes or {})
    table = TuningTable(device=device, meta=dict(meta or {}))
    for kernel in kernels:
        for backend in backends:
            if not tunable(kernel, backend):
                continue
            for bucket in buckets:
                size = sizes.get(bucket)
                measured = {}
                for block in candidates(kernel, backend, bucket,
                                        max_extent=size):
                    measured[tuple(block) if isinstance(block, list)
                             else block] = float(
                        measure_fn(kernel, backend, bucket, block, size))
                winner = min(measured, key=measured.get)
                table.put(kernel, backend, bucket, winner, measured[winner],
                          measured)
                if verbose:
                    print(f"[autotune] {entry_key(kernel, backend, bucket)}"
                          f": {_block_label(winner)} "
                          f"({measured[winner]:.1f} us over "
                          f"{len(measured)} candidates)")
    return table
