"""Build the CUDA kernels from the package's own sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library goes to ``build/repro_torch/`` at the repository root, named by a
hash of its source and flags, so an edited source rebuilds and an
unchanged one is reused.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelBuildError("no CUDA toolkit found (CUDA_HOME unset and "
                               "no nvcc on PATH); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None when its library is current)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out


def _finish(job) -> str:
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict:
    """Build every stale kernel library, one nvcc per source, all started
    together; returns ``{name: compiler output}`` for the ones built."""
    jobs = [j for j in (_start(n) for n in sources()) if j is not None]
    logs, err = {}, None
    for job in jobs:   # wait for every nvcc, even after one failed
        try:
            logs[job[0]] = _finish(job)
        except KernelBuildError as e:
            err = err or e
    if err is not None:
        raise err
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
