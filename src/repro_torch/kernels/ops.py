"""Public wrappers of the kernels (``repro.kernels.ops`` counterpart).

PyTorch runs eagerly, so these are thin shells over the audited entry
points in :mod:`repro_torch.kernels.dispatch`."""
from __future__ import annotations

from repro_torch.core.afpm import AFPMConfig

from . import dispatch


def afpm_matmul(x, w, passes: int = 3, *, backend: str = "auto"):
    """Segmented approximate matmul; batch dims on ``x`` are kept."""
    return dispatch.matmul(x, w, passes, backend=backend)


def afpm_multiply(x, y, cfg: AFPMConfig = AFPMConfig(), *,
                  backend: str = "auto"):
    """Elementwise bit-level AFPM multiply (broadcasting)."""
    return dispatch.multiply(x, y, cfg, backend=backend)


def ssd_scan(x, dt, A, B, C, *, chunk=None, backend: str = "auto"):
    """Chunked Mamba2 SSD scan: (L,H,P),(L,H),(H,),(L,N),(L,N) -> (L,H,P),
    with an optional leading batch dimension; any length (dt = 0 padding).
    ``chunk=None`` takes the substrate's chunk for the resolved backend."""
    return dispatch.ssd(x, dt, A, B, C, chunk=chunk, backend=backend)
