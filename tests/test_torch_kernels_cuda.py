"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Marked ``cuda``: they skip without an NVIDIA GPU.  This file imports only
torch and numpy, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import afpm_matmul as k1

# ulps of the largest output magnitude (as in tests/test_backend_fuzz.py):
# the kernel and the plain version sum over K in different orders
ULP_BOUND = 64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with sm_90a and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_afpm_matmul_kernel_matches_plain(passes, rng):
    _need_card()
    for xs, ws in [((4, 2560), (2560, 1024)), ((32, 9728), (9728, 2560)),
                   ((3, 5, 2500), (2500, 1000)), ((1, 7), (7, 5))]:
        x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal(ws).astype(np.float32)).cuda()
        for xx in (x, x.to(torch.bfloat16)):
            before = k1.afpm_matmul.launches
            got = k1.afpm_matmul(xx, w, passes)
            torch.cuda.synchronize()
            assert k1.afpm_matmul.launches == before + 1
            want = k1.afpm_matmul_plain(xx, w, passes)
            scale = want.abs().max().item()
            tol = ULP_BOUND * np.spacing(np.float32(scale))
            err = (got - want).abs().max().item()
            assert got.shape == want.shape and err <= tol, (xs, xx.dtype, err)


@pytest.mark.cuda
def test_afpm_matmul_kernel_rejects_what_it_does_not_take():
    _need_card()
    x = torch.zeros(4, 8, device="cuda")
    w = torch.zeros(8, 8, device="cuda")
    with pytest.raises(TypeError):
        k1.afpm_matmul(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        k1.afpm_matmul(x, w.t())
    with pytest.raises(ValueError, match="one CUDA device"):
        k1.afpm_matmul(x, w.cpu())
