"""The port's emulated AFPM matmul (K2's matmul entry) against the JAX
package, on the CPU.

The same seeded numpy inputs go through
``repro.core.afpm.afpm_matmul_emulated`` and the port's
``repro_torch.kernels.dispatch.emulated_matmul`` (CPU tensors take the plain
version); the kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).  Tolerances: 64 fp32 ulps of the
largest output (both sum a chunk's products in their framework's own
order), 1e-5 of each input's largest gradient (the straight-through
gradients are fp32 matmuls here and elementwise sums in JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import afpm as j_afpm
from repro_torch.core import afpm as t_afpm
from repro_torch.core import numerics as t_numerics
from repro_torch.core.registry import afpm_config, get_multiplier
from repro_torch.kernels import afpm_bitwise as k2
from repro_torch.kernels import custom_ops, dispatch
from repro_torch.numerics import NumericsConfig, numerics_scope

ULP_BOUND = 64


def _jcfg(cfg: t_afpm.AFPMConfig) -> j_afpm.AFPMConfig:
    return j_afpm.AFPMConfig(n=cfg.n, mode=cfg.mode, fmt=cfg.fmt,
                             skip_bd=cfg.skip_bd, conditional=cfg.conditional,
                             compensation=cfg.compensation)


def _operands(seed, xs, K, N):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((*xs, K)), 0).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return x, w


def _assert_within_ulps(got, want, what):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got.astype(np.float64) - want).max()
    tol = ULP_BOUND * np.spacing(np.float32(np.abs(want).max()))
    assert err <= tol, (what, err, tol)


DESIGNS = {
    "AC4-4": afpm_config("AC4-4"), "AC5-5": afpm_config("AC5-5"),
    "AC6-6": afpm_config("AC6-6"), "ACL5": afpm_config("ACL5"),
    "fp16": t_afpm.AFPMConfig(n=5, fmt="fp16"),
    "bf16": t_afpm.AFPMConfig(n=3, fmt="bf16"),
}
# (leading dims of x, K, N): K a multiple of 16 and of 64, K not a
# multiple of either, K below one chunk, leading batch dims
SHAPES = [((12,), 128, 9), ((7,), 100, 10), ((5,), 27, 64), ((2, 3), 70, 6)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
@pytest.mark.parametrize("k_chunk", [16, 64])
@pytest.mark.parametrize("design", list(DESIGNS))
def test_emulated_matmul_matches_jax(design, k_chunk, shape):
    cfg = DESIGNS[design]
    xs, K, N = shape
    x, w = _operands(len(design) + K, xs, K, N)
    want = j_afpm.afpm_matmul_emulated(jnp.asarray(x), jnp.asarray(w),
                                       _jcfg(cfg), k_chunk)
    got = dispatch.emulated_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   cfg, k_chunk)
    _assert_within_ulps(got.numpy(), want, (design, k_chunk, shape))
    # the wrapper's CPU route is the same plain version
    same = k2.emulated_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg,
                              k_chunk)
    assert torch.equal(same, got)


def test_hopper_backend_on_cpu_tensors_raises():
    x, w = torch.ones(3, 8), torch.ones(8, 4)
    with pytest.raises(ValueError, match="hopper"):
        dispatch.emulated_matmul(x, w, backend="hopper")
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.emulated_matmul(x, w, backend="pallas")
    with pytest.raises(ValueError, match="contraction mismatch"):
        dispatch.emulated_matmul(x, torch.ones(7, 4))


@pytest.mark.parametrize("name,reaches", [("AC5-5", True), ("ACL5", True),
                                          ("AC4-4", True), ("MMBS5", False),
                                          ("NC", False), ("AC-fp16", True),
                                          ("AC-bf16", True)])
def test_nmatmul_routes_the_afpm_family_through_dispatch(name, reaches,
                                                         monkeypatch):
    """An emulated AFPM config (AC-n-n / ACL-n at ``seg_n``, an AC-<fmt>
    registry entry at its registered storage format) reaches
    dispatch.emulated_matmul with its backend, with the value the plain
    route gives; a baseline keeps the registry's chunked plain route."""
    calls = []
    real = dispatch.emulated_matmul

    def spy(x, w, cfg, k_chunk=64, *, backend="auto"):
        calls.append((cfg, k_chunk, backend))
        return real(x, w, cfg, k_chunk, backend=backend)

    monkeypatch.setattr(dispatch, "emulated_matmul", spy)
    x, w = _operands(0, (4,), 70, 5)
    n = 4 if name == "AC4-4" else 5
    cfg = NumericsConfig(mode="emulated", multiplier=name, seg_n=n,
                         backend="torch")
    tx = torch.from_numpy(x).requires_grad_()
    with numerics_scope(cfg):
        got = t_numerics.nmatmul(tx, torch.from_numpy(w))
    assert got.shape == (4, 5) and torch.isfinite(got).all()
    registry = t_afpm.chunked_emulated_matmul(
        torch.from_numpy(x), torch.from_numpy(w), get_multiplier(name))
    if not reaches:
        assert calls == [] and torch.equal(got, registry)
    elif name.startswith("AC-"):
        assert calls == [(afpm_config(name), 64, "torch")]
        assert afpm_config(name).fmt == name[3:]
        # the registry route's value, and as there no gradient
        assert torch.equal(got, registry) and got.grad_fn is None
    else:
        assert calls == [(cfg.afpm(), 64, "torch")]
        want = t_afpm.afpm_matmul_emulated(torch.from_numpy(x),
                                           torch.from_numpy(w), cfg.afpm())
        assert torch.equal(got.detach(), want) and got.grad_fn is not None


def test_plan_modes_and_limits():
    # ResNet-18 at batch 8: stage 0's conv fills the card with tiles,
    # stage 3's conv2 (16 tiles) splits its 72 chunks
    whole = k2.plan(8 * 1024, 576, 64)
    assert not whole.split and whole.grid == (128, 1, 1) and whole.group == 9
    split = k2.plan(8 * 16, 4608, 512)
    assert split.split and split.grid[:2] == (2, 8) and split.grid[2] > 1
    assert split.grid[2] * split.group >= 72 > (split.grid[2] - 1) * split.group
    # the timed shapes at 48 images; a split must beat whole mode's waves
    # x chunks a CTA by a tenth
    assert not k2.plan(48 * 1024, 576, 64).split
    assert k2.plan(48 * 16, 4608, 512).split
    assert not k2.plan(48 * 256, 1152, 128).split   # 3 waves either way
    # both modes at M up to 300, so the M-invariance checks on the card
    # hold split-mode rows against whole-mode rows (K 576, and a ragged K
    # at k_chunk 16)
    for K, kc in ((576, 64), (1001, 16)):
        assert k2.plan(200, K, 1600, kc).split
        assert not k2.plan(300, K, 1600, kc).split
    # one chunk never splits, nor does a workspace beyond MAX_SPLIT_BYTES
    assert not k2.plan(8, 64, 10).split
    assert not k2.plan(1 << 16, 1 << 16, 1 << 10, 64).split
    assert k2.plan(3, 0, 5) == k2.Plan(False, 1, (1, 1, 1))
    with pytest.raises(ValueError, match="k_chunk"):
        k2.plan(8, 64, 10, 0)
    with pytest.raises(ValueError, match="out of range"):
        k2.plan(k2.MAX_DIM + 1, 64, 10)
    with pytest.raises(ValueError, match="out of range"):
        k2.plan(8, -1, 10)


@pytest.mark.parametrize("design", ["AC5-5", "ACL5"])
def test_emulated_matmul_grad_matches_jax(design):
    """The emulated-matmul op (its forward the plain version on the CPU) against
    jax.grad of the reference's afpm_matmul_emulated (straight-through)."""
    cfg = DESIGNS[design]
    x, w = _operands(3, (2, 6), 100, 7)
    g = np.random.default_rng(4).standard_normal((2, 6, 7)).astype(np.float32)

    def loss(a, b):
        return jnp.sum(j_afpm.afpm_matmul_emulated(a, b, _jcfg(cfg), 16)
                       * jnp.asarray(g))

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = custom_ops.emulated_matmul(tx, tw, cfg, 16)
    assert out.grad_fn is not None
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (design, err)
