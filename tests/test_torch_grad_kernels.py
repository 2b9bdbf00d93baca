"""Gradients of the port's kernels (K1, the segmented matmul, and K3, the
SSD scan) against ``jax.grad`` of the JAX package's references.

The JAX package has no backward kernel: ``jax.grad`` differentiates
``repro.kernels.ref.afpm_matmul_ref`` and ``ssd_scan_chunked_ref``.  The
port's custom ops (``repro_torch.kernels.custom_ops``, their backwards in
``repro_torch.kernels.autograd``) run the kernel forward, which on CPU
tensors is the plain version, so the
backward is what these tests hold.  The last tests drive the reduced
qwen3-4b and mamba2-130m losses with the kernel route taken on the CPU
(``dispatch`` told that the operands are the card's), so every segmented
projection and every scan goes through the ops, and hold loss and
gradients to ``jax.value_and_grad`` of the JAX model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.kernels import ref as jref
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.kernels import custom_ops, dispatch
from repro_torch.kernels import ssd_scan as k3
from repro_torch.models import transformer as ttr

# K1's gradient rounds every product's cotangent to bf16, as the
# reference's jaxpr does; the fp32 products are summed in another order on
# each side, so a bf16 rounding may flip: one bf16 ulp of an element,
# 2**-8 of the leaf's largest |g| at most.  Measured: 1.3e-6 / 1.0e-5 /
# 3.6e-4 at passes 1 / 2 / 3, and at least 99% of the elements equal bit
# for bit.
K1_GRAD_BOUND = 2.0 ** -8
K1_EQUAL_SHARE = 0.99
# K3's gradient is fp32 throughout (XLA's autodiff of the chunked
# reference against PyTorch's autograd of the same dots): sum-order ulps,
# held to 1e-5 of the leaf's largest |g| (measured 2.5e-7 and 4.3e-7)
K3_GRAD_BOUND = 1e-5
# A model's gradients per leaf, in units of the leaf's largest |g|: the
# exact and segmented projections round their cotangents to bf16 on both
# sides, but fp32 sums in other orders flip such roundings (one bf16 ulp,
# 2**-8 of an element), and attention's backward rounds at other places
# (the port differentiates its forward, the reference runs a custom VJP).
# Measured over the cases here: 5.8e-3 at most (qwen3 attn.wq), below 4e-3
# for mamba2.
MODEL_GRAD_BOUND = 2.0 ** -6
# losses: fp32 sums in other orders over a few hundred tokens
LOSS_RTOL = 1e-5


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_segmented_matmul_grad_matches_jax(passes, x_dtype):
    rng = np.random.default_rng(passes)
    x = rng.standard_normal((3, 17, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 48)) * 0.1).astype(np.float32)
    g = rng.standard_normal((3, 17, 48)).astype(np.float32)

    xj = jnp.asarray(x).astype(x_dtype)
    dxj, dwj = jax.grad(
        lambda a, b: jnp.sum(jref.afpm_matmul_ref(a, b, passes) * g),
        argnums=(0, 1))(xj, jnp.asarray(w))

    xt = torch.tensor(x).to(getattr(torch, x_dtype)).requires_grad_(True)
    wt = torch.tensor(w).requires_grad_(True)
    out = custom_ops.segmented_matmul(xt, wt, passes)
    (out * torch.tensor(g)).sum().backward()

    assert xt.grad.dtype == xt.dtype
    for got, want in ((xt.grad.float().numpy(), np.asarray(dxj, np.float32)),
                      (wt.grad.numpy(), np.asarray(dwj))):
        assert _rel(got, want) <= K1_GRAD_BOUND
        assert np.mean(got == want) >= K1_EQUAL_SHARE


def test_segmented_matmul_forward_is_the_kernel_wrapper(monkeypatch):
    """The op's forward is K1's wrapper (on the card: the kernel),
    never the plain route chosen because a tensor requires grad."""
    calls = []
    real = custom_ops.afpm_matmul

    def counted(x, w, passes, tile=None):
        calls.append(passes)
        return real(x, w, passes, tile)

    monkeypatch.setattr(custom_ops, "afpm_matmul", counted)
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.randn(64, 8, requires_grad=True)
    custom_ops.segmented_matmul(x, w, 3).sum().backward()
    with torch.no_grad():
        custom_ops.segmented_matmul(x, w, 2)
    assert calls == [3, 2]
    assert x.grad is not None and w.grad is not None


@pytest.mark.parametrize("L,H,P,N,chunk,batch", [
    (48, 3, 8, 16, 16, 2),
    (64, 2, 16, 8, 64, 1),
])
def test_ssd_scan_grad_matches_jax(L, H, P, N, chunk, batch):
    rng = np.random.default_rng(L)
    x = rng.standard_normal((batch, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (batch, L, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    B = rng.standard_normal((batch, L, N)).astype(np.float32)
    C = rng.standard_normal((batch, L, N)).astype(np.float32)
    g = rng.standard_normal((batch, L, H, P)).astype(np.float32)

    def jloss(x, dt, A, B, C):
        y = jax.vmap(lambda a, d, b, c: jref.ssd_scan_chunked_ref(
            a, d, A, b, c, chunk))(x, dt, B, C)
        return jnp.sum(y * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in (x, dt, A, B, C)))
    ins = [torch.tensor(t, requires_grad=True) for t in (x, dt, A, B, C)]
    y = custom_ops.ssd(*ins, chunk)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        k3.ssd_scan_plain(*(t.detach() for t in ins), chunk).numpy())
    (y * torch.tensor(g)).sum().backward()
    for t, w in zip(ins, want):
        assert _rel(t.grad.numpy(), np.asarray(w)) <= K3_GRAD_BOUND


def test_ssd_scan_grad_only_where_asked():
    """Inputs that do not require grad get none, and the others still do."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 32, 2, 4)), dtype=torch.float32,
                     requires_grad=True)
    dt = torch.full((1, 32, 2), 0.1)
    A = torch.tensor([-1.0, -0.5])
    B = torch.randn(1, 32, 8)
    C = torch.randn(1, 32, 8, requires_grad=True)
    custom_ops.ssd(x, dt, A, B, C, 16).sum().backward()
    assert x.grad is not None and C.grad is not None
    assert dt.grad is None and B.grad is None


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route of ``dispatch`` on CPU tensors: the ops run, with
    the kernels' plain forward (their wrappers' CPU branch)."""
    counts = {"matmul": 0, "ssd": 0}
    for name, key in (("segmented_matmul", "matmul"), ("ssd", "ssd")):
        def counted(*a, _real=getattr(custom_ops, name), _key=key):
            counts[_key] += 1
            return _real(*a)

        monkeypatch.setattr(custom_ops, name, counted)
    monkeypatch.setattr(dispatch, "resolve_backend",
                        lambda backend, x: "hopper")
    return counts


@pytest.mark.parametrize("arch,mode", [
    ("qwen3-4b", "segmented3"), ("qwen3-4b", "segmented1"),
    ("mamba2-130m", "exact"), ("mamba2-130m", "segmented3"),
    ("mamba2-130m", "segmented2")])
def test_model_loss_and_grads_through_the_functions(arch, mode, kernel_route):
    jcfg = jax_get_arch(arch).reduced()
    tcfg = get_arch(arch).reduced()
    if mode != "exact":
        passes = int(mode[-1])
        jcfg = dataclasses.replace(jcfg, numerics=JaxNumerics(
            mode="segmented", seg_passes=passes, backend="xla"))
        tcfg = dataclasses.replace(tcfg, numerics=NumericsConfig(
            mode="segmented", seg_passes=passes))
    jparams, _ = unzip(jtr.init(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    batch = lm_batch(DataConfig(vocab=tcfg.vocab, seq_len=24,
                                global_batch=4, seed=1), 0)

    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    for p in tree_util.leaves(params):
        p.requires_grad_(True)
    loss = ttr.loss_fn(params, tcfg, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    loss.backward()

    n_layers = tcfg.n_layers
    # every tier runs K1 (the exact tier at one pass), and so does the LM
    # head: in the loss chunk's forward and in its recompute
    per_block = 2 if arch == "mamba2-130m" else 7
    assert kernel_route["matmul"] == per_block * n_layers + 2
    assert kernel_route["ssd"] == (n_layers if arch == "mamba2-130m" else 0)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for (name, want), p in zip(tree_util.named(
            jax.tree.map(np.asarray, jgrads)), tree_util.leaves(params)):
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert _rel(p.grad.numpy(), want) <= MODEL_GRAD_BOUND, name
