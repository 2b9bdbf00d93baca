"""Batch invariance of the serving path: a row's result does not depend on
the rows it shares a call with, so every tier's served tokens equal a solo
``Session.generate``.

- the JAX package's exact ``nmatmul`` is its segmented1 (``xla``) bit for
  bit, and so is the port's, forward and gradient: the exact tier runs the
  segmented matmul at one pass (K1 on the card), whose CPU plain version is
  the exact tier's former expression, forward and gradient bit for bit;
- the fp64 sites of :func:`repro_torch.models.layers.fp64_sums`
  (``rmsnorm``, the blockwise attention, the MoE router) give a row the
  same bits at M = 1, 4 and 32, and a chunk of queries over a longer
  gathered cache the whole prefill's rows;
- the engine's tokens equal the solo generate's under all three tiers for
  zamba2-7b (SSD blocks and a shared attention block) and deepseek-v3
  (MLA, MoE), reduced;
- the training loss takes no fp64 sums.

Whole-model logits are not held bit for bit here: the plain versions on
the CPU are ``torch.matmul``, whose rows depend on the row count at some
shapes; on the card the products are K1's, and ``chip_smoke.py`` probes
the model's rows there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.numerics import nmatmul as jax_nmatmul
from repro.numerics import numerics_scope as jax_numerics_scope
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.models import attention, moe
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import fp64_sums, rmsnorm
from repro_torch.numerics import nmatmul, numerics_scope
from repro_torch.serving import DEFAULT_TIERS
from repro_torch.session import Session

EXACT = NumericsConfig(mode="exact")
SEG1 = NumericsConfig(mode="segmented", seg_passes=1)
ROWS = (1, 4, 32)


def _operands(rng, lead=(2, 16), K=96, N=40):
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    g = rng.standard_normal((*lead, N)).astype(np.float32)
    return x, w, g


def test_jax_exact_nmatmul_is_its_segmented1(rng):
    x, w, _ = _operands(rng)
    out = {}
    for name, cfg in (("exact", JaxNumerics(mode="exact")),
                      ("seg1", JaxNumerics(mode="segmented", seg_passes=1,
                                           backend="xla"))):
        with jax_numerics_scope(cfg):
            out[name] = np.asarray(jax_nmatmul(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(out["exact"], out["seg1"])


def _forward_backward(fn, x, w, g, dtype=torch.float32):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = fn(xt, wt)
    out.backward(torch.tensor(g))
    return out.detach(), xt.grad, wt.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_exact_tier_is_segmented1_and_its_former_expression(rng, dtype):
    """Forward and both gradients bit for bit: the exact tier, segmented1,
    and the exact tier's former expression (an fp32 matmul of the
    bf16-rounded operands under autograd: ``bf16(g @ bf16(w)^T)`` and
    ``bf16(bf16(x)^T @ g)``)."""
    x, w, g = _operands(rng)
    bf, f = torch.bfloat16, torch.float32

    def under(cfg):
        def fn(a, b):
            with numerics_scope(cfg):
                return nmatmul(a, b)
        return fn

    got = _forward_backward(under(EXACT), x, w, g, dtype)
    for want in (_forward_backward(under(SEG1), x, w, g, dtype),
                 _forward_backward(lambda a, b: torch.matmul(
                     a.to(bf).to(f), b.to(bf).to(f)), x, w, g, dtype)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_fp32_exact_configs_keep_the_fp32_matmul(rng):
    x, w, _ = _operands(rng)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with numerics_scope(NumericsConfig(mode="exact", compute_dtype="float32")):
        assert torch.equal(nmatmul(xt, wt), torch.matmul(xt, wt))


def _rows_equal(fn, n_max):
    """``fn(m)``'s rows (first axis) equal the same rows of ``fn(n_max)``
    at every M of :data:`ROWS`, bit for bit, rounded to fp32 as callers
    round them."""
    full = fn(n_max).to(torch.float32)
    for m in ROWS:
        assert torch.equal(fn(m).to(torch.float32), full[:m]), m


def test_rmsnorm_rows_under_the_serving_sums(rng):
    x = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    scale = {"scale": torch.from_numpy(
        rng.standard_normal(64).astype(np.float32))}
    with fp64_sums():
        _rows_equal(lambda m: rmsnorm(scale, x[:m]), 40)
        # fp64 sums, one rounding: an fp64 input's result, rounded
        assert torch.equal(rmsnorm(scale, x),
                           rmsnorm(scale, x.double()).float())


def _qkv(rng, S, H=4, D=32):
    return [torch.from_numpy(rng.standard_normal((1, S, H, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def test_blockwise_rows_under_the_serving_sums(rng):
    q, k, v = _qkv(rng, 40)
    with fp64_sums():
        assert attention._blockwise(q, k, v).dtype == torch.float64
        _rows_equal(lambda m: attention._blockwise(q[:, :m], k, v)[0], 40)
    # the fp32 form (training) is left as it was: fp32 out
    assert attention._blockwise(q, k, v).dtype == torch.float32


@pytest.mark.parametrize("window,cap", [(None, None), (8, 50.0)],
                         ids=["global", "local-softcap"])
def test_blockwise_chunk_over_a_longer_cache_equals_the_whole_prefill(
        rng, window, cap):
    """A chunk of queries at positions [a, a + c) over a gathered cache of
    64 rows (the prompt's 40, zeros after: masked keys) gives the whole
    40-token prefill's rows, bit for bit once rounded."""
    q, k, v = _qkv(rng, 40)
    cache = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 24)) for t in (k, v)]
    kw = dict(window=window, attn_cap=cap)
    with fp64_sums():
        whole = attention._blockwise(q, k, v, **kw).to(torch.float32)
        for a, c in ((0, 7), (7, 13), (20, 20), (39, 1)):
            part = attention._blockwise(q[:, a:a + c], *cache, q_offset=a,
                                        **kw).to(torch.float32)
            assert torch.equal(part, whole[:, a:a + c]), (a, c)


def test_router_rows_under_the_serving_sums(rng):
    cfg = get_arch("deepseek-v3-671b").reduced()
    router = torch.from_numpy(rng.standard_normal(
        (cfg.d_model, cfg.moe.n_experts)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 40, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)

    def gates(m):
        gate, eidx, _, _ = moe._route(x[:, :m], router, cfg,
                                      moe.capacity(cfg, m))
        return torch.cat([gate[0], eidx[0].to(torch.float32)], dim=-1)

    with fp64_sums():
        _rows_equal(gates, 40)


@pytest.mark.parametrize("arch,chunk", [("zamba2-7b", None),
                                        ("deepseek-v3-671b", 16)])
def test_engine_equals_solo_under_every_tier(arch, chunk, rng):
    """Reduced zamba2-7b (whole-prompt prefill: per-slot SSD states) and
    deepseek-v3 (MLA's paged latent cache, MoE routed whole: chunks of 16
    hold every prompt) served under premium, standard and bulk at once."""
    sess = Session(arch, device="cpu")
    eng = sess.serving_engine(slots=2, max_len=24, prefill_chunk=chunk)
    reqs = [eng.submit(rng.integers(0, 256, n), tier=t.name,
                       max_new_tokens=4)
            for n, t in zip((5, 9, 7, 12, 6, 10), DEFAULT_TIERS * 2)]
    eng.run()
    policy = {t.name: t.policy for t in DEFAULT_TIERS}
    for r in reqs:
        solo = sess.replace(policy=policy[r.tier]).generate(
            prompts=r.prompt[None], gen_len=4)
        np.testing.assert_array_equal(r.result(), solo.tokens[0],
                                      err_msg=f"{r.id} ({r.tier})")


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v3-671b"])
def test_training_loss_takes_no_fp64_sums(arch, rng):
    sess = Session(arch, device="cpu")
    tokens = torch.as_tensor(rng.integers(0, 256, (2, 17)))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    want = ttr.loss_fn(sess.params, sess.config, batch)
    with fp64_sums():
        got = ttr.loss_fn(sess.params, sess.config, batch)
    assert torch.equal(got, want)
