"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the same numpy params and gradients, a few steps.

Both sides compute in fp32 with the same formulas in the same order; the
global norm is summed in another order (the port sums each leaf in pieces
on its device), so the clip scale and everything after it may differ by
an ulp.  Adam then amplifies that little: held within a few fp32 ulps of
the largest param.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jfac
from repro.optim import adamw as jadam
from repro.optim import compression as jcomp
from repro_torch import tree as tree_util
from repro_torch.optim import adafactor as tfac
from repro_torch.optim import adamw as tadam
from repro_torch.optim import compression as tcomp

# params and moments after a few steps, in units of the largest |value|:
# ulps of the clip scale.  Measured: AdamW params 2.5e-8 and moments equal
# bit for bit where the clip is not reached, params 5.1e-8 and moments
# 2.7e-7 where it is; Adafactor params 1.0e-7, moments 2.2e-7
PARAM_BOUND = 1e-6
# the schedule's fp32 arithmetic, one op at a time on both sides; cos on
# each side may differ by an ulp
LR_RTOL = 1e-6


def _params(rng):
    return {"blk": {"w": rng.standard_normal((130, 140)).astype(np.float32),
                    "b": rng.standard_normal((140,)).astype(np.float32)},
            "stack": rng.standard_normal((3, 130, 129)).astype(np.float32),
            "scale": rng.standard_normal((7,)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _max_rel(jtree, ttree) -> float:
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    got = [t.float().numpy() for t in tree_util.leaves(ttree)]
    top = max(np.max(np.abs(w), initial=0.0) for w in want)
    return max(float(np.max(np.abs(g.astype(np.float32)
                                   - w.astype(np.float32)), initial=0.0))
               for g, w in zip(got, want)) / top


def _run(jmod, tmod, jcfg, tcfg, steps=4, gscale=0.3, seed=0):
    rng = np.random.default_rng(seed)
    P = _params(rng)
    pj = jax.tree.map(jnp.asarray, P)
    pt = _to_torch(P)
    sj, st = jmod.init(pj, jcfg), tmod.init(pt, tcfg)
    for _ in range(steps):
        G = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * gscale
                                    ).astype(np.float32), P)
        pj, sj, mj = jmod.apply_updates(pj, jax.tree.map(jnp.asarray, G), sj,
                                        jcfg)
        pt, st, mt = tmod.apply_updates(pt, _to_torch(G), st, tcfg)
        assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=LR_RTOL)
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=1e-5)
    assert int(st.step) == int(sj.step) == steps
    return pj, sj, pt, st


@pytest.mark.parametrize("schedule", ["cosine", "linear_warmup_cosine",
                                      "constant"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_matches_jax(schedule, clip):
    kw = dict(lr=1e-2, schedule=schedule, warmup_steps=2, total_steps=6,
              grad_clip=clip, weight_decay=0.1)
    pj, sj, pt, st = _run(jadam, tadam, jadam.AdamWConfig(**kw),
                          tadam.AdamWConfig(**kw))
    assert _max_rel(pj, pt) <= PARAM_BOUND
    assert _max_rel(sj.mu, st.mu) <= PARAM_BOUND
    assert _max_rel(sj.nu, st.nu) <= PARAM_BOUND


def test_adamw_bf16_moments_match_jax():
    """``moment_dtype='bfloat16'``: moments stored in bf16, the update in
    fp32; an ulp of difference upstream can flip a moment's bf16 rounding,
    one bf16 ulp (2**-8) of it."""
    kw = dict(lr=1e-2, moment_dtype="bfloat16", warmup_steps=2,
              total_steps=6)
    pj, sj, pt, st = _run(jadam, tadam, jadam.AdamWConfig(**kw),
                          tadam.AdamWConfig(**kw))
    assert all(t.dtype == torch.bfloat16 for t in tree_util.leaves(st.mu))
    assert _max_rel(sj.mu, st.mu) <= 2.0 ** -8     # measured 3.2e-4
    assert _max_rel(pj, pt) <= 1e-5                # measured 5.3e-7


def test_adamw_pieces_change_no_bit(monkeypatch):
    """The in-place update in pieces equals the update of whole leaves (the
    clip is not reached: the global norm's sum order depends on the
    pieces, the elementwise update does not)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1e3)
    whole = _run(jadam, tadam, jadam.AdamWConfig(**kw),
                 tadam.AdamWConfig(**kw))[2]
    monkeypatch.setattr(tadam, "PIECE", 1000)
    cut = _run(jadam, tadam, jadam.AdamWConfig(**kw),
               tadam.AdamWConfig(**kw))[2]
    for a, b in zip(tree_util.leaves(whole), tree_util.leaves(cut)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adamw_updates_in_place():
    params = {"w": torch.ones(4, 3)}
    ptr = params["w"].data_ptr()
    cfg = tadam.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=4)
    state = tadam.init(params, cfg)
    new, state, _ = tadam.apply_updates(params, {"w": torch.ones(4, 3)},
                                        state, cfg)
    assert new["w"].data_ptr() == ptr and not torch.equal(new["w"],
                                                         torch.ones(4, 3))


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 150])
def test_schedule_matches_jax(step):
    for sched in ("cosine", "constant"):
        kw = dict(lr=3e-4, schedule=sched, warmup_steps=10, total_steps=100)
        want = float(jadam.schedule_lr(jadam.AdamWConfig(**kw),
                                       jnp.asarray(step)))
        got = float(tadam.schedule_lr(tadam.AdamWConfig(**kw), step))
        assert got == pytest.approx(want, rel=LR_RTOL)


def test_adafactor_matches_jax():
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.01)
    pj, sj, pt, st = _run(jfac, tfac, jfac.AdafactorConfig(**kw),
                          tfac.AdafactorConfig(**kw))
    assert _max_rel(pj, pt) <= PARAM_BOUND
    # factored leaves (both trailing dims >= 128) keep row and column
    # statistics, the others a full second moment, in jax.tree order
    shapes_j = [np.shape(a) for a in jax.tree.leaves(sj.v)]
    shapes_t = [tuple(t.shape) for t in tree_util.leaves(st.v)]
    assert shapes_j == shapes_t
    assert _max_rel(sj.v, st.v) <= PARAM_BOUND


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(3)
    for shape in [(1000,), (37, 19), (256,)]:
        g = (rng.standard_normal(shape) * 3).astype(np.float32)
        e = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        qj, sj, nj = jcomp.quantize_int8(jnp.asarray(g))
        qt, sc, nt = tcomp.quantize_int8(torch.tensor(g))
        assert nj == nt
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(sj))
        hj, ej = jcomp.compress_with_feedback(jnp.asarray(g), jnp.asarray(e))
        ht, et = tcomp.compress_with_feedback(torch.tensor(g),
                                              torch.tensor(e))
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    tree = {"a": torch.tensor(g), "b": {"c": torch.ones(5)}}
    errs = tcomp.init_error_feedback(tree)
    out, new_errs = tcomp.tree_compress_with_feedback(tree, errs)
    assert set(out) == {"a", "b"} and out["b"]["c"].shape == (5,)
    # ones quantize exactly (each block's largest is 1): nothing to carry
    assert torch.all(new_errs["b"]["c"] == 0)
