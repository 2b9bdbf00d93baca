"""The port's training path against the JAX package's, at the reduced
qwen3-4b and mamba2-130m configs: the token stream, the loss and every
gradient, whole train steps (and gradient accumulation), activation
checkpointing, the step functions, the data pipeline and the fault
tolerance helpers.

JAX params are carried across with ``repro_torch.compat.params_from_numpy``;
batches are numpy arrays handed to both.  On the CPU the plain route runs
(``tests/test_torch_grad_kernels.py`` drives the kernels' Functions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.data import synthetic as jsyn
from repro.distributed import fault as jfault
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.data import pipeline
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.distributed import fault
from repro_torch.launch import steps
from repro_torch.models import transformer as ttr

# a model's gradients per leaf, in units of the leaf's largest |g|: both
# sides round projection cotangents to bf16, and fp32 sums in other orders
# flip such roundings (one bf16 ulp, 2**-8 of an element); attention's
# backward rounds at other places (autograd of the port's forward against
# the reference's custom VJP).  Measured: 5.8e-3 at most (qwen3 attn.wq),
# 4.1e-3 for mamba2.
GRAD_BOUND = 2.0 ** -6
LOSS_RTOL = 1e-5
# whole train steps: after the first update Adam turns an ulp of a
# near-zero gradient into up to 2 lr of a parameter (delta ~ sign(g)), so
# later steps move by more than sum-order ulps.  Measured over 3 steps at
# lr 3e-3: losses 2.6e-5 apart at most, the global gradient norm 4.4e-5 at
# the first step and 4.1e-3 at the third (mamba2).
STEP_LOSS_RTOL = 1e-4
FIRST_NORM_RTOL = 1e-4
LATER_NORM_RTOL = 1e-2
PRESETS = {"exact": None, "segmented3": 3}


def _configs(arch, mode="exact"):
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if PRESETS[mode]:
        jcfg = dataclasses.replace(jcfg, numerics=JaxNumerics(
            mode="segmented", seg_passes=PRESETS[mode], backend="xla"))
        tcfg = dataclasses.replace(tcfg, numerics=NumericsConfig(
            mode="segmented", seg_passes=PRESETS[mode]))
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams, _ = unzip(jtr.init(jcfg, jax.random.PRNGKey(seed)))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


def _batch(cfg, step=0, seq_len=24, batch=4, seed=1):
    return lm_batch(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=batch, seed=seed), step)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("vocab,seq_len,batch,step,shard,nshards", [
    (256, 32, 4, 0, 0, 1), (151936, 17, 6, 123, 1, 3), (50280, 128, 8, 7, 0, 2)])
def test_lm_batch_equals_jax_bit_for_bit(vocab, seq_len, batch, step, shard,
                                         nshards):
    kw = dict(vocab=vocab, seq_len=seq_len, global_batch=batch, seed=5)
    want = jsyn.lm_batch(jsyn.DataConfig(**kw), step, shard, nshards)
    got = lm_batch(DataConfig(**kw), step, shard, nshards)
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-130m"])
@pytest.mark.parametrize("mode", list(PRESETS))
def test_loss_and_grads_match_jax(arch, mode):
    jcfg, tcfg = _configs(arch, mode)
    jparams, params = _params(jcfg, tcfg)
    b = _batch(tcfg)
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = steps.grads_of(ttr.loss_fn, params, tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for (name, want), g in zip(tree_util.named(jax.tree.map(np.asarray,
                                                            jgrads)),
                               tree_util.leaves(grads)):
        assert g is not None and torch.isfinite(g).all(), name
        assert _rel(g.numpy(), want) <= GRAD_BOUND, name


def test_loss_masks_negative_targets_as_jax():
    jcfg, tcfg = _configs("qwen3-4b")
    jparams, params = _params(jcfg, tcfg)
    b = _batch(tcfg)
    b["targets"][:, ::3] = -1
    want = jtr.loss_fn(jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = ttr.loss_fn(params, tcfg, {k: torch.as_tensor(v)
                                         for k, v in b.items()})
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_bit(remat):
    """Activation checkpointing recomputes the same ops: loss and gradients
    equal the ``remat="none"`` run bit for bit, under a per-layer policy
    too (the recompute runs after the forward's scopes closed, so it must
    take the forward's numerics with it)."""
    seg3 = NumericsConfig(mode="segmented", seg_passes=3)
    policy = NumericsPolicy((("blocks.1.mlp.*", seg3),
                             ("blocks.0.attn.wq", seg3)))
    _, tcfg = _configs("qwen3-4b")
    tcfg = dataclasses.replace(tcfg, numerics=policy, dtype="bfloat16")
    b = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
    out = {}
    for r in ("none", remat):
        params = ttr.init(tcfg, seed=3)
        cfg = dataclasses.replace(tcfg, remat=r)
        out[r] = steps.grads_of(ttr.loss_fn, params, cfg, b)
    assert torch.equal(out["none"][0], out[remat][0])
    for a, c in zip(tree_util.leaves(out["none"][1]),
                    tree_util.leaves(out[remat][1])):
        assert torch.equal(a, c)
    # and the policy is what ran: exact everywhere gives other gradients
    params = ttr.init(tcfg, seed=3)
    exact = steps.grads_of(ttr.loss_fn, params, dataclasses.replace(
        tcfg, numerics=NumericsConfig(), remat=remat), b)
    assert not torch.equal(exact[0], out[remat][0])


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-130m"])
def test_train_steps_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jparams, params = _params(jcfg, tcfg)
    kw = dict(lr=3e-3, total_steps=3, warmup_steps=2)
    jopt_cfg, jinit, japply, _ = jsteps.make_optimizer(jcfg, **kw)
    opt_cfg, init, apply = steps.make_optimizer(tcfg, **kw)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg, japply))
    step = steps.make_train_step(tcfg, opt_cfg, apply)
    jstate, state = jinit(jparams, jopt_cfg), init(params, opt_cfg)
    for s in range(3):
        b = _batch(tcfg, step=s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.as_tensor(v) for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=STEP_LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]),
            rel=FIRST_NORM_RTOL if s == 0 else LATER_NORM_RTOL)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == 3
    assert all(p.grad is None for p in tree_util.leaves(params))


def test_grad_accum_two_against_one():
    """Two micro-batches of half the rows: the same mean loss, up to fp32
    sum order, and the same gradients up to bf16 roundings (each
    micro-batch's weight cotangents are rounded to bf16 before they are
    summed: within 2**-7 of each leaf's largest, measured 2.4e-3); and the
    JAX package's own accumulated step gives the same loss."""
    jcfg, tcfg = _configs("qwen3-4b")
    jparams, _ = _params(jcfg, tcfg)
    b = _batch(tcfg, batch=8)
    out = {}
    for accum in (1, 2):
        cfg = dataclasses.replace(tcfg, grad_accum=accum)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
        opt_cfg, init, apply = steps.make_optimizer(cfg, lr=1e-3)
        step = steps.make_train_step(cfg, opt_cfg, apply)
        captured = {}

        def spy(p, g, st, oc, _apply=apply):
            captured["grads"] = [t.clone() for t in tree_util.leaves(g)]
            return _apply(p, g, st, oc)

        step = steps.make_train_step(cfg, opt_cfg, spy)
        _, _, m = step(params, init(params, opt_cfg),
                       {k: torch.as_tensor(v) for k, v in b.items()})
        out[accum] = (float(m["loss"]), captured["grads"])
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    for g1, g2 in zip(out[1][1], out[2][1]):
        assert _rel(g2.numpy(), g1.numpy()) <= 2.0 ** -7
    jcfg2 = dataclasses.replace(jcfg, grad_accum=2)
    jopt_cfg, jinit, japply, _ = jsteps.make_optimizer(jcfg2, lr=1e-3)
    _, _, jm = jsteps.make_train_step(jcfg2, jopt_cfg, japply)(
        jparams, jinit(jparams, jopt_cfg),
        {k: jnp.asarray(v) for k, v in b.items()})
    assert out[2][0] == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)


def test_make_optimizer_and_serving_steps():
    _, tcfg = _configs("qwen3-4b")
    opt_cfg, init, apply = steps.make_optimizer(
        dataclasses.replace(tcfg, optimizer="adafactor"), lr=1e-2)
    assert type(opt_cfg).__name__ == "AdafactorConfig" and opt_cfg.lr == 1e-2
    opt_cfg, init, apply = steps.make_optimizer(
        dataclasses.replace(tcfg, moment_dtype="bfloat16"))
    assert opt_cfg.moment_dtype == "bfloat16"
    params = ttr.init(tcfg, seed=0)
    tokens = torch.as_tensor(_batch(tcfg, seq_len=8)["tokens"])
    logits, state = steps.make_prefill_step(tcfg, 16)(params,
                                                      {"tokens": tokens})
    with torch.no_grad():
        want, _ = ttr.prefill(params, tcfg, {"tokens": tokens}, max_len=16)
    assert torch.equal(logits, want)
    nxt = logits.argmax(-1)
    step_logits, _ = steps.make_decode_step(tcfg)(params, state, nxt, 8)
    assert step_logits.shape == logits.shape and not step_logits.requires_grad


def test_sharded_batches_yield_the_stream_in_order():
    cfg = DataConfig(vocab=97, seq_len=8, global_batch=2, seed=4)
    it = pipeline.sharded_batches(lambda s: lm_batch(cfg, s), start_step=3,
                                  device="cpu")
    for want_step in (3, 4, 5):
        step, b = next(it)
        assert step == want_step
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      lm_batch(cfg, step)["tokens"])
    host = pipeline.sharded_batches(lambda s: {"x": np.full(2, s)})
    assert [int(next(host)[1]["x"][0]) for _ in range(3)] == [0, 1, 2]
    assert list(pipeline.Prefetcher(iter(range(5)), depth=2)) == list(range(5))


def test_fault_helpers_match_jax(tmp_path):
    for mod in (jfault, fault):
        wd = mod.StepWatchdog(threshold=2.0, window=4)
        for w, d in [(0, 1.0), (1, 1.1), (2, 5.0), (0, 1.2), (2, 4.0)]:
            wd.record(w, d)
        clock = iter([0.0, 1.0, 30.0, 100.0, 100.0])
        hb = mod.HeartbeatRegistry(timeout_s=60.0, clock=lambda: next(clock))
        hb.beat(0)
        hb.beat(1)
        hb.beat(2)
        policy = mod.RestartPolicy(max_restarts=3, backoff_base_s=1.0)
        got = (wd.stragglers(), hb.dead(), hb.alive(),
               [policy.next_delay() for _ in range(4)],
               mod.plan_elastic_mesh(13, 2), mod.plan_elastic_mesh(8, 4),
               mod.should_restart_from(str(tmp_path / "none")))
        if mod is jfault:
            want = got
    assert got == want
    assert got[0] == [2] and got[3] == [1.0, 2.0, 4.0, None]
