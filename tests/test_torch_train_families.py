"""The port's trainer against the JAX package's on the kernel-bearing
families: the reduced zamba2-7b (SSD blocks and a shared attention
block), llama4-maverick-400b-a17b (MoE, top-1, Adafactor) and
deepseek-v3-671b (MLA and MoE, top-2 of 4 when reduced, Adafactor).

Whole train steps (loss, global gradient norm, learning rate) are held
against the JAX package's jitted ``make_train_step`` with
``tests/test_torch_train.py``'s tolerances, the MoE configs' recompute
under remat changes no bit, and a restart of the reduced deepseek-v3
from its step-2 checkpoint ends on the uninterrupted run's bits.  The
dense families take the same checks in ``tests/test_torch_train_dense.py``,
through this file's helpers.  On the CPU the plain route runs;
``chip_smoke.py`` trains these families through the kernels on the card.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_arch as jax_get_arch
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro_torch import tree as tree_util
from repro_torch.checkpoint import io
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain

ARCHS = ["zamba2-7b", "llama4-maverick-400b-a17b", "deepseek-v3-671b"]
# tests/test_torch_train.py's bounds for whole train steps: the losses
# within 1e-4 and the global gradient norm within 1e-4, its bound for a
# first step (each step here starts from one state on both sides)
STEP_LOSS_RTOL = 1e-4
FIRST_NORM_RTOL = 1e-4
# fp32 activations and fp32 products, as the families' own gradient
# tests hold them (tests/test_torch_hybrid.py, tests/test_torch_moe.py):
# with bf16 products one fp32 ulp can flip a bf16 operand's rounding in
# any block, and with it a token's routing
NUMERICS = dict(mode="exact", compute_dtype="float32")


def _batch(cfg, step, seq_len=24, batch=4, seed=1):
    return lm_batch(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=batch, seed=seed), step)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, tmp_path):
    """Three steps of the reduced config's trainer pieces (its optimizer:
    AdamW for zamba2-7b, Adafactor for the two MoE configs, the
    reference's warmup and cosine schedule) against the JAX package's
    jitted step: the loss, the global gradient norm and the learning rate
    of each step.

    Each step starts from one state on both sides: the port's params and
    optimizer state after the previous step, carried into JAX through a
    checkpoint that both packages read.  Left to evolve apart, the two
    runs part by more than these bounds at lr 3e-3: the first update
    moves every parameter by about ``lr * sign(g)``, so a near-zero
    gradient whose sign differs moves its parameter 2 lr apart, and the
    reduced zamba2-7b's gradient norm is then 4.6% apart at the second
    step; under top-1 the router's gradient is rounding noise on both
    sides (the one gate is renormalised to 1), which Adafactor turns into
    full-size router steps of either sign, and llama4's losses part by
    4e-4 at the third."""
    _steps_match_jax(arch, [_batch(get_arch(arch).reduced(), s)
                            for s in range(3)], tmp_path)


def _steps_match_jax(arch, batches, tmp_path):
    """One trainer step of the reduced ``arch`` for each of ``batches``
    (numpy), each from one state on both sides (see
    :func:`test_train_steps_match_jax`), held to the file's bounds.
    Returns the token table before the steps and both packages' params
    after them."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(),
                               numerics=JaxNumerics(**NUMERICS))
    tcfg = dataclasses.replace(get_arch(arch).reduced(),
                               numerics=NumericsConfig(**NUMERICS))
    assert jcfg.optimizer == tcfg.optimizer
    jparams, _ = unzip(jtr.init(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    kw = dict(lr=3e-3, total_steps=3, warmup_steps=2)
    jopt_cfg, jinit, japply, _ = jsteps.make_optimizer(jcfg, **kw)
    opt_cfg, init, apply = steps.make_optimizer(tcfg, **kw)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg, japply))
    step = steps.make_train_step(tcfg, opt_cfg, apply)
    jstate, state = jinit(jparams, jopt_cfg), init(params, opt_cfg)
    first = params["embed"].clone()
    for s, b in enumerate(batches):
        if s:
            io.save(str(tmp_path), s, (params, state))
            (jparams, jstate), _ = jio.restore(str(tmp_path),
                                               (jparams, jstate), step=s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.as_tensor(v) for k, v in b.items()})
        assert np.isfinite(float(m["loss"])), (arch, s)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=STEP_LOSS_RTOL), (arch, s)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=FIRST_NORM_RTOL), (arch, s)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert all(p.grad is None for p in tree_util.leaves(params))
    return first, params, jparams


def test_deepseek_restart_is_exact(tmp_path):
    """The reduced deepseek-v3 (MLA, MoE, Adafactor) trained 4 steps with
    a checkpoint every 2; a second run restored from the step-2
    checkpoint alone ends on the same bits: every leaf of params and
    optimizer state, and the losses of steps 3-4."""
    kw = dict(steps=4, seq_len=16, batch=4, ckpt_every=2, lr=3e-3,
              log_every=100, device="cpu")
    run = str(tmp_path / "run")
    p1, o1, l1 = ttrain.train("deepseek-v3-671b", ckpt_dir=run, **kw)
    assert io.all_steps(run) == [2, 4]
    restart = str(tmp_path / "restart")
    os.makedirs(restart)
    shutil.copytree(os.path.join(run, "step_000000002"),
                    os.path.join(restart, "step_000000002"))
    p2, o2, l2 = ttrain.train("deepseek-v3-671b", ckpt_dir=restart, **kw)
    assert len(l1) == 4 and l2 == l1[2:]
    assert io.all_steps(restart) == [2, 4]
    leaves1, leaves2 = tree_util.leaves((p1, o1)), tree_util.leaves((p2, o2))
    assert len(leaves1) == len(leaves2)
    for a, b in zip(leaves1, leaves2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and the run trained: the restored state is not the seeded init
    init = ttrain.transformer.init(get_arch("deepseek-v3-671b").reduced(), 0)
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_util.leaves(init), tree_util.leaves(p2)))


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_remat_full_changes_no_bit(arch):
    """The card trains these families under ``remat="full"`` (the reduced
    configs run without it): the recompute routes the MoE tokens again
    (capacity dispatch, MLA), and the loss and every gradient equal the
    run without checkpointing bit for bit.  zamba2-7b's shared blocks:
    tests/test_torch_hybrid.py::test_remat_of_shared_blocks_changes_no_bit."""
    _remat_changes_no_bit(arch, 24)


def _remat_changes_no_bit(arch, seq_len):
    """The reduced ``arch``'s loss and gradients on a batch of rows of
    ``seq_len`` tokens, under remat full and none, equal bit for bit."""
    cfg = get_arch(arch).reduced()
    b = {k: torch.as_tensor(v)
         for k, v in _batch(cfg, 0, seq_len).items()}
    out = {}
    for remat in ("none", "full"):
        params = ttrain.transformer.init(cfg, seed=3)
        out[remat] = steps.grads_of(ttrain.transformer.loss_fn, params,
                                    dataclasses.replace(cfg, remat=remat), b)
    assert torch.equal(out["none"][0], out["full"][0])
    for (name, a), c in zip(tree_util.named(out["none"][1]),
                            tree_util.leaves(out["full"][1])):
        assert torch.equal(a, c), name
