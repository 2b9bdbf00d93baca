"""Table IV's training (``repro_torch.bench.table4_resnet.train_resnet``)
against the JAX package's (``benchmarks/table4_resnet.py::train_resnet``:
AdamW lr 3e-3, cosine, 20 warmup steps, weight decay 1e-4, train-mode
batch norm with momentum 0.9) at stage widths (8, 16, 24, 32), on params
carried over from the JAX package's init.

The JAX side is that function's step, written out here so that it can
start from the carried params: the reference builds its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import cifar_like as jax_cifar_like
from repro.models import resnet as jresnet
from repro.models.layers import unzip
from repro.optim import adamw as jadamw
from repro_torch import tree as tree_util
from repro_torch.bench import table4_resnet
from repro_torch.compat import resnet_from_numpy
from repro_torch.models import resnet

WIDTHS = (8, 16, 24, 32)
STEPS, BATCH = 4, 16
# losses step by step: fp32 convs and batch statistics summed in other
# orders, then Adam's amplification of ulps after the first update.
# Measured: 2.0e-7 at most.
LOSS_RTOL = 1e-4
# the running statistics after the last step, in units of each leaf's
# largest |value|.  Measured: 2.8e-6 at most.
STATE_BOUND = 1e-4


def _jax_train(cfg, params, state, steps, batch, seed=0):
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, schedule="cosine", warmup_steps=20,
                                 total_steps=steps, weight_decay=1e-4)
    opt = jadamw.init(params, opt_cfg)
    dcfg = JaxDataConfig(global_batch=batch, seed=seed)

    @jax.jit
    def step(params, state, opt, b):
        (loss, new_state), grads = jax.value_and_grad(
            jresnet.loss_fn, has_aux=True)(params, state, b, cfg)
        params, opt, _ = jadamw.apply_updates(params, grads, opt, opt_cfg)
        return params, new_state, opt, loss

    losses = []
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in jax_cifar_like(dcfg, s).items()}
        params, state, opt, loss = step(params, state, opt, b)
        losses.append(float(loss))
    return params, state, losses


def test_train_resnet_matches_jax():
    jcfg = jresnet.ResNetConfig(widths=WIDTHS)
    pp, jstate = jresnet.init(jcfg, jax.random.PRNGKey(0))
    jparams, _ = unzip(pp)
    cfg = resnet.ResNetConfig(widths=WIDTHS)
    params, state = resnet_from_numpy(jax.tree.map(np.asarray, jparams),
                                      jax.tree.map(np.asarray, jstate), cfg,
                                      device="cpu")
    _, jstate, jlosses = _jax_train(jcfg, jparams, jstate, STEPS, BATCH)
    cfg_out, params, state, losses = table4_resnet.train_resnet(
        STEPS, BATCH, device="cpu", cfg=cfg, params=params, state=state)
    assert cfg_out == cfg
    assert losses == pytest.approx(jlosses, rel=LOSS_RTOL)
    want = jax.tree.map(np.asarray, jstate)
    for (name, w), got in zip(tree_util.named(want), tree_util.leaves(state)):
        err = np.max(np.abs(got.numpy() - w)) / np.max(np.abs(w))
        assert err <= STATE_BOUND, name
    assert all(not p.requires_grad and p.grad is None
               for p in tree_util.leaves(params))


def test_trained_network_reports_top1(capsys):
    """A few steps at a tiny width on the CPU: the benchmark trains, then
    reports top-1 against the labels for exact and each design, with its
    change from exact and the paper's value beside it."""
    cfg = resnet.ResNetConfig(widths=(4, 8), blocks=(1, 1))
    rows = table4_resnet.run(device="cpu", eval_n=4, cfg=cfg,
                             designs=["AC5-5"], train_steps=3)
    assert set(rows) == {"Exact", "AC5-5"}
    assert 0.0 <= rows["Exact"]["top1"] <= 1.0
    assert rows["AC5-5"]["d_top1"] == pytest.approx(
        rows["AC5-5"]["top1"] - rows["Exact"]["top1"])
    out = capsys.readouterr().out
    assert "[resnet-train] step    0" in out and "top1" in out
    assert "0.872" in out          # the paper's exact top-1 beside it
