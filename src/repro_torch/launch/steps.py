"""Step functions (``repro.launch.steps`` counterpart): the optimizer of an
arch, the training step (gradient accumulation + the optimizer), and the
serving prefill and decode steps.

PyTorch runs eagerly, so a step is a Python function over the params
tree.  The training step updates params and optimizer state in place.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.optim import adafactor, adamw


def make_optimizer(cfg, **overrides):
    """``(opt_cfg, init_fn, apply_fn)`` of the arch's optimizer: Adafactor
    for the giant configs (``cfg.optimizer``), else AdamW with the arch's
    ``moment_dtype``.  (The reference also returns the optimizer state's
    sharding specs; one card has none.)"""
    if cfg.optimizer == "adafactor":
        return (adafactor.AdafactorConfig(**overrides), adafactor.init,
                adafactor.apply_updates)
    return (adamw.AdamWConfig(moment_dtype=cfg.moment_dtype, **overrides),
            adamw.init, adamw.apply_updates)


def grads_of(loss_fn, params, *args):
    """``(loss, grads)``: ``loss_fn(params, *args)`` differentiated with
    respect to every leaf of ``params`` (each leaf's ``.grad`` is added to,
    so successive calls accumulate; clear them with :func:`clear_grads`).
    A leaf the loss does not reach (the token embedding of a batch of
    ``embeds``) gets a zero gradient, as ``jax.grad`` gives it."""
    for p in tree_util.leaves(params):
        p.requires_grad_(True)
    loss = loss_fn(params, *args)
    loss.backward()
    for p in tree_util.leaves(params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss.detach(), tree_util.map(lambda p: p.grad, params)


def clear_grads(params):
    for p in tree_util.leaves(params):
        p.grad = None


def make_train_step(cfg, opt_cfg=None, opt_apply=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``cfg.grad_accum`` micro-batches (the batch's rows cut in
    order, placed too: :func:`~repro_torch.distributed.sharding.
    micro_batch`) whose gradients are summed and divided by their count,
    then one optimizer update, in place.  ``metrics`` holds ``loss`` (a 0-d tensor on the params'
    device), ``grad_norm`` and ``lr``."""
    accum = max(1, cfg.grad_accum)
    if opt_cfg is None or opt_apply is None:
        opt_cfg, _, opt_apply = make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        clear_grads(params)
        loss = 0.0
        for i in range(accum):
            micro = {k: sharding.micro_batch(v, i, accum)
                     for k, v in batch.items()}
            l, grads = grads_of(transformer.loss_fn, params, cfg, micro)
            loss = loss + l
        if accum > 1:
            with torch.no_grad():
                for g in tree_util.leaves(grads):
                    g.div_(accum)
            loss = loss / accum
        params, opt_state, metrics = opt_apply(params, grads, opt_state,
                                               opt_cfg)
        clear_grads(params)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg, max_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(params, cfg, batch, max_len=max_len)

    return prefill_step


def make_decode_step(cfg):
    @torch.no_grad()
    def decode_step(params, state, token, pos):
        return transformer.decode_step(params, cfg, {"token": token}, state,
                                       pos)

    return decode_step
