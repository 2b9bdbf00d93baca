"""Trainer (``repro.launch.train`` counterpart): synthetic Markov
token stream -> train step -> checkpoint / restart, on one card.

Resumes from the newest committed checkpoint under ``ckpt_dir``, saves
every ``ckpt_every`` steps and at the end, and records each step's
wall-clock time into the straggler watchdog.  Runs on ``cuda`` unless
``device="cpu"``.

    python -m repro_torch.launch.train --arch qwen3-4b --steps 12 \\
        --seq-len 32 --batch 4 --device cpu
    python -m repro_torch.launch.train --arch mamba2-130m --full-config
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer


def train(arch: str, steps: int = 50, seq_len: int = 128, batch: int = 8,
          ckpt_dir: str | None = None, ckpt_every: int = 20, lr: float = 3e-4,
          reduced: bool = True, log_every: int = 10, seed: int = 0,
          device=None):
    """Train ``arch`` (reduced unless ``reduced=False``) for ``steps``
    steps of ``batch`` x ``seq_len`` tokens; returns ``(params, opt_state,
    losses)``.  Params are seeded (``seed``) on the device; the schedule is
    the reference's (cosine, warmup ``max(2, steps // 10)``)."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    params = transformer.init(cfg, seed, dev)
    opt_cfg, opt_init, opt_apply = steps_mod.make_optimizer(
        cfg, lr=lr, total_steps=steps, warmup_steps=max(2, steps // 10))
    opt_state = opt_init(params, opt_cfg)

    start_step = 0
    if ckpt_dir:
        if ckpt_io.latest_step(ckpt_dir) is not None:
            (params, opt_state), manifest = ckpt_io.restore(
                ckpt_dir, (params, opt_state))
            start_step = manifest["step"]
            print(f"[train] restored step {start_step} from {ckpt_dir}")

    train_step = steps_mod.make_train_step(cfg, opt_cfg, opt_apply)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                      seed=seed)
    watchdog = StepWatchdog()
    losses = []
    for step in range(start_step, steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(dcfg, step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, b)
        losses.append(float(metrics["loss"]))      # syncs the step
        watchdog.record(0, time.perf_counter() - t0)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] {arch} step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            ckpt_io.save(ckpt_dir, step + 1, (params, opt_state),
                         extra={"loss": losses[-1]})
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, seq_len=args.seq_len,
          batch=args.batch, ckpt_dir=args.ckpt_dir,
          reduced=not args.full_config, device=args.device)


if __name__ == "__main__":
    main()
