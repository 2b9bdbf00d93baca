"""Table IV: ResNet-18 trained, then evaluated under the paper's
approximate multipliers.

The port's counterpart of ``benchmarks/table4_resnet.py``.  As in the
paper's section IV-C, the CIFAR ResNet-18 (full width by default:
64/128/256/512, 2-2-2-2 blocks, about 11.2 M parameters) is trained with
exact fp32 arithmetic (:func:`train_resnet`: the reference's AdamW,
schedule and steps on the seeded ``cifar_like`` stream; cuDNN's TF32 off
in the forward and the backward), then every conv and the fc run with
every scalar product through the multiplier under test (im2col + the
bit-level datapath), on ``cuda`` unless ``device="cpu"``.  Reported per
design: the multiplier's MRED and NMED, top-1 against the labels of 48
seeded evaluation images and its change from exact, argmax agreement and
logits MRED against the exact forward, beside the paper's values.
``--weights`` evaluates a safetensors checkpoint instead of training.
Times are host-clock milliseconds a forward around a synced call, median
of the repeats (after a warmup forward, except for the seconds-long
emulated designs).

``--auto BUDGET`` runs the per-layer auto-configurer
(:meth:`repro_torch.session.Session.auto_configure`) on a calibration batch
instead and reports the emitted policy.

    python -m repro_torch.bench.table4_resnet                  # on the card
    python -m repro_torch.bench.table4_resnet --auto 1e-2 --out policy.json
    python -m repro_torch.bench.table4_resnet --device cpu --widths 8,16,24,32 --eval-n 2 --train-steps 4
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch._device import resolve_device
from repro_torch.core.metrics import mred, nmed, top_k_accuracy
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.registry import get_elementwise
from repro_torch.data.synthetic import DataConfig, cifar_like
from repro_torch.models import resnet
from repro_torch.optim import adamw
from repro_torch.session import Session

# paper Table IV values (multiplier MRED, NMED, top-1) for side-by-side
# printing
PAPER = {
    "Exact": (None, None, 0.8715),
    "ACL5": (4.16e-2, 1.58e-4, 0.8569),
    "AC4-4": (1.38e-3, 5.35e-6, 0.8715),
    "AC5-5": (3.36e-4, 1.30e-6, 0.8717),
    "AC6-6": (8.29e-5, 3.55e-7, 0.8715),
    "MMBS5": (2.92e-3, 1.13e-5, 0.8714),
    "CSS16": (3.48e-4, 1.37e-6, 0.8717),
    "NC": (4.37e-2, 1.55e-4, 0.8253),
    "HPC": (7.06e-3, 2.59e-5, 0.8717),
}

MULTS = ["AC4-4", "AC5-5", "AC6-6", "ACL5", "MMBS5", "CSS16", "NC", "HPC"]

def emulated_config(name: str) -> NumericsConfig:
    """The emulated-mode config of a Table IV design (``seg_n`` from an
    AC-n-n name, else 5), as the reference benchmark builds it."""
    n = int(name[2]) if name.startswith("AC") and name[2].isdigit() else 5
    return NumericsConfig(mode="emulated", multiplier=name, seg_n=n)


def seeded_resnet(cfg: resnet.ResNetConfig, seed: int = 0, device=None,
                  bn_batch: int = 64):
    """Seeded ``(params, state)`` whose batch-norm running statistics are
    those of one train-mode forward over a seeded ``cifar_like`` batch."""
    params, state = resnet.init(cfg, seed, device)
    images = cifar_like(DataConfig(global_batch=bn_batch, seed=seed), 0)
    x = torch.as_tensor(images["images"], device=device)
    with torch.no_grad():
        _, state = resnet.apply(params, state, x, cfg, train=True,
                                momentum=0.0)
    return params, state


def train_resnet(steps: int = 120, batch: int = 64, seed: int = 0,
                 width_mult: float = 0.5, device=None, cfg=None,
                 params=None, state=None, log_every: int = 40):
    """Train the Table IV network as the reference benchmark does: AdamW
    (lr 3e-3, cosine, 20 warmup steps, weight decay 1e-4) for ``steps``
    steps of ``batch`` seeded ``cifar_like`` images, batch norm in train
    mode (momentum 0.9), exact fp32 convs (cuDNN's TF32 off in the forward
    and the backward, and its deterministic algorithms: with its defaults
    two trainings on the card ended at different weights).  ``cfg`` defaults to the stage widths 64/128/256/512
    times ``width_mult``; ``params``/``state`` default to seeded ones.
    Returns ``(cfg, params, state, losses)``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = resnet.ResNetConfig(widths=tuple(int(w * width_mult)
                                               for w in (64, 128, 256, 512)))
    if params is None:
        params, state = resnet.init(cfg, seed, dev)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, schedule="cosine", warmup_steps=20,
                                total_steps=steps, weight_decay=1e-4)
    opt = adamw.init(params, opt_cfg)
    dcfg = DataConfig(global_batch=batch, seed=seed)
    leaves = tree_util.leaves(params)
    cudnn = torch.backends.cudnn
    losses = []
    for s in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in cifar_like(dcfg, s).items()}
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                         deterministic=True, allow_tf32=False):
            loss, state = resnet.loss_fn(params, state, b, cfg)
            loss.backward()
        grads = tree_util.map(lambda p: p.grad, params)
        params, opt, _ = adamw.apply_updates(params, grads, opt, opt_cfg)
        losses.append(float(loss.detach()))
        if s % log_every == 0 or s == steps - 1:
            print(f"  [resnet-train] step {s:4d} loss {losses[-1]:.4f}")
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    return cfg, params, state, losses


def session(weights=None, cfg=None, seed: int = 0, device=None,
            train_steps: int = 0) -> Session:
    """The benchmark's ResNet session: ``weights`` (a safetensors path,
    through ``Session.from_pretrained``), or ``cfg`` (default: full-width
    ResNet-18) trained for ``train_steps`` steps by :func:`train_resnet`,
    or with seeded weights when ``train_steps`` is 0."""
    dev = resolve_device(device)
    if weights is not None:
        return Session.from_pretrained("resnet18", weights, cfg=cfg,
                                       device=dev)
    cfg = cfg or resnet.ResNetConfig()
    if train_steps:
        cfg, params, state, _ = train_resnet(train_steps, seed=seed,
                                             device=dev, cfg=cfg)
    else:
        params, state = seeded_resnet(cfg, seed, dev)
    return Session.from_resnet(cfg, params, state, device=dev)


def eval_batch(eval_n: int = 48) -> dict:
    """The reference's evaluation images: ``cifar_like`` seed 999, step
    10000."""
    return cifar_like(DataConfig(global_batch=eval_n, seed=999), 10_000,
                      n=eval_n)


def timed_forward(sess: Session, images, repeats: int, warmup: bool = True):
    """(median host seconds of a synced forward, after one warmup forward
    unless ``warmup=False``; logits)."""
    if warmup:
        sess.apply(images)
    times = []
    for _ in range(repeats):
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)
        t0 = time.perf_counter()
        logits = sess.apply(images)
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), logits


def multiplier_errors(name: str, device, n: int = 100_000):
    """(MRED, NMED) of one design on ``n`` uniform operand pairs in
    [-4, 4] (seed 0, the reference's distribution), computed on
    ``device``."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(-4, 4, n).astype(np.float32)
    ys = rng.uniform(-4, 4, n).astype(np.float32)
    exact = xs.astype(np.float64) * ys.astype(np.float64)
    got = get_elementwise(name)(torch.as_tensor(xs, device=device),
                                torch.as_tensor(ys, device=device))
    return mred(got, exact), nmed(got, exact)


def run(device=None, weights=None, eval_n: int = 48, seed: int = 0,
        cfg=None, designs=MULTS, repeats: int = 1, train_steps: int = 120,
        sess: Session | None = None) -> dict:
    """Table IV on ``eval_n`` seeded ``cifar_like`` images of a trained
    network (``sess``, else :func:`session`); returns ``{design: {top1,
    d_top1, mred, nmed, agree, logits_mred, ms}}`` (``"Exact"``: top1 and
    ms)."""
    if sess is None:
        sess = session(weights, cfg, seed, device, train_steps)
    ev = eval_batch(eval_n)
    images, labels = ev["images"], torch.as_tensor(ev["labels"])
    print(f"== Table IV: ResNet-18 ({'x'.join(map(str, sess.config.widths))}"
          f" widths) on {eval_n} images, {sess.device} ==")
    t_exact, exact = timed_forward(sess, images, repeats)
    top1_exact = top_k_accuracy(exact, labels, 1)
    pred = exact.argmax(-1).cpu().numpy()
    rows = {"Exact": {"top1": top1_exact, "ms": 1e3 * t_exact}}
    print(f"{'design':8s} {'MRED':>9s} {'paperM':>9s} {'NMED':>9s} "
          f"{'top1':>6s} {'paper':>6s} {'d_top1':>7s} {'agree%':>7s} "
          f"{'logitMRED':>10s} {'ms/fwd':>9s}")
    print(f"{'Exact':8s} {'-':>9s} {'-':>9s} {'-':>9s} {top1_exact:6.3f} "
          f"{PAPER['Exact'][2]:6.3f} {'-':>7s} {'-':>7s} {'-':>10s} "
          f"{1e3 * t_exact:9.2f}")
    for name in designs:
        m, n = multiplier_errors(name, sess.device)
        # emulated forwards take seconds: timed without a warmup, as the
        # reference times them
        t, logits = timed_forward(sess.replace(policy=emulated_config(name)),
                                  images, repeats, warmup=False)
        top1 = top_k_accuracy(logits, labels, 1)
        agree = float(np.mean(logits.argmax(-1).cpu().numpy() == pred))
        rows[name] = {"top1": top1, "d_top1": top1 - top1_exact, "mred": m,
                      "nmed": n, "agree": agree,
                      "logits_mred": mred(logits, exact), "ms": 1e3 * t}
        pm, _, ptop = PAPER.get(name, (None, None, None))
        print(f"{name:8s} {m:9.2e} {pm if pm else 0:9.2e} {n:9.2e} "
              f"{top1:6.3f} {ptop:6.3f} {top1 - top1_exact:+7.3f} "
              f"{100 * agree:6.1f}% {rows[name]['logits_mred']:10.2e} "
              f"{1e3 * t:9.2f}")
    print("paper-claim check: AC4-4/5-5/6-6 should show ~zero top-1 drop; "
          "NC the largest drop (Table IV)")
    return rows


def run_auto(budget: float = 1e-2, device=None, weights=None,
             calib_n: int = 32, seed: int = 0, cfg=None,
             candidates="segmented", method: str = "proxy", out=None,
             train_steps: int = 120):
    """Budget-driven per-layer configuration of the Table IV network
    (trained for ``train_steps`` steps, as :func:`run`) on ``calib_n``
    seeded calibration images; prints the assignment, the composed (proxy)
    or measured (greedy) error, the measured error of the emitted policy
    and the modeled area saving; returns the result."""
    sess = session(weights, cfg, seed, device, train_steps)
    calib = cifar_like(DataConfig(global_batch=calib_n, seed=123), 20_000,
                       n=calib_n)["images"]
    print(f"== auto-configure[{method}]: per-layer numerics under logits "
          f"MRED <= {budget:g}, {sess.device} ==")
    ref = sess.apply(calib)
    res = sess.auto_configure(budget, calib=calib, candidates=candidates,
                              method=method, verbose=True)
    measured = mred(sess.apply(calib), ref)
    kind = "composed" if res.method == "proxy" else "measured"
    print(f"[auto] {kind} error={res.error:.3e} (budget {budget:g}); "
          f"measured error of the emitted policy {measured:.3e}; area "
          f"{res.area_um2:,.0f} um^2 vs exact {res.baseline_area_um2:,.0f} "
          f"(-{res.area_reduction:.1%}) [{res.n_evals} calibration evals]")
    for path, name in res.assignments:
        print(f"  {path:16s} -> {name}")
    if out:
        sess.save_policy(out)
        print(f"[auto] policy written to {out}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--weights", default=None, metavar="CKPT",
                    help="resnet18 safetensors checkpoint (default: seeded "
                         "full-width weights)")
    ap.add_argument("--widths", default=None,
                    help="comma list of the four stage widths for seeded "
                         "weights (default 64,128,256,512)")
    ap.add_argument("--eval-n", type=int, default=48)
    ap.add_argument("--train-steps", type=int, default=120,
                    help="training steps before the evaluation (0: seeded "
                         "weights; ignored with --weights)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--auto", type=float, default=None, metavar="BUDGET",
                    help="run the per-layer auto-configurer at this logits "
                         "MRED budget instead of the Table IV grid")
    ap.add_argument("--candidates", choices=["segmented", "emulated"],
                    default="segmented")
    ap.add_argument("--method", choices=["proxy", "greedy"], default="proxy")
    ap.add_argument("--calib-n", type=int, default=32)
    ap.add_argument("--out", default=None, help="write the policy JSON here")
    args = ap.parse_args(argv)
    cfg = (resnet.ResNetConfig(widths=tuple(int(w) for w in
                                            args.widths.split(",")))
           if args.widths else None)
    if args.auto is not None:
        run_auto(args.auto, args.device, args.weights, args.calib_n,
                 args.seed, cfg, args.candidates, args.method, args.out,
                 args.train_steps)
    else:
        run(args.device, args.weights, args.eval_n, args.seed, cfg,
            repeats=args.repeats, train_steps=args.train_steps)


if __name__ == "__main__":
    main()
