"""Table IV: ResNet-18 inference under the paper's approximate multipliers.

The port's counterpart of ``benchmarks/table4_resnet.py``.  Every conv and
the fc of the CIFAR ResNet-18 (full width by default: 64/128/256/512, 2-2-2-2
blocks, about 11.2 M parameters) run with every scalar product through the
multiplier under test (im2col + the bit-level datapath, the paper's
section IV-C methodology), on ``cuda`` unless ``device="cpu"``.

The weights are seeded (He-normal convs, batch-norm statistics from one
train-mode forward over a seeded ``cifar_like`` batch) or read from a
safetensors checkpoint (``--weights``).  Training waits for a later slice
of the port, so Table IV's top-1 against labels is not reported: each
design is held against the **exact forward** of the same weights (argmax
agreement and logits MRED), the quantity behind the paper's "negligible
degradation".  Times are host-clock milliseconds a forward around a synced
call, warmup excluded, median of the repeats.

``--auto BUDGET`` runs the per-layer auto-configurer
(:meth:`repro_torch.session.Session.auto_configure`) on a calibration batch
instead and reports the emitted policy.

    python -m repro_torch.bench.table4_resnet                  # on the card
    python -m repro_torch.bench.table4_resnet --auto 1e-2 --out policy.json
    python -m repro_torch.bench.table4_resnet --device cpu --widths 8,16,24,32 --eval-n 2
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.metrics import mred, nmed
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.registry import get_elementwise
from repro_torch.data.synthetic import DataConfig, cifar_like
from repro_torch.models import resnet
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

NOTE = ("untrained weights: each design is held against the exact forward "
        "(argmax agreement, logits MRED), not top-1 against labels")


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


def session(weights=None, cfg=None, seed: int = 0, device=None) -> Session:
    """The benchmark's ResNet session: ``weights`` (a safetensors path,
    through ``Session.from_pretrained``) or seeded weights for ``cfg``
    (default: full-width ResNet-18)."""
    dev = resolve_device(device)
    if weights is not None:
        return Session.from_pretrained("resnet18", weights, cfg=cfg,
                                       device=dev)
    cfg = cfg or resnet.ResNetConfig()
    params, state = seeded_resnet(cfg, seed, dev)
    return Session.from_resnet(cfg, params, state, device=dev)


def timed_forward(sess: Session, images, repeats: int):
    """(median host seconds of a synced forward, warmup excluded; logits)."""
    logits = sess.apply(images)
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
        cfg=None, designs=MULTS, repeats: int = 1) -> dict:
    """Table IV on ``eval_n`` seeded ``cifar_like`` images; returns
    ``{design: {mred, nmed, agree, logits_mred, ms}}`` (``"Exact"``: ms
    only)."""
    sess = session(weights, cfg, seed, device)
    images = cifar_like(DataConfig(global_batch=eval_n, seed=999), 10_000,
                        n=eval_n)["images"]
    print(f"== Table IV: ResNet-18 ({'x'.join(map(str, sess.config.widths))}"
          f" widths) on {eval_n} images, {sess.device} ==")
    print(f"({NOTE})")
    t_exact, exact = timed_forward(sess, images, repeats)
    pred = exact.argmax(-1).cpu().numpy()
    rows = {"Exact": {"ms": 1e3 * t_exact}}
    print(f"{'design':8s} {'MRED':>9s} {'paperM':>9s} {'NMED':>9s} "
          f"{'agree%':>7s} {'logitMRED':>10s} {'ms/fwd':>9s}")
    print(f"{'Exact':8s} {'-':>9s} {'-':>9s} {'-':>9s} {'-':>7s} {'-':>10s} "
          f"{1e3 * t_exact:9.2f}")
    for name in designs:
        m, n = multiplier_errors(name, sess.device)
        t, logits = timed_forward(sess.replace(policy=emulated_config(name)),
                                  images, repeats)
        agree = float(np.mean(logits.argmax(-1).cpu().numpy() == pred))
        rows[name] = {"mred": m, "nmed": n, "agree": agree,
                      "logits_mred": mred(logits, exact), "ms": 1e3 * t}
        pm = PAPER.get(name, (None,))[0]
        print(f"{name:8s} {m:9.2e} {pm if pm else 0:9.2e} {n:9.2e} "
              f"{100 * agree:6.1f}% {rows[name]['logits_mred']:10.2e} "
              f"{1e3 * t:9.2f}")
    print("paper-claim check: AC4-4/5-5/6-6 should agree with exact almost "
          "everywhere; NC should disagree the most (Table IV)")
    return rows


def run_auto(budget: float = 1e-2, device=None, weights=None,
             calib_n: int = 32, seed: int = 0, cfg=None,
             candidates="segmented", method: str = "proxy", out=None):
    """Budget-driven per-layer configuration of the Table IV network on
    ``calib_n`` seeded calibration images; prints the assignment, the
    composed (proxy) or measured (greedy) error, the measured error of the
    emitted policy and the modeled area saving; returns the result."""
    sess = session(weights, cfg, seed, device)
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
                 args.seed, cfg, args.candidates, args.method, args.out)
    else:
        run(args.device, args.weights, args.eval_n, args.seed, cfg,
            repeats=args.repeats)


if __name__ == "__main__":
    main()
