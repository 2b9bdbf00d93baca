"""Table II: the multipliers' area / power / delay from the calibrated
analytical model, beside the paper's post-layout values.

The port's counterpart of ``benchmarks/table2_ppa.py``.  The model
(:mod:`repro_torch.core.ppa`) is calibrated on two rows only (Exact and
AC5-5); every other row is a prediction, printed with its deviation from
the paper, then the paper's headline savings.  A second table puts each
design's modeled area and power beside its measured accuracy: the MRED of
every sweepable design on uniform operands, computed through the
multiplier registry on ``device`` (the AFPM designs run the bit-level
kernel on the card), with the accuracy-area Pareto frontier marked
(:func:`repro_torch.core.sweep.sweep`).

    python -m repro_torch.bench.table2_ppa                  # on the card
    python -m repro_torch.bench.table2_ppa --device cpu --n-samples 5000
"""
from __future__ import annotations

import argparse

from repro_torch._device import resolve_device
from repro_torch.core import ppa, sweep


def table2() -> dict:
    """Model vs paper for every Table II row: ``{name: (area um^2, paper
    area, power W, paper power, delay ns)}``; prints the table and the
    headline claims."""
    print("== Table II: post-layout PPA (64x32 SRAM, analytical model) ==")
    print(f"{'design':8s} {'area um2':>9s} {'paper':>7s} {'err%':>6s} "
          f"{'power W':>9s} {'paper':>9s} {'err%':>6s} {'delay ns':>8s}")
    rows, errs_a, errs_p = {}, [], []
    for name, (kind, kw) in ppa.TABLE2_SPECS.items():
        est = ppa.estimate(kind, name=name, **kw)
        pa, pp_ = ppa.PAPER_TABLE2_64x32[name]
        ea = 100 * (est.logic_area_um2 - pa) / pa
        ep = 100 * (est.power_w - pp_) / pp_
        errs_a.append(abs(ea))
        errs_p.append(abs(ep))
        rows[name] = (est.logic_area_um2, pa, est.power_w, pp_, est.delay_ns)
        print(f"{name:8s} {est.logic_area_um2:9.0f} {pa:7.0f} {ea:6.1f} "
              f"{est.power_w:9.2e} {pp_:9.2e} {ep:6.1f} {est.delay_ns:8.2f}")
    print(f"mean |err|: area {sum(errs_a) / len(errs_a):.1f}%  power "
          f"{sum(errs_p) / len(errs_p):.1f}%")
    e = ppa.estimate("exact")
    for label, est, paper in (("AC4-4", ppa.estimate("ac", n=4),
                               "paper headline: 69%/72%"),
                              ("ACL5 ", ppa.estimate("acl", n=5),
                               "paper: 78.4%/82.1%")):
        print(f"{label} vs exact: area "
              f"-{100 * (1 - est.logic_area_um2 / e.logic_area_um2):.0f}% "
              f"power -{100 * (1 - est.power_w / e.power_w):.0f}%  ({paper})")
    da, dp = ppa.bd_omission_savings(5)
    print(f"BD omission (n=5): area -{100 * da:.1f}% power -{100 * dp:.1f}% "
          f"(paper: 6.8%/12.6%)")
    return rows


def run(device=None, n_samples: int = 50_000):
    """Table II, then the accuracy-area sweep on ``device`` (``cuda``
    unless ``"cpu"``); returns ``(table2 rows, sweep points)``."""
    dev = resolve_device(device)
    rows = table2()
    points = sweep.sweep(n_samples=n_samples, device=dev)
    print(f"== accuracy vs modeled area: MRED on {n_samples} uniform "
          f"operand pairs in [-4, 4], {dev} ==")
    print(f"{'design':8s} {'MRED':>9s} {'area um2':>9s} {'power W':>9s} "
          f"pareto")
    for p in points:
        print(f"{p.name:8s} {p.mred:9.2e} {p.area_um2:9.0f} {p.power_w:9.2e} "
              f"{'*' if p.pareto else ''}")
    return rows, points


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n-samples", type=int, default=50_000)
    args = ap.parse_args(argv)
    run(args.device, args.n_samples)


if __name__ == "__main__":
    main()
