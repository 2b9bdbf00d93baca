"""The comparison's two readings, for setting a cell's limits: the
program's numbers and the control's over many seeds, in one process.

    python3 chipbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 15 [--out control.jsonl]

Each seed draws its own weights and traffic, runs the cell's engine at
the cell's load for a short window, and compares the sampled served
tokens with the reference (the program's reading) and the reference's
own pick computed one precision step lower (the control's reading:
bf16 products -> fp8 e4m3, the 3-pass product -> 1 pass).  The
benchmark's runs never run the control.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _summary(detail: dict) -> dict:
    """Per tier: the widest gap (the number compared), the mean gap and
    the share of positions whose token is not the reference's best."""
    return {t: {"widest": max(g), "mean": sum(g) / len(g),
                "off_best": sum(1 for x in g if x > 0) / len(g), "n": len(g)}
            for t, g in detail.items()}


def readings(harness, setup, run) -> dict:
    """The program's readings and the control's (every product one step
    down), on one sample against one reference."""
    import gc

    import torch

    cell = setup.cell
    sample = harness.sample_for_check(
        run, setup.seed, int(cell.checks["sample_tokens_per_tier"]))
    for lane in setup.engine._lanes.values():
        lane.runner.pool = None
    gc.collect()
    torch.cuda.empty_cache()
    ref = harness.load_reference(cell)(setup.params, cell.config)
    tiers = harness.tier_products(cell)
    out = {}
    for name, c in (("program", None),
                    ("control", harness.control_products(cell))):
        detail: dict = {}
        harness.gaps(ref, sample, tiers, c, detail=detail)
        out[name] = _summary(detail)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import torch

    from chipbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    _build.build_all()
    cell = harness.Cell.load(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        setup = harness.open_setup(cell, seed, args.seconds, device)
        harness.warm_up(setup)
        run = harness.Run(cell=cell, seconds=args.seconds,
                          t_start=time.perf_counter())
        harness.run_window(setup, run, trace=False)
        if cell.traffic["arrival"]["kind"] != "backlog":
            setup.engine.run()  # finish what is in flight: a full sample
        rec = {"workload": cell.name, "seed": seed,
               **readings(harness, setup, run),
               "finished": sum(1 for r in run.reqs.values()
                               if r.handle.done),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        del setup, run
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
