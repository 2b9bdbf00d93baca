"""The knee of an open-loop cell: the engine at a list of fixed rates,
each with the mix's load-in and a window, in one process.

    python3 chipbench/sweep.py --config <config> --traffic <mix> \
        --rates 1,2,3 --seconds 30 --seed 1

For each rate it prints the requests due in the window, the backlog
(submitted, no first token yet) at the window's open and close, the
tokens served and the first-token p90.  The knee is the highest rate
whose backlog does not grow over the window.
"""
import argparse
import copy
import dataclasses
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import torch

    from chipbench import harness
    from chipbench.stats import percentile, ttft_s

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    _build.build_all()
    base = harness.Cell.of(f"{args.config}.{args.traffic}", args.config,
                           args.traffic,
                           json.loads((ROOT / "BENCHMARK.json").read_text()))
    device = torch.device("cuda", 0)
    for rate in [float(r) for r in args.rates.split(",")]:
        traffic = copy.deepcopy(base.traffic)
        traffic["arrival"]["rate_rps"] = rate
        cell = dataclasses.replace(base, traffic=traffic)
        setup = harness.open_setup(cell, args.seed, args.seconds, device)
        harness.warm_up(setup)
        run = harness.Run(cell=cell, seconds=args.seconds,
                          t_start=time.perf_counter())
        harness.run_window(setup, run, trace=False)

        def backlog(t):
            return sum(1 for r in run.reqs.values() if r.submit <= t
                       and not (r.tokens and r.tokens[0] <= t))

        tt = ttft_s(run)
        print(json.dumps({
            "rate_rps": rate, "due_in_window": len(run.window_reqs),
            "backlog_open": backlog(run.t_open),
            "backlog_close": backlog(run.t_close),
            "queued_open": run.queue["open"],
            "queued_close": run.queue["close"],
            "tokens": sum(1 for r in run.reqs.values() for t in r.tokens
                          if run.t_open < t <= run.t_close),
            "ttft_p90_ms": 1e3 * percentile(tt, 90) if tt else None,
            "steps": len(run.window_steps),
            "step_ms_mean": 1e3 * sum(s["t1"] - s["t0"]
                                      for s in run.window_steps)
            / max(1, len(run.window_steps))}), flush=True)
        del setup, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
