"""k1_roofline_pct (kernel K1): the least time of the traced span's K1 calls
(each the larger of its operations over the bf16 peak and its bytes over
the bandwidth, reckoned from the configuration's shapes, each call's rows
and the tier's passes) over the device time of ``afpm_matmul_kernel`` in
the trace.  The reckoned calls must number as many as the growth of
``afpm_matmul.launches`` and the kernels in the trace; else nothing is
read."""
import sys

from chipbench.work import k1_bound_s, k1_calls


def read(run):
    if not run.trace or run.peaks is None or not run.trace["k1_kernels"]:
        return None
    cfg = run.cell.config
    passes = cfg["numerics"]["tiers"]
    calls = [k for x in run.traced_calls
             for k in k1_calls(cfg, x["rows"], passes[x["tier"]])]
    launched = run.k1_launches["trace1"] - run.k1_launches["trace0"]
    if not len(calls) == launched == run.trace["k1_kernels"]:
        print(f"k1_roofline_pct: {len(calls)} calls reckoned, {launched} "
              f"launched, {run.trace['k1_kernels']} in the trace",
              file=sys.stderr)
        return None
    bound = sum(k1_bound_s(k, run.peaks) for k in calls)
    return 100.0 * bound / run.trace["k1_s"]
