"""step_mfu_pct (model step): model FLOPs of every token the window's steps
processed (prefill chunk tokens and live decode rows; 2 x the parameters a
token touches plus attention over the positions it attended, once whatever
the tier's passes) over the summed host time of those steps times the
card's bf16 peak."""
from chipbench.work import model_flops


def read(run):
    steps = run.host_steps
    if not steps or run.peaks is None:
        return None
    c = [x for x in run.calls if x["step"] in steps]
    flops = model_flops(run.cell.config, sum(x["tokens"] for x in c),
                        sum(x["ctx"] for x in c))
    wall = sum(s["t1"] - s["t0"] for s in steps.values())
    return 100.0 * flops / (wall * run.peaks[0])
