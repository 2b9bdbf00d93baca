"""engine_host_ms (engine): the mean over the window's engine steps of the
step's host-clock time less the time its lanes' runners took (the growth
of their decode_s + prefill_s): admission, scheduling, page accounting,
event handling."""


def read(run):
    steps = list(run.host_steps.values())
    if not steps:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] - s["runner_s"] for s in steps) \
        / len(steps)
