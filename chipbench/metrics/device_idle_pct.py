"""device_idle_pct (device): the share of the traced span in which no
device operation runs (the union of their intervals in the trace)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
