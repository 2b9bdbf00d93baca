"""prefill_call_ms (lane runner): host ms of one prefill chunk call,
summed over the window's chunk calls over their number."""


def read(run):
    steps = run.host_steps
    c = [x for x in run.calls if x["kind"] == "prefill" and x["step"] in steps]
    if not c:
        return None
    return 1e3 * sum(x["t1"] - x["t0"] for x in c) / len(c)
