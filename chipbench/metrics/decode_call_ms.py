"""decode_call_ms (lane runner): host ms of one lane's decode call (gather,
model step, scatter, greedy pick, the copy of the tokens to the host),
summed over the lanes' calls in the window's steps over their number."""


def read(run):
    steps = run.host_steps
    c = [x for x in run.calls if x["kind"] == "decode" and x["step"] in steps]
    if not c:
        return None
    return 1e3 * sum(x["t1"] - x["t0"] for x in c) / len(c)
