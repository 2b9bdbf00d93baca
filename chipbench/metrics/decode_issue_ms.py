"""decode_issue_ms (lane runner): the mean over the window's
``serve.decode`` spans of the call's time less its ``serve.sync`` child:
the host issuing the gather, the model step, the scatter and the greedy
pick, with any wait for the device inside them."""
from chipbench.spans import self_ms


def read(run):
    return self_ms(run, "serve.decode", ("serve.sync",))
