"""prefill_issue_ms (lane runner): the mean over the window's
``serve.prefill`` spans of the call's time less its ``serve.sync`` child
(a chunk that does not complete its prompt has none)."""
from chipbench.spans import self_ms


def read(run):
    return self_ms(run, "serve.prefill", ("serve.sync",))
