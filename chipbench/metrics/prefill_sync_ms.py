"""prefill_sync_ms (lane runner): the mean ``serve.sync`` span inside a
``serve.prefill`` in the window: the first token's pick and its copy to
the host, where the prompt's last chunk waits for the device."""
from chipbench.spans import nested_ms


def read(run):
    return nested_ms(run, "serve.sync", "serve.prefill")
