"""decode_sync_ms (lane runner): the mean ``serve.sync`` span inside a
``serve.decode`` in the window: the greedy pick and its copy to the host,
where the decode call waits for the device."""
from chipbench.spans import nested_ms


def read(run):
    return nested_ms(run, "serve.sync", "serve.decode")
