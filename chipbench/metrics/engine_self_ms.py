"""engine_self_ms (engine): the mean over the window's ``serve.step``
spans of the step's time less its ``serve.prefill`` / ``serve.decode``
children (admission, scheduling, page accounting, event handling), read
from the program's own spans: the inside counterpart of
``engine_host_ms``."""
from chipbench.spans import self_ms


def read(run):
    return self_ms(run, "serve.step", ("serve.prefill", "serve.decode"))
