"""setup_s: process start to the window's opening (imports, the kernels'
build or load, the weights, the engine, the warm-up, the traffic's
load-in or first admissions)."""


def read(run):
    return run.t_open - run.t_start
