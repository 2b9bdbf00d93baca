"""out_tok_s: every token generated inside the window over the window's
length."""


def read(run):
    n = sum(1 for r in run.reqs.values() for t in r.tokens
            if run.t_open < t <= run.t_close)
    return n / (run.t_close - run.t_open)
