"""decode_ctx_used_pct (model step): the positions the live rows attend
(each at its position + 1, counted by the engine) over the positions the
decode calls gather and attend (every row over its gathered view, counted
by the runner that gathers it), summed over the window's ``serve.decode``
spans."""
from chipbench.spans import in_window


def read(run):
    spans = in_window(run)
    if spans is None:
        return None
    dec = [s.attrs for s in spans
           if s.name == "serve.decode" and "ctx_attended" in s.attrs]
    attended = sum(a["ctx_attended"] for a in dec)
    if not attended:
        return None
    return 100.0 * sum(a["ctx_used"] for a in dec) / attended
