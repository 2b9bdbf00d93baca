"""admit_wait_p90_ms (engine): 90th percentile of admission minus due time
over the requests due in the window (one not admitted by the end of the
host-clock window at its wait so far)."""
import math

from chipbench.stats import percentile


def read(run):
    end = run.t_host_end
    v = [(r.admit if not math.isnan(r.admit) and r.admit <= end else end)
         - r.due for r in run.window_reqs if r.due < end]
    return 1e3 * percentile(v, 90) if v else None
