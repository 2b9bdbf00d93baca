"""ttft_p90_ms: 90th percentile of the first-token time, from each due
time, over every request due in the window (unserved ones at their wait
so far)."""
from chipbench.stats import percentile, ttft_s


def read(run):
    v = ttft_s(run)
    return 1e3 * percentile(v, 90) if v else None
