"""itl_p95_ms: 95th percentile over every gap between consecutive tokens
in the window, open gaps at the close counted at their length so far."""
from chipbench.stats import gaps_s, percentile


def read(run):
    v = gaps_s(run)
    return 1e3 * percentile(v, 95) if v else None
