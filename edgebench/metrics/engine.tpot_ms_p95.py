"""95th percentile over the window's finished requests of the time per
output token after the first: (t_done - t_first) / (tokens - 1)."""

from ebench.stats import percentile


def read(run):
    tpots = run.counters.get("tpots_s")
    if not tpots:
        return None
    return percentile(tpots, 95) * 1e3
