"""95th percentile of the time to first token over every request handed
over in the window (``Request.t_first - Request.arrival``): in a closed
loop at the slot count the tail swings with the order of the sizes, so it
stands beside the rate as a per-layer reading."""

from ebench.stats import percentile


def read(run):
    ttfts = run.counters.get("ttfts_s")
    if not ttfts:
        return None
    return percentile(ttfts, 95) * 1e3
