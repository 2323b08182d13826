"""Median wait from a request's hand-over to its admission into a decode
slot (``Request.t_admit - Request.arrival``), over the window's
requests."""

from ebench.stats import percentile


def read(run):
    waits = run.counters.get("admit_waits_s")
    if not waits:
        return None
    return percentile(waits, 50) * 1e3
