"""Order statistics the benchmark reports (plain Python, no numpy)."""

from __future__ import annotations

import math


def percentile(values, p: float):
    """The ``p``-th percentile with linear interpolation between the two
    nearest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)

