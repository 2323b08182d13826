"""What the readers of device shares have in common."""

from ebench import work


def mfu(run):
    """Model FLOPs served over the window, as a share of the card's bf16
    peak; None off the peaks table or without work."""
    c = run.counters
    peak = work.peaks(run.kind)
    if peak is None or not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / c["window_s"] / peak[0]


def roofline(run, kernel: str, prefixes):
    """The bound of ``kernel``'s work in the traced stretch over the device
    time of the kernels (by name prefix) that do it."""
    t = run.trace
    if not t or kernel not in t.get("bounds", {}):
        return None
    busy = sum(s for n, s in t["kernel_s"].items()
               if n.startswith(tuple(prefixes)))
    if busy <= 0:
        return None
    return 100.0 * t["bounds"][kernel] / busy


def idle(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
