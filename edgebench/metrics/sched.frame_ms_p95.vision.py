"""95th percentile of a frame's latency over every frame handed over in
the window, from its hand-over (closed loop) or due time (open loop) to
its last task's result on the host: in a closed loop at the slot count it
is ~256 clients over the rate, and its tail swings with the host's pace,
so it stands beside the rate as a per-layer reading."""

from ebench.stats import percentile


def read(run):
    lats = run.counters.get("frame_lats_s")
    if not lats:
        return None
    return percentile(lats, 95) * 1e3
