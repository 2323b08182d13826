"""Model FLOPs served in the window (the frozen counts of
``ebench/work.py``: routed top-k rows, real prompt tokens, live decode
lanes) over the window's length, as a share of the card's bf16 peak."""

from ebench.shares import mfu


def read(run):
    return mfu(run)
