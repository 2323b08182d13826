"""Share of the traced stretch in which no kernel, copy or set ran on the
card (1 - the union of device intervals over the stretch's host time)."""

from ebench.shares import idle


def read(run):
    return idle(run)
