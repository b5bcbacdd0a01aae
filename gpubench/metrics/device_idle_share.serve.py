"""The share of the traced window in which the card ran nothing."""

from gpubench import timings


def read(run):
    return timings.idle_share(run)
