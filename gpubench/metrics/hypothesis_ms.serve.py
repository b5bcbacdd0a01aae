"""pipeline/api's hypothesis stage (segments, StoCS hypotheses, LCP scoring),
timings.hypothesis_s, median ms."""

from gpubench import timings


def read(run):
    return timings.median_ms(run, "hypothesis_s")
