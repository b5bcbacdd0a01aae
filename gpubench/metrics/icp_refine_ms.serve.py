"""pipeline/api's ICP polish of the chosen poses (ops/icp.refine_icp),
timings.icp_refine_s, median ms."""

from gpubench import timings


def read(run):
    return timings.median_ms(run, "icp_refine_s")
