"""The LCP kernels' share of their bound in the sweep (roofline.py), %."""

from gpubench import roofline


def read(run):
    return roofline.lcp_share(run)
