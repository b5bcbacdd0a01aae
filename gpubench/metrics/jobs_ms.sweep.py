"""The sweep's job batch a call (hypotheses, LCP scoring and the ICP polish
of every (scene, object) job, dispatched and finalized): the program's
sweep.jobs spans, median ms over the window's sweep calls."""

from gpubench import spans


def read(run):
    return spans.median_total_ms(run, "sweep.jobs")
