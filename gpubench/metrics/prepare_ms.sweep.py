"""The sweep's scene preparation a call (scene loads, table removal,
segments, to their synchronize): the program's sweep.prepare spans, median
ms over the window's sweep calls."""

from gpubench import spans


def read(run):
    return spans.median_total_ms(run, "sweep.prepare")
