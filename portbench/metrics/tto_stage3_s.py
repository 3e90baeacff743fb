"""Stage 3's seconds a fit, the median over the window's fits, from the
runner's own `timings=` (a synchronised clock at each stage's end)."""

import statistics


def read(record):
    secs = record.get("stage3_s")
    return statistics.median(secs) if secs else None
