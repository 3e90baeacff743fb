"""The whole fit's share of the chip's float32 peak: the model FLOP of a
fit (portbench/counts.py) over the median plain fit wall of the window
times 67 TFLOP/s."""

import statistics

from portbench.counts import F32_PEAK


def read(record):
    walls = record.get("fit_wall_s")
    if not walls:
        return None
    return 100.0 * record["work"]["flops"] / (statistics.median(walls)
                                              * F32_PEAK)
