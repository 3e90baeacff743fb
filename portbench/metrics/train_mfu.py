"""A training step's share of the chip's float32 peak: the model FLOP of
a step (portbench/counts.py) over the window's seconds a step times
67 TFLOP/s."""

from portbench.counts import F32_PEAK


def read(record):
    step = record.get("step_s")
    if not step:
        return None
    return 100.0 * record["step_flops"] / (step * F32_PEAK)
