"""The nearest neighbour's share of its roofline: the bound of every
search the profiled fit makes (6 FLOP a pair, counted from its
evaluations, portbench/counts.py) over the device time of the kernels
named below."""

PATTERNS = ("nn_kernel",)


def read(record):
    prof = record.get("profile")
    if prof is None or not record["work_cut"]["nn_bound_s"]:
        return None
    seconds, n = prof.seconds_of(PATTERNS)
    if n == 0 or seconds <= 0.0:
        return None
    return 100.0 * record["work_cut"]["nn_bound_s"] / seconds
