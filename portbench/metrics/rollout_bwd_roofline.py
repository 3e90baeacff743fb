"""The rollout backward's share of its roofline: the bound of every
backward rollout the profiled fit makes (counted from its evaluations,
portbench/counts.py) over the device time of the kernels named below."""

PATTERNS = ("rollout_bwd_kernel",)


def read(record):
    prof = record.get("profile")
    if prof is None:
        return None
    seconds, n = prof.seconds_of(PATTERNS)
    if n == 0 or seconds <= 0.0:
        return None
    return 100.0 * record["work_cut"]["rollout_bwd_bound_s"] / seconds
