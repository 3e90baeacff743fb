"""The device's idle share of a fit: 1 - the union of the device-kernel
intervals of the profiled fit at the cut budget over the plain wall of
the same fit run without the profiler."""


def read(record):
    prof = record.get("profile")
    if prof is None or not prof.launches:
        return None
    return 100.0 * (1.0 - prof.busy_s() / record["cut_plain_wall_s"])
