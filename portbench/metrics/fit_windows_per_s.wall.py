"""The window's fit rate on the host's clock: every window fitted over
the time from the first fit's start to the last fit's end, read in the
--trace 1 runs, whose fits run without the busy meter's profiler."""


def read(record):
    return record.get("windows_per_s")
