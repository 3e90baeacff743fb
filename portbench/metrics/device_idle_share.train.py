"""The device's idle share of training: 1 - the union of the
device-kernel intervals of one profiled chunk over the window's plain
seconds a chunk."""


def read(record):
    prof = record.get("profile")
    if prof is None or not prof.launches:
        return None
    return 100.0 * (1.0 - prof.busy_s() / record["chunk_s"])
