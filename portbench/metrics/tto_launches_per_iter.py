"""Device kernels the profiler records a L-BFGS iteration, over the
profiled fit at the cut budget (its iterations from the configuration:
every stage's and stage-3 phase's, summed)."""


def read(record):
    prof = record.get("profile")
    if prof is None or not prof.launches:
        return None
    return prof.launches / record["cut_iters"]
