"""Host milliseconds an L-BFGS iteration of stage 3: the median duration
of the "lbfgs.iter" spans under "fit.stage3" in the plain recorded fit at
the cut budget (portbench/spans.fit_regions)."""

import statistics


def read(record):
    s = record.get("fit_spans")
    if not s or not s["stage3_iter_ms"]:
        return None
    return statistics.median(s["stage3_iter_ms"])
