"""Host synchronisations an L-BFGS iteration: the synchronising
operations humor_torch's recorder counted over the fit at the cut budget
(portbench/spans.fit_regions, recorded with torch.cuda's sync debug
mode), over its L-BFGS iterations (its "lbfgs.iter" spans)."""


def read(record):
    s = record.get("fit_spans")
    if not s or not s["iters"]:
        return None
    return s["syncs"] / s["iters"]
