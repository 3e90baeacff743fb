"""HuMoR-Qual's SMPL joint feedback's share of the card in a training
chunk: the device seconds portbench/spans.py gives to the
"train.smpl_feedback" spans and the spans below them, over the profiled
chunk's busy seconds (portbench/train_qual_cell.feedback_regions)."""


def read(record):
    s = record.get("feedback")
    if not s or s["device_s"] is None or not s["busy_s"]:
        return None
    return 100.0 * s["device_s"] / s["busy_s"]
