"""Host milliseconds a training step of HuMoR-Qual's SMPL joint
feedback: the "train.smpl_feedback" spans of one recorded chunk over its
steps (portbench/train_qual_cell.feedback_regions)."""


def read(record):
    s = record.get("feedback")
    if not s or s["host_ms"] is None:
        return None
    return s["host_ms"] / s["steps"]
