"""The SMPL losses' share of the card in a training chunk: the device
seconds portbench/spans.py gives to the "train.smpl_losses" span and the
spans below it (their forward kernels and the backward kernels their
autograd nodes caused), over the profiled chunk's busy seconds (the
spans' own annotations left out)."""


def read(record):
    s = record.get("train_spans")
    if not s or not s["busy_s"]:
        return None
    return 100.0 * s["smpl_device_s"] / s["busy_s"]
