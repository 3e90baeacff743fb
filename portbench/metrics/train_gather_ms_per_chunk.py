"""Host milliseconds of a chunk's data: the "data.gather" (the device
store's sampling and gather) and "data.pairs" (canonicalization into
training pairs) spans of one recorded chunk
(portbench/spans.train_regions)."""


def read(record):
    s = record.get("train_spans")
    return None if not s else s["gather_ms"]
