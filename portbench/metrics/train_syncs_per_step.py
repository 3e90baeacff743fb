"""Host synchronisations a training step: the warnings torch.cuda's sync
debug mode gives over one chunk, over the chunk's steps."""


def read(record):
    return record.get("syncs_per_step")
