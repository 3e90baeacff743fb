"""Data-parallel training and the windows-sharded fit over
torch.distributed (port of humor_tpu/parallel)."""
