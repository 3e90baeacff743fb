"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is "cuda", and asking for it without a GPU raises instead
of quietly running on the CPU. Float32 matmuls are pinned to full f32
(no TF32), the counterpart of JAX's `precision=HIGHEST`: TF32 keeps about
three digits, and the 59-step rollout chain amplifies that. bf16 GEMMs
(the bf16 precision policy) reduce split-K partial sums in f32, as JAX
accumulates them, not in bf16.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for
    (the default) and no GPU is present."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "humor_torch entry points run on the GPU by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
