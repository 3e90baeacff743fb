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

from typing import Dict, Tuple

import numpy as np
import torch

_INDEX: Dict[Tuple[bytes, torch.device], torch.Tensor] = {}


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


def device_index(values, device) -> torch.Tensor:
    """The int64 index tensor of `values` on `device`, made once and kept:
    indexing with it copies nothing from the host, so a step that picks
    constant ids (a skeleton's parents, the contact joints) runs without
    a host-to-device copy and can be captured in a CUDA graph."""
    arr = np.ascontiguousarray(values, dtype=np.int64).reshape(-1)
    key = (arr.tobytes(), torch.device(device))
    idx = _INDEX.get(key)
    if idx is None:
        idx = _INDEX[key] = torch.as_tensor(arr, device=device)
    return idx
