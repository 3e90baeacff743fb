"""Training checkpoints: params, optimizer state and epoch bookkeeping in
one npz (port of humor_tpu/utils/checkpoint.py).

The keys are the JAX package's: "params" holds flax-msgpack bytes of the
params pytree (humor_torch.convert.encode_pytree), so
humor_tpu.utils.checkpoint.load_state and humor_torch.convert
.load_checkpoint both read a checkpoint written here; "epoch",
"min_train_loss", "min_val_loss". "opt_state" holds the port's own
optimizer state (train.step.Adamax) in the same encoding: it only has to
round-trip within the port, and the JAX package's optax state is not read
into it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from humor_torch import convert


def save_state(path: str, params: Any, opt_state: Optional[Dict] = None,
               epoch: int = 0, min_train_loss: float = float("inf"),
               min_val_loss: float = float("inf")) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": convert.encode_pytree(params),
        "epoch": int(epoch),
        "min_train_loss": float(min_train_loss),
        "min_val_loss": float(min_val_loss),
    }
    if opt_state is not None:
        payload["opt_state"] = convert.encode_pytree(opt_state)
    np.savez(path, **payload)


def _tensors(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def load_state(path: str, device="cpu") -> Dict[str, Any]:
    """-> {"params": float32 tensor pytree, "opt_state": tensor pytree or
    None, "epoch", "min_train_loss", "min_val_loss"}."""
    with np.load(path, allow_pickle=False) as raw:
        out = convert.load_checkpoint(path, device)
        out["opt_state"] = (
            _tensors(convert.decode_pytree(raw["opt_state"].tobytes()),
                     device) if "opt_state" in raw else None)
    return out
