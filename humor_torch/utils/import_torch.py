"""Released reference checkpoints -> the port's parameter dicts (port of
humor_tpu/utils/import_torch.py).

The HuMoR checkpoint (.pth) stores `model_state_dict` with sub-network
keys `encoder.net.{i}`, `prior_net.net.{i}`, `decoder.net.{i}`, each
ModuleList interleaving [Linear, GroupNorm, ReLU, Linear, ...]; a
DataParallel "module." prefix is dropped. MLP layer j maps to Linear
net.{3j} and, from j = 1, the GroupNorm net.{3j-2} over its input
(ops/mlp.py's layout). Linear weights transpose from (out, in) to
(in, out). VPoser v1.0 snapshots (.pt) map by name; the initial-state
GMM is an npz of weights, means and covariances. The JAX package's own
checkpoints (flax msgpack in an npz) load with convert.load_checkpoint.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from humor_torch.models.gmm import GmmParams

# ours -> the VPoser v1.0 state dict's module names
_VPOSER_MAP = {
    "enc_bn1": "bodyprior_enc_bn1",
    "enc_fc1": "bodyprior_enc_fc1",
    "enc_bn2": "bodyprior_enc_bn2",
    "enc_fc2": "bodyprior_enc_fc2",
    "enc_mu": "bodyprior_enc_mu",
    "enc_logvar": "bodyprior_enc_logvar",
    "dec_fc1": "bodyprior_dec_fc1",
    "dec_fc2": "bodyprior_dec_fc2",
    "dec_out": "bodyprior_dec_out",
}


def _t(v, device="cpu") -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return torch.as_tensor(np.array(v, np.float32), device=device)


def strip_prefix(sd: Dict, prefix: str = "module.") -> Dict:
    """Drop a DataParallel-style prefix."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def _import_mlp(sd: Dict, base: str, device="cpu") -> List[dict]:
    """One reference MLP's layers from the state dict."""
    lin_idx = sorted(
        int(k.split(".")[-2]) for k, v in sd.items()
        if k.startswith(f"{base}.net.") and k.endswith(".weight")
        and np.ndim(v) == 2)
    layers: List[dict] = []
    for j, i in enumerate(lin_idx):
        layer = {"w": _t(sd[f"{base}.net.{i}.weight"], device).t()
                 .contiguous(),
                 "b": _t(sd[f"{base}.net.{i}.bias"], device)}
        if j > 0:
            layer["gn_scale"] = _t(sd[f"{base}.net.{i - 2}.weight"], device)
            layer["gn_bias"] = _t(sd[f"{base}.net.{i - 2}.bias"], device)
        layers.append(layer)
    return layers


def humor_params_from_state_dict(sd: Dict, device="cpu") -> Dict:
    """Reference HumorModel state dict -> {'encoder', 'decoder'[,
    'prior']}; frozen body-model buffers in it are ignored."""
    sd = strip_prefix(dict(sd))
    params = {"encoder": _import_mlp(sd, "encoder", device),
              "decoder": _import_mlp(sd, "decoder", device)}
    if any(k.startswith("prior_net.") for k in sd):
        params["prior"] = _import_mlp(sd, "prior_net", device)
    return params


def load_humor_checkpoint(path: str, device="cpu") -> Dict:
    """A reference .pth training checkpoint -> HuMoR params."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return humor_params_from_state_dict(ckpt.get("model_state_dict", ckpt),
                                        device)


def vposer_params_from_state_dict(sd: Dict, device="cpu") -> Dict:
    """VPoser v1.0 state dict -> the port's VPoser params (Linear weights
    transposed, BatchNorm running statistics carried)."""
    params: Dict = {}
    for ours, theirs in _VPOSER_MAP.items():
        if ours.endswith(("bn1", "bn2")):
            params[ours] = {
                "scale": _t(sd[f"{theirs}.weight"], device),
                "bias": _t(sd[f"{theirs}.bias"], device),
                "mean": _t(sd[f"{theirs}.running_mean"], device),
                "var": _t(sd[f"{theirs}.running_var"], device)}
        else:
            params[ours] = {
                "w": _t(sd[f"{theirs}.weight"], device).t().contiguous(),
                "b": _t(sd[f"{theirs}.bias"], device)}
    return params


def load_vposer_checkpoint(path: str, device="cpu") -> Dict:
    """A released VPoser v1.0 snapshot .pt -> VPoser params."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(sd, dict) or "bodyprior_enc_fc1.weight" not in sd:
        sd = sd.get("state_dict", sd)
    return vposer_params_from_state_dict(sd, device)


def load_gmm_checkpoint(path: str, device="cpu") -> GmmParams:
    """The initial-state GMM npz (weights, means, covariances)."""
    with np.load(path) as raw:
        return GmmParams(_t(raw["weights"], device), _t(raw["means"], device),
                         _t(raw["covariances"], device))
