"""VPoser body-pose prior (VAE over SMPL body poses) (port of
humor_tpu/models/vposer.py; public VPoser v1.0 architecture: 512 hidden,
32-d latent, 21 joints, eval-mode BatchNorm). `train_loss` is the
autoencoding loss the in-repo fixture trains on (humor_torch.testing),
through the same eval-mode functions, as the JAX package does.

    encode(aa 63) : BN -> Linear(63,512) -> LeakyReLU(.2) -> BN ->
                    Linear(512,512) -> LeakyReLU(.2) -> {mu, softplus(sigma)}
    decode(z 32)  : Linear(32,512) -> LeakyReLU(.2) -> Linear(512,512) ->
                    LeakyReLU(.2) -> Linear(512,126) -> 6d-to-rotmat
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from humor_torch.ops import transforms

_BN_EPS = 1e-5
_LEAK = 0.2


@dataclass(frozen=True)
class VPoserConfig:
    latent_dim: int = 32
    hidden: int = 512
    num_joints: int = 21

    @property
    def pose_dim(self) -> int:
        return self.num_joints * 3


def init_params(cfg: VPoserConfig, generator: torch.Generator,
                device="cpu") -> Dict:
    """Seeded random weights: He-normal weights, torch-Linear-style
    nonzero biases (zero biases map z=0 to a degenerate 6d rotation)."""
    def lin(n_in, n_out):
        w = torch.randn(n_in, n_out, generator=generator) * (2.0 / n_in) ** 0.5
        bound = 1.0 / n_in ** 0.5
        b = (torch.rand(n_out, generator=generator) * 2 - 1) * bound
        return {"w": w.to(device), "b": b.to(device)}

    def bn(n):
        return {"scale": torch.ones(n, device=device),
                "bias": torch.zeros(n, device=device),
                "mean": torch.zeros(n, device=device),
                "var": torch.ones(n, device=device)}

    h, l, p = cfg.hidden, cfg.latent_dim, cfg.pose_dim
    return {
        "enc_bn1": bn(p), "enc_fc1": lin(p, h), "enc_bn2": bn(h),
        "enc_fc2": lin(h, h), "enc_mu": lin(h, l), "enc_logvar": lin(h, l),
        "dec_fc1": lin(l, h), "dec_fc2": lin(h, h),
        "dec_out": lin(h, cfg.num_joints * 6),
    }


def _linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _batchnorm(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return (x - p["mean"]) * torch.rsqrt(p["var"] + _BN_EPS) * p["scale"] \
        + p["bias"]


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=_LEAK)


def encode(cfg: VPoserConfig, params: Dict, pose_aa: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body pose aa (..., 63) -> posterior (mean, std) (..., latent)."""
    x = _batchnorm(params["enc_bn1"], pose_aa)
    x = _leaky(_linear(params["enc_fc1"], x))
    x = _batchnorm(params["enc_bn2"], x)
    x = _leaky(_linear(params["enc_fc2"], x))
    mu = _linear(params["enc_mu"], x)
    std = F.softplus(_linear(params["enc_logvar"], x))
    return mu, std


def decode_matrot(cfg: VPoserConfig, params: Dict, z: torch.Tensor
                  ) -> torch.Tensor:
    """Latent (..., latent) -> rotation matrices (..., J*9)."""
    x = _leaky(_linear(params["dec_fc1"], z))
    x = _leaky(_linear(params["dec_fc2"], x))
    x6 = _linear(params["dec_out"], x)
    batch_shape = x6.shape[:-1]
    R = transforms.rot6d_to_rotmat(x6.reshape(*batch_shape,
                                              cfg.num_joints, 6))
    return R.reshape(*batch_shape, cfg.num_joints * 9)


def latent2pose(cfg: VPoserConfig, params: Dict, z: torch.Tensor
                ) -> torch.Tensor:
    """Latent (..., latent) -> aa body pose (..., J*3)."""
    mats = decode_matrot(cfg, params, z)
    batch_shape = mats.shape[:-1]
    R = mats.reshape(*batch_shape, cfg.num_joints, 3, 3)
    return transforms.rotmat_to_aa(R).reshape(*batch_shape, cfg.pose_dim)


def pose2latent(cfg: VPoserConfig, params: Dict, pose_aa: torch.Tensor
                ) -> torch.Tensor:
    """aa body pose (..., J*3) -> posterior mean latent (..., latent)."""
    return encode(cfg, params, pose_aa)[0]


def sample_poses(cfg: VPoserConfig, params: Dict, num: int,
                 z: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """aa body poses (num, J*3) decoded from standard-normal latents `z`
    (num, latent), else drawn from `generator` (on its device)."""
    if z is None:
        z = torch.randn(num, cfg.latent_dim, generator=generator,
                        device=generator.device if generator is not None
                        else "cpu")
    dev = params["dec_fc1"]["w"].device
    return latent2pose(cfg, params, z.to(dev))


def train_loss(cfg: VPoserConfig, params: Dict, pose_aa: torch.Tensor
               ) -> torch.Tensor:
    """Autoencoding loss on aa poses (N, J*3): the reconstruction MSE of
    the posterior mean plus 1e-3 x the KL term written as the JAX fixture
    writes it, 0.5 mean(mu^2 + std^2 - 2 log(std + 1e-8) - 1)."""
    mu, std = encode(cfg, params, pose_aa)
    rec = latent2pose(cfg, params, mu)
    kl = 0.5 * torch.mean(mu ** 2 + std ** 2 - 2 * torch.log(std + 1e-8) - 1)
    return torch.mean(torch.square(rec - pose_aa)) + 1e-3 * kl
