"""Frozen copy of humor_torch/models/gmm.py, part of the benchmark's plain
reference; it imports nothing of humor_torch. Only the path the
benchmark's cells run is kept.

Initial-state Gaussian-mixture prior (port of humor_tpu/models/gmm.py):
its log-density only, the part the test-time fit reads.

The TTO scores the optimized frame-0 state (138-d: joints 66, joints_vel
66, trans_vel 3, root_orient_vel 3) under a 12-component full-covariance
mixture. A non-positive-definite covariance gives NaN, as
jnp.linalg.cholesky does (torch.linalg.cholesky would raise).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class GmmParams(NamedTuple):
    weights: torch.Tensor  # (K,)
    means: torch.Tensor    # (K, D)
    covs: torch.Tensor     # (K, D, D)

    @property
    def num_components(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[-1]


def cholesky(covs: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors, NaN where a matrix is not positive
    definite."""
    chol, info = torch.linalg.cholesky_ex(covs)
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def chol_terms(gmm: GmmParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inverse Cholesky factors (K, D, D), log-determinants (K,)); NaN
    for a non-PD covariance."""
    chol = cholesky(gmm.covs)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                      dim2=-1)), dim=-1)
    eye = torch.eye(gmm.dim, dtype=chol.dtype, device=chol.device).expand(
        gmm.num_components, gmm.dim, gmm.dim)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return chol_inv, logdet


def component_log_prob(gmm: GmmParams, x: torch.Tensor,
                       terms: Optional[Tuple] = None) -> torch.Tensor:
    """Per-component Gaussian log-density: x (..., D) -> (..., K).
    `terms` = chol_terms(gmm), precomputed once for frozen mixtures."""
    chol_inv, logdet = chol_terms(gmm) if terms is None else terms
    diff = x[..., None, :] - gmm.means
    y = torch.einsum("kij,...kj->...ki", chol_inv, diff)
    maha = torch.sum(y * y, dim=-1)
    return -0.5 * (maha + logdet + gmm.dim * math.log(2.0 * math.pi))


def log_prob(gmm: GmmParams, x: torch.Tensor,
             terms: Optional[Tuple] = None) -> torch.Tensor:
    """Mixture log-density: x (..., D) -> (...)."""
    comp = component_log_prob(gmm, x, terms)
    return torch.logsumexp(comp + torch.log(gmm.weights), dim=-1)
