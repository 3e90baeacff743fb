"""Frozen copy of humor_torch/fitting/robust.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

Robust residual weighting for the fitting energies (port of
humor_tpu/fitting/robust.py): the MAD scale, Tukey bisquare weights and
the Geman-McClure robustifier.

The median is JAX's: the mean of the two middle values for an even
count (torch.median returns the lower one), over the masked entries only,
and 0 for a row with none. Weights come from detached residuals, so no
gradient flows through them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BISQUARE_TUNE_CONST = 4.6851  # 95% Gaussian efficiency
MAD_TO_STD = 0.67449


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the last axis restricted to `mask` (bool, same shape),
    keepdim: inf-fill, sort, the interpolated middle. Rows with no valid
    entries return 0."""
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                   dim=-1).values
    n = mask.sum(dim=-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (torch.gather(s, -1, lo) + torch.gather(s, -1, hi))
    return torch.where(n > 0, med, torch.zeros_like(med))


def robust_std(res: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Median-absolute-deviation estimate of the std over the last axis,
    (..., N) -> (..., 1); with `mask`, padded entries are left out of both
    medians."""
    if mask is None:
        mask = torch.ones_like(res, dtype=torch.bool)
    med = masked_median(res, mask)
    mad = masked_median(torch.abs(res - med), mask)
    return mad / MAD_TO_STD


def bisquare_robust_weights(res: torch.Tensor,
                            tune_const: float = BISQUARE_TUNE_CONST,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Tukey bisquare weights over the last axis, zero past the cut
    |res| >= tune_const * robust_std."""
    scale = robust_std(res, mask) * tune_const
    norm_res = torch.abs(res) / torch.clamp(scale, min=1e-12)
    w = (1.0 - norm_res * norm_res) ** 2
    return torch.where(norm_res >= 1.0, torch.zeros_like(w), w)


def apply_robust_weighting(res: torch.Tensor,
                           robust_loss_type: str = "bisquare",
                           robust_tuning_const: float = BISQUARE_TUNE_CONST,
                           mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w * res^2, w) with the weights w computed from the detached
    residuals; `mask` restricts the scale statistics to visible
    residuals."""
    detached = res.detach()
    if robust_loss_type == "none":
        w = torch.ones_like(detached)
    elif robust_loss_type == "bisquare":
        w = bisquare_robust_weights(detached, robust_tuning_const, mask)
    else:
        raise ValueError(f"not a valid robust loss: {robust_loss_type!r}")
    return w * (res * res), w


def gmof(res: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robustifier: sigma^2 x^2 / (sigma^2 + x^2)."""
    x_sq = res * res
    s_sq = sigma * sigma
    return (s_sq * x_sq) / (s_sq + x_sq)
