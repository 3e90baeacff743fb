"""The nearest neighbour of the point-cloud energy, plain: a copy of
humor_torch/ops/chamfer.py's plain version (`nn_distance_plain`) and its
autograd rule, on every device. Imports nothing of humor_torch.

`nn_distance(xyz1, xyz2)`: for each point of xyz1 (B, N, 3) the squared
distance to, and the int32 index of, its closest point of xyz2 (B, M, 3),
in the expanded form |x|^2 + |y|^2 - 2 x.y in float32, a first-index
argmin and a clamp at 0. The gradient is 2 (x - y_nn) for xyz1 and the
scatter-add of its negation for xyz2.
"""

from __future__ import annotations

from typing import Tuple

import torch

# working set of the running (min, argmin): at most this many distances
_CHUNK_ELEMS = 1 << 26
_CHUNK_M = 2048


def nn_distance_plain(xyz1: torch.Tensor, xyz2: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A running (min, argmin) over chunks of M and of the cloud batch; a
    tie goes to the lowest index."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    mc = min(M, _CHUNK_M)
    bc = max(1, min(B, _CHUNK_ELEMS // max(N * mc, 1)))
    sq1 = (xyz1 * xyz1).sum(-1)
    sq2 = (xyz2 * xyz2).sum(-1)
    dist = torch.empty(B, N, dtype=xyz1.dtype, device=xyz1.device)
    idx = torch.empty(B, N, dtype=torch.int32, device=xyz1.device)
    for b0 in range(0, B, bc):
        x, s1 = xyz1[b0:b0 + bc], sq1[b0:b0 + bc]
        best_d = best_i = None
        for m0 in range(0, M, mc):
            y = xyz2[b0:b0 + bc, m0:m0 + mc]
            cross = torch.bmm(x, y.transpose(1, 2))
            d = s1[..., None] + sq2[b0:b0 + bc, None, m0:m0 + mc] - 2.0 * cross
            i = torch.argmin(d, dim=-1, keepdim=True)
            dm = torch.gather(d, -1, i)[..., 0]
            i = i[..., 0].to(torch.int32) + m0
            if best_d is None:
                best_d, best_i = dm, i
            else:
                take = dm < best_d
                best_d = torch.where(take, dm, best_d)
                best_i = torch.where(take, i, best_i)
        dist[b0:b0 + bc] = torch.clamp(best_d, min=0.0)
        idx[b0:b0 + bc] = best_i
    return dist, idx


class NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
        dist, idx = nn_distance_plain(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, idx)
        ctx.mark_non_differentiable(idx)
        return dist, idx

    @staticmethod
    def backward(ctx, g_dist, _g_idx):
        xyz1, xyz2, idx = ctx.saved_tensors
        B, N = idx.shape
        M = xyz2.shape[1]
        flat = (idx.long() + M * torch.arange(B, device=idx.device)[:, None]
                ).reshape(-1)
        nn = xyz2.reshape(B * M, 3).index_select(0, flat).reshape(B, N, 3)
        diff = 2.0 * (xyz1 - nn) * g_dist[..., None]
        g2 = torch.zeros(B * M, 3, dtype=diff.dtype, device=diff.device)
        g2.index_put_((flat,), -diff.reshape(B * N, 3), accumulate=True)
        return diff, g2.reshape(B, M, 3)


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return NNDistance.apply(xyz1, xyz2)
