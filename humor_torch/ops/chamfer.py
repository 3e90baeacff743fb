"""Nearest-neighbour / Chamfer distance for the point-cloud fitting energy
(port of humor_tpu/ops/chamfer.py).

`nn_distance(xyz1, xyz2)`: for each point of xyz1 (B, N, 3) the squared
distance to, and the int32 index of, its closest point of xyz2 (B, M, 3).
On CUDA tensors the forward is the hand-written kernel of
csrc/nn_distance.cu (it replaces the Pallas kernel `_nn_pallas`,
humor_tpu/ops/chamfer.py:90); on CPU tensors it is the plain version
below. The gradient never needs the distance matrix: d/dx |x - y_nn|^2 =
2 (x - y_nn) with y_nn gathered by the argmin index, and xyz2's gradient
is the scatter-add of the negated terms (`_nn_bwd` of the JAX module),
written as torch ops.

Distances use the expanded form |x|^2 + |y|^2 - 2 x.y in full float32 (no
TF32), with a first-index argmin and a clamp at 0, as the JAX package
computes them. Observed points that are missing sit at 1e6 (the point-cloud
energy puts them there); their neighbour is rounding noise and the energy
masks them out.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from humor_torch.ops import cuda_build

# Kernel launch count: the wrapper adds one where it launches the kernel.
launches = {"nn_distance": 0}

# plain version's working set: at most this many distance entries at once
_PLAIN_CHUNK_ELEMS = 1 << 26
_CHUNK_M = 2048


def nn_distance_plain(xyz1: torch.Tensor, xyz2: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `_nn_jnp` formula in torch: a running (min, argmin) over chunks
    of M and of the cloud batch, so peak memory stays bounded. A tie goes
    to the lowest index (strict `<` across chunks, argmin's first index
    within one)."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    mc = min(M, _CHUNK_M)
    bc = max(1, min(B, _PLAIN_CHUNK_ELEMS // max(N * mc, 1)))
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


def _check_inputs(xyz1: torch.Tensor, xyz2: torch.Tensor) -> None:
    for name, t in (("xyz1", xyz1), ("xyz2", xyz2)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"nn_distance: {name} must be (B, n, 3), got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"nn_distance: {name} must be a contiguous "
                             f"float32 tensor, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    if xyz1.device != xyz2.device:
        raise ValueError(f"nn_distance: xyz1 on {xyz1.device}, xyz2 on "
                         f"{xyz2.device}")
    if xyz1.shape[0] != xyz2.shape[0]:
        raise ValueError("nn_distance: xyz1 and xyz2 hold different numbers "
                         f"of clouds ({xyz1.shape[0]} vs {xyz2.shape[0]})")
    if xyz2.shape[1] == 0:
        raise ValueError("nn_distance: xyz2 has no points")


def _lib():
    lib = cuda_build.load("nn_distance")
    fn = lib.nn_distance
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       P]
        fn.restype = ctypes.c_int
    return lib


def _nn_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_inputs(xyz1, xyz2)
    B, N = xyz1.shape[:2]
    M = xyz2.shape[1]
    dist = torch.empty(B, N, dtype=torch.float32, device=xyz1.device)
    idx = torch.empty(B, N, dtype=torch.int32, device=xyz1.device)
    if B * N == 0:
        return dist, idx
    lib = _lib()
    stream = torch.cuda.current_stream(xyz1.device).cuda_stream
    rc = lib.nn_distance(xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(),
                         idx.data_ptr(), B, N, M, stream)
    cuda_build.check(lib, rc, "nn_distance")
    launches["nn_distance"] += 1
    return dist, idx


def nn_forward(xyz1: torch.Tensor, xyz2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if xyz1.device.type == "cpu":
        _check_inputs(xyz1, xyz2)
        return nn_distance_plain(xyz1, xyz2)
    return _nn_cuda(xyz1, xyz2)


class NNDistance(torch.autograd.Function):
    """(xyz1, xyz2) -> (dist (B, N), idx (B, N) int32); differentiable in
    both clouds, idx has no gradient."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
        dist, idx = nn_forward(xyz1, xyz2)
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
        g2 = torch.zeros(B * M, 3, dtype=xyz2.dtype, device=xyz2.device)
        g2.index_add_(0, flat, -diff.reshape(B * N, 3))
        return diff, g2.reshape(B, M, 3)


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-way squared NN distances and indices (see the module
    docstring)."""
    return NNDistance.apply(xyz1, xyz2)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared NN distances: (dist1 (B, N), dist2 (B, M))."""
    d1, _ = nn_distance(xyz1, xyz2)
    d2, _ = nn_distance(xyz2, xyz1)
    return d1, d2
