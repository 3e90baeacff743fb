"""Frozen copy of humor_torch/ops/transforms.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

Rotation / rigid-transform library (port of humor_tpu/ops/transforms.py).

Functions accept arbitrary leading batch dims. Branches are `torch.where`
selects with both sides kept away from their singularities (the
double-where trick), and every epsilon keeps the JAX module's float32
scale: a tiny epsilon turns float32 roundoff near the identity into
~1e9-scale gradients (see the quat_to_aa and rot6d docstrings there).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _norm_safe(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
               eps: float = _EPS) -> torch.Tensor:
    """L2 norm with a grad-safe guard at 0 (returns eps there)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def aa_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3) (Rodrigues),
    with the reference's +1e-8 bias inside the norm."""
    batch_shape = aa.shape[:-1]
    aa = aa.reshape(-1, 3)
    angle = _norm_safe(aa + 1e-8, dim=1)  # (N, 1)
    axis = aa / angle
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    rx, ry, rz = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    R = eye + s * K + (1.0 - c) * torch.matmul(K, K)
    return R.reshape(*batch_shape, 3, 3)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6d rep (..., 6) -> (..., 3, 3) via Gram-Schmidt; the 6 numbers are
    the first two columns read row-major from a (3, 2) view. eps=1e-4
    keeps the pullback of degenerate inputs bounded."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / _norm_safe(a1, eps=1e-4)
    a2_proj = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2_proj / _norm_safe(a2_proj, eps=1e-4)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    R = torch.stack([b1, b2, b3], dim=-1)
    return R.reshape(*batch_shape, 3, 3)


def rot9d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """9d rep (..., 9) -> the closest rotation (..., 3, 3) by SVD
    projection, U diag(1, 1, det(U V^T)) V^T (independent of the SVD's
    sign choices; its gradient is unstable near repeated singular
    values)."""
    batch_shape = x.shape[:-1]
    u, _, vt = torch.linalg.svd(x.reshape(-1, 3, 3), full_matrices=False)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (u * d[:, None, :]) @ vt
    return R.reshape(*batch_shape, 3, 3)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4), (w, x, y, z),
    by the branchless 4-case selection of the JAX module."""
    batch_shape = R.shape[:-2]
    rt = R.reshape(-1, 3, 3).transpose(-1, -2)
    r00, r01, r02 = rt[:, 0, 0], rt[:, 0, 1], rt[:, 0, 2]
    r10, r11, r12 = rt[:, 1, 0], rt[:, 1, 1], rt[:, 1, 2]
    r20, r21, r22 = rt[:, 2, 0], rt[:, 2, 1], rt[:, 2, 2]

    t0 = 1.0 + r00 - r11 - r22
    q0 = torch.stack([r12 - r21, t0, r01 + r10, r20 + r02], dim=-1)
    t1 = 1.0 - r00 + r11 - r22
    q1 = torch.stack([r20 - r02, r01 + r10, t1, r12 + r21], dim=-1)
    t2 = 1.0 - r00 - r11 + r22
    q2 = torch.stack([r01 - r10, r20 + r02, r12 + r21, t2], dim=-1)
    t3 = 1.0 + r00 + r11 + r22
    q3 = torch.stack([t3, r12 - r21, r20 - r02, r01 - r10], dim=-1)

    eps = 1e-6
    mask_d2 = r22 < eps
    mask_d0_d1 = r00 > r11
    mask_d0_nd1 = r00 < -r11
    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1

    t_sel = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    q_sel = torch.where(
        c0[:, None], q0,
        torch.where(c1[:, None], q1, torch.where(c2[:, None], q2, q3)))
    denom = torch.sqrt(torch.clamp(t_sel, min=eps))
    q = 0.5 * q_sel / denom[:, None]
    return q.reshape(*batch_shape, 4)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz -> angle-axis (..., 3). Shortest arc
    (w >= 0); below sin^2 < 1e-4 the angle/sin ratio switches to its
    Taylor limit (float32-sized threshold)."""
    flip = torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    q = q * flip
    qw, qvec = q[..., 0], q[..., 1:]
    sin_sq = torch.sum(qvec * qvec, dim=-1)
    is_small = sin_sq < 1e-4
    sin_safe = torch.sqrt(torch.where(is_small, torch.ones_like(sin_sq),
                                      sin_sq))
    angle = 2.0 * torch.atan2(sin_safe, qw)
    k_large = angle / sin_safe
    k_small = 2.0 / torch.clamp(qw, min=1e-6)
    k = torch.where(is_small, k_small, k_large)
    return qvec * k[..., None]


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> angle-axis (..., 3)."""
    return quat_to_aa(rotmat_to_quat(R))


_REP_SIZE = {"aa": 3, "6d": 6, "9d": 9, "mat": 9}


def convert_to_rotmat(x: torch.Tensor, rep: str) -> torch.Tensor:
    """Packed rotations (..., N * size(rep)) -> (..., N * 9)."""
    if rep not in _REP_SIZE:
        raise ValueError(f"unknown rotation rep {rep!r}")
    rs = _REP_SIZE[rep]
    batch_shape = x.shape[:-1]
    n = x.shape[-1] // rs
    flat = x.reshape(-1, rs)
    if rep == "aa":
        R = aa_to_rotmat(flat)
    elif rep == "6d":
        R = rot6d_to_rotmat(flat)
    elif rep == "9d":
        R = rot9d_to_rotmat(flat)
    else:
        R = flat.reshape(-1, 3, 3)
    return R.reshape(*batch_shape, n * 9)


def rotmat_multiply(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product A @ B (..., 3, 3) as an explicit multiply-add
    (exact f32 whatever the matmul backend's settings)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def rotmat_apply(W: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """W (..., 3, 3) applied to point/vector sets pts (..., N, 3)."""
    return torch.sum(W[..., None, :, :] * pts[..., :, None, :], dim=-1)


def compute_aligned_from_right(body_right: torch.Tensor) -> torch.Tensor:
    """Rz(psi) taking the horizontal projection of `body_right` (..., 3)
    onto +x, in closed form: cos(psi) = bx/h, sin(psi) = by/h. Degenerate
    vertical headings (h ~ 0) return identity."""
    bx, by = body_right[..., 0:1], body_right[..., 1:2]
    h = torch.sqrt(torch.clamp(bx * bx + by * by, min=1e-12))
    degenerate = h < 1e-6
    c = torch.where(degenerate, torch.ones_like(bx), bx / (h + 1e-6))
    s = torch.where(degenerate, torch.zeros_like(by), by / (h + 1e-6))
    zero1 = torch.zeros_like(c)
    one1 = torch.ones_like(c)
    row0 = torch.stack([c, s, zero1], dim=-1)
    row1 = torch.stack([-s, c, zero1], dim=-1)
    row2 = torch.stack([zero1, zero1, one1], dim=-1)
    return torch.cat([row0, row1, row2], dim=-2)


def compute_world2aligned_mat(R: torch.Tensor) -> torch.Tensor:
    """World root orientations (..., 3, 3) -> heading-canonicalizing
    rotations (body-right = -R[:, :, 0])."""
    return compute_aligned_from_right(-R[..., :, 0])

