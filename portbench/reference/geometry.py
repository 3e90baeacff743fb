"""Frozen copy of humor_torch/fitting/geometry.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

Camera and floor-plane geometry of the test-time fit (port of
humor_tpu/fitting/geometry.py).

The camera frame has -y up (OpenCV-style); the prior (canonical) frame
has +z up. The floor plane is optimized as the 3-vector n*d (normal
scaled by offset) and parsed to (a, b, c, d) with the normal flipped to
face up in the camera frame. The 1e-12 / 1e-9 guards and the `where`
branches are the JAX module's, so values and gradients agree.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from portbench.reference import transforms


def bdot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False
         ) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def compute_plane_intersection(point: torch.Tensor, direction: torch.Tensor,
                               plane: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray/plane intersection. point, direction (..., 3); plane (..., 4)
    as (unit normal, offset). Returns (intersection (..., 3), s) with
    point + s * direction = intersection; s < 0 means the ray meets the
    plane in the -direction."""
    normal, off = plane[..., :3], plane[..., 3]
    denom = bdot(normal, direction)
    safe = torch.where(torch.abs(denom) < 1e-12,
                       torch.sign(denom) * 1e-12 + 1e-12, denom)
    s = (off - bdot(normal, point)) / safe
    return point + s[..., None] * direction, s


def parse_floor_plane(floor_plane: torch.Tensor) -> torch.Tensor:
    """Optimization form (..., 3) = normal * offset -> (..., 4) = (unit
    normal, offset), the normal's camera-frame y made non-positive."""
    off = torch.clamp(torch.linalg.vector_norm(floor_plane, dim=-1,
                                               keepdim=True), min=1e-12)
    normal = floor_plane / off
    neg = normal[..., 1:2] > 0.0
    normal = torch.where(neg, -normal, normal)
    off = torch.where(neg, -off, off)
    return torch.cat([normal, off], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def compute_cam2prior(floor_plane: torch.Tensor, trans: torch.Tensor,
                      root_orient_aa: torch.Tensor, joints: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rigid transform from the camera frame to the canonical prior frame
    (z up, heading-aligned at the key frame). floor_plane (B, 3) in
    optimization form; trans (B, 3); root_orient_aa (B, 3); joints
    (B, J, 3). Returns (R (B, 3, 3), t (B, 3), root height (B, 1))."""
    plane4 = parse_floor_plane(floor_plane)
    normal = plane4[..., :3]
    floor_trans, _ = compute_plane_intersection(trans, -normal, plane4)
    up_axis = normal
    body_right = -transforms.aa_to_rotmat(root_orient_aa)[..., :, 0]
    floor_body_right, s = compute_plane_intersection(trans, body_right,
                                                     plane4)
    right_axis = floor_body_right - floor_trans
    right_axis = _unit(torch.where(s[..., None] < 0, -right_axis,
                                   right_axis))
    fwd_axis = _unit(torch.linalg.cross(up_axis, right_axis, dim=-1))
    prior_R = torch.stack([right_axis, fwd_axis, up_axis], dim=-1)
    _, s_root = compute_plane_intersection(joints[..., 0, :], -normal,
                                           plane4)
    return prior_R.transpose(-1, -2), -trans, s_root[..., None]


def _take_key(x: torch.Tensor, key_frame_idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, ...) at each window's key frame -> (B, 1, ...)."""
    if x.shape[1] == 1:
        return x[:, 0:1]
    idx = key_frame_idx.long().reshape(-1, 1, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(-1, 1, *x.shape[2:]))


def apply_cam2prior(
    trans: torch.Tensor,            # (B, T, 3)
    root_orient_aa: torch.Tensor,   # (B, T, 3)
    R: torch.Tensor,                # (B, 3, 3)
    t: torch.Tensor,                # (B, 3)
    root_height: torch.Tensor,      # (B, 1)
    key_frame_idx: torch.Tensor,    # (B,) int
    smpl_root_joint_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]] = None,
    inverse: bool = False,
) -> Dict[str, torch.Tensor]:
    """Move (trans, root_orient) between the camera and prior frames.

    Forward: rotate orientations by R; shift the translation by t, rotate,
    then offset z so that the key frame's SMPL root joint sits at
    `root_height` (`smpl_root_joint_fn(trans, root_orient_aa) -> root z
    (B, T)` supplies the body). Inverse: the exact reverse composition."""
    R_mat = transforms.aa_to_rotmat(root_orient_aa)
    if inverse:
        out_mat = torch.einsum("bji,btjk->btik", R, R_mat)
    else:
        out_mat = torch.einsum("bij,btjk->btik", R, R_mat)
    out_orient = transforms.rotmat_to_aa(out_mat)
    if inverse:
        shifted = trans - _take_key(trans, key_frame_idx)
        out_trans = torch.einsum("bji,btj->bti", R, shifted) - t[:, None]
    else:
        rot = torch.einsum("bij,btj->bti", R, trans + t[:, None])
        if smpl_root_joint_fn is not None:
            root_z = smpl_root_joint_fn(rot, out_orient)       # (B, T)
            cur_h = _take_key(root_z, key_frame_idx)           # (B, 1)
            diff = root_height - cur_h
            rot = rot + torch.cat([torch.zeros_like(rot[:, 0, :2]), diff],
                                  dim=-1)[:, None]
        out_trans = rot
    return {"trans": out_trans, "root_orient": out_orient}


def perspective_projection(points: torch.Tensor,       # (B, N, 3)
                           rotation: torch.Tensor,     # (B, 3, 3)
                           translation: torch.Tensor,  # (B, 3)
                           focal_length: torch.Tensor, # (B, 2)
                           camera_center: torch.Tensor # (B, 2)
                           ) -> torch.Tensor:
    """Pinhole projection -> pixel coordinates (B, N, 2)."""
    pts = torch.einsum("bij,bnj->bni", rotation, points) \
        + translation[:, None]
    z = pts[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return pts[..., :2] / z * focal_length[:, None] + camera_center[:, None]
