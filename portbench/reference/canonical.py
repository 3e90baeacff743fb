"""Frozen copy of humor_torch/models/canonical.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

Rigid change of frame for typed motion states: heading
canonicalization and its inverse (port of humor_tpu/models/canonical.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch

from portbench.reference import state as state_lib
from portbench.reference.state import Kind
from portbench.reference import transforms


class FrameTransform(NamedTuple):
    """world->local transform: rot (..., 3, 3) heading rotation W, trans
    (..., 3) pre-rotation translation (z = 0), trans2joint (..., 3) xy
    offset from the root translation to the root joint (z = 0)."""

    rot: torch.Tensor
    trans: torch.Tensor
    trans2joint: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device="cpu") -> "FrameTransform":
        rot = torch.eye(3, dtype=dtype, device=device).expand(
            *batch_shape, 3, 3)
        z3 = torch.zeros(*batch_shape, 3, dtype=dtype, device=device)
        return FrameTransform(rot, z3, z3)


def _rotate_vecs(rot: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    batch_shape = flat.shape[:-1]
    pts = flat.reshape(*batch_shape, -1, 3)
    return transforms.rotmat_apply(rot, pts).reshape(*batch_shape, -1)


def apply_world2local(xform: FrameTransform,
                      state: Mapping[str, torch.Tensor],
                      invert: bool = False) -> Dict[str, torch.Tensor]:
    """Move every component of `state` (matrix rotations) into the local
    frame, or back with `invert`:
        rotations R' = W R; trans t' = W (t + trans);
        points p' = W (p + trans + t2j) - t2j; vectors v' = W v."""
    W = xform.rot
    Winv = W.transpose(-1, -2)
    out: Dict[str, torch.Tensor] = {}
    for name, val in state.items():
        comp = state_lib.component(name) if state_lib.is_component(name) \
            else None
        if comp is None or comp.kind == Kind.LOCAL:
            out[name] = val
        elif comp.kind == Kind.ROTATION:
            batch_shape = val.shape[:-1]
            R = val.reshape(*batch_shape, -1, 3, 3)
            M = Winv if invert else W
            out[name] = transforms.rotmat_multiply(
                M[..., None, :, :], R).reshape(*batch_shape, -1)
        elif comp.kind == Kind.POINT:
            if invert:
                out[name] = _rotate_vecs(Winv, val) - xform.trans
            else:
                out[name] = _rotate_vecs(W, val + xform.trans)
        elif comp.kind == Kind.OFFSET_POINT:
            batch_shape = val.shape[:-1]
            pts = val.reshape(*batch_shape, -1, 3)
            t2j = xform.trans2joint[..., None, :]
            if invert:
                rp = transforms.rotmat_apply(Winv, pts + t2j)
                rp = rp - t2j - xform.trans[..., None, :]
            else:
                shifted = pts + xform.trans[..., None, :] + t2j
                rp = transforms.rotmat_apply(W, shifted) - t2j
            out[name] = rp.reshape(*batch_shape, -1)
        elif comp.kind == Kind.VECTOR:
            out[name] = _rotate_vecs(Winv if invert else W, val)
        else:  # pragma: no cover
            raise ValueError(f"unhandled kind {comp.kind}")
    return out


def frame_from_state(state: Mapping[str, torch.Tensor],
                     trans2joint: Optional[torch.Tensor] = None
                     ) -> FrameTransform:
    """Canonicalizing transform of a world-frame state (matrix rots):
    heading from root_orient, trans = [-x, -y, 0], trans2joint from the
    state's root joint unless given."""
    tr = state["trans"]
    batch_shape = tr.shape[:-1]
    R = state["root_orient"].reshape(*batch_shape, 3, 3)
    rot = transforms.compute_world2aligned_mat(R)
    zeros1 = torch.zeros(*batch_shape, 1, dtype=tr.dtype, device=tr.device)
    trans = torch.cat([-tr[..., :2], zeros1], dim=-1)
    if trans2joint is None:
        if "joints" in state:
            root_xy = state["joints"][..., :2] + trans[..., :2]
            trans2joint = torch.cat([-root_xy, zeros1], dim=-1)
        else:
            trans2joint = torch.zeros(*batch_shape, 3, dtype=tr.dtype,
                                      device=tr.device)
    return FrameTransform(rot, trans, trans2joint)
