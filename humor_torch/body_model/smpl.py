"""SMPL-family body model with a linear-blend-skinning forward in PyTorch
(port of humor_tpu/body_model/smpl.py).

    v_shaped = v_template + shapedirs . betas
    J_rest   = J_regressor @ v_shaped
    v_posed  = v_shaped + posedirs . vec(R_{1:} - I)
    A_j      = A_parent(j) . [R_j | J_j - J_parent(j)]
    v_world  = sum_j w_vj A'_j v_posed + trans
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from humor_torch.body_model import constants as C
from humor_torch.ops import transforms


@dataclass(frozen=True)
class SmplModel:
    """One SMPL-family body. Tensors live on one device; the skeleton
    (parents, faces, OpenPose vertex-joint ids) is numpy metadata."""

    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    posedirs: torch.Tensor      # (9*(J-1), V*3)
    j_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    parents: np.ndarray
    faces: np.ndarray
    vtx_joint_ids: np.ndarray

    @property
    def num_joints(self) -> int:
        return int(self.j_regressor.shape[0])

    @property
    def num_verts(self) -> int:
        return int(self.v_template.shape[0])

    @property
    def num_betas(self) -> int:
        return int(self.shapedirs.shape[-1])

    def to(self, device) -> "SmplModel":
        return replace(self, **{k: getattr(self, k).to(device) for k in (
            "v_template", "shapedirs", "posedirs", "j_regressor",
            "lbs_weights")})


class SmplOutput(NamedTuple):
    v: torch.Tensor    # (B, V, 3) posed vertices
    Jtr: torch.Tensor  # (B, J[+K], 3) posed joints (+ vertex joints)


SMPLH_VERTEX_IDS = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
    "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
    "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
}
_VTX_ORDER = ["nose", "reye", "leye", "rear", "lear", "LBigToe", "LSmallToe",
              "LHeel", "RBigToe", "RSmallToe", "RHeel"]


def _model(v_template, shapedirs, posedirs, j_regressor, weights, parents,
           faces, vtx_ids, device) -> SmplModel:
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SmplModel(v_template=t(v_template), shapedirs=t(shapedirs),
                     posedirs=t(posedirs), j_regressor=t(j_regressor),
                     lbs_weights=t(weights),
                     parents=np.asarray(parents, np.int32),
                     faces=np.asarray(faces, np.int32),
                     vtx_joint_ids=np.asarray(vtx_ids, np.int32))


def find_model_path(base: str, gender: str) -> str:
    """<base>/<gender>/model.npz, the AMASS SMPL+H layout."""
    return os.path.join(base, gender, "model.npz")


def load_smpl_npz(path: str, num_betas: int = C.BETA_SIZE,
                  use_vtx_selector: bool = False,
                  device="cpu") -> SmplModel:
    """Load an AMASS-style SMPL/SMPL+H `model.npz`; shapedirs are padded
    with zeros to `num_betas`."""
    raw = np.load(path, encoding="latin1", allow_pickle=True)
    v_template = np.asarray(raw["v_template"], np.float32)
    shapedirs = np.asarray(raw["shapedirs"], np.float32)
    if shapedirs.shape[-1] < num_betas:
        pad = num_betas - shapedirs.shape[-1]
        shapedirs = np.concatenate(
            [shapedirs, np.zeros((*shapedirs.shape[:-1], pad), np.float32)],
            axis=-1)
    shapedirs = shapedirs[..., :num_betas]
    V = v_template.shape[0]
    posedirs = np.asarray(raw["posedirs"], np.float32).reshape(V * 3, -1).T
    j_regressor = np.asarray(raw["J_regressor"], np.float32)
    if j_regressor.ndim != 2:
        j_regressor = np.asarray(j_regressor.item().todense(), np.float32)
    parents = np.asarray(raw["kintree_table"], np.int64)[0]
    parents[0] = -1
    vtx_ids = (np.asarray([SMPLH_VERTEX_IDS[k] for k in _VTX_ORDER])
               if use_vtx_selector else np.zeros((0,)))
    return _model(v_template, shapedirs, posedirs, j_regressor,
                  raw["weights"], parents, raw["f"], vtx_ids, device)


def synthetic_smpl_model(seed: int = 1234, num_verts: int = 256,
                         num_joints: int = 22, num_betas: int = C.BETA_SIZE,
                         device="cpu") -> SmplModel:
    """Procedural body from a numpy seed (the licensed SMPL assets cannot
    ship): skeleton from the SMPL parent tree, vertices around the bones,
    smooth skinning weights. The same numpy stream as the JAX package's
    synthetic_smpl_model, so seed 1234 gives its default body."""
    rng = np.random.RandomState(seed)
    parents = np.asarray(C.SMPL_PARENTS[:num_joints], np.int32).copy()
    rest_j = np.zeros((num_joints, 3), np.float32)
    rest_j[0] = [0.0, 0.0, 0.9]
    for j in range(1, num_joints):
        off = rng.randn(3).astype(np.float32) * 0.12
        rest_j[j] = rest_j[parents[j]] + off
    host = rng.randint(0, num_joints, size=num_verts)
    v_template = rest_j[host] + rng.randn(num_verts, 3).astype(np.float32) * 0.08
    d = np.linalg.norm(v_template[None, :, :] - rest_j[:, None, :], axis=-1)
    j_reg = np.exp(-d / 0.05)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    w = np.exp(-d.T / 0.08)
    w /= w.sum(axis=1, keepdims=True)
    shapedirs = rng.randn(num_verts, 3, num_betas).astype(np.float32) * 0.01
    posedirs = rng.randn(9 * (num_joints - 1),
                         num_verts * 3).astype(np.float32) * 0.001
    faces = rng.randint(0, num_verts, size=(2 * num_verts, 3))
    return _model(v_template, shapedirs, posedirs, j_reg, w, parents, faces,
                  np.zeros((0,)), device)


def _rigid_transform_chain(rot_mats: torch.Tensor, rest_joints: torch.Tensor,
                           parents: np.ndarray):
    """Compose per-joint world transforms down the kinematic tree.
    Returns (posed joints (B, J, 3), world rotations (B, J, 3, 3),
    skinning translations t - R @ rest_joint (B, J, 3))."""
    J = rot_mats.shape[1]
    rel = torch.cat([rest_joints[:, :1], rest_joints[:, 1:]
                     - rest_joints[:, np.asarray(parents[1:])]], dim=1)
    world_rots = [rot_mats[:, 0]]
    world_pos = [rest_joints[:, 0]]
    for j in range(1, J):
        p = int(parents[j])
        world_rots.append(torch.matmul(world_rots[p], rot_mats[:, j]))
        world_pos.append(torch.einsum("bij,bj->bi", world_rots[p], rel[:, j])
                         + world_pos[p])
    Rw = torch.stack(world_rots, dim=1)
    tw = torch.stack(world_pos, dim=1)
    t_rel = tw - torch.einsum("bjik,bjk->bji", Rw, rest_joints)
    return tw, Rw, t_rel


def lbs(model: SmplModel, betas: torch.Tensor, rot_mats: torch.Tensor,
        trans: torch.Tensor, vert_ids: Optional[np.ndarray] = None,
        compute_dtype: Optional[torch.dtype] = None) -> SmplOutput:
    """Skinning forward from per-joint rotations (B, J, 3, 3).

    vert_ids: skin only these vertices (None = all). Joints always come
    from the full shaped template; the vertex joints (vtx_joint_ids) are
    appended to the selection so Jtr keeps its layout.

    compute_dtype (torch.bfloat16): the per-vertex pipeline (pose
    blendshapes and skinning) runs in that type with bf16 products and
    sums, at the JAX package's cast points, and the vertices come back in
    f32 before `trans` is added; the shape blendshapes, the rest joints
    and the kinematic chain stay f32, so the joints equal the f32 call's.
    For the training loss bodies only: the vertices move by about one
    bf16 step of their size (up to ~2e-2 m at 2,000 x 6,890)."""
    v_shaped = model.v_template + torch.einsum("bl,vcl->bvc", betas,
                                               model.shapedirs)
    rest_joints = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    B = betas.shape[0]
    n_extra = int(model.vtx_joint_ids.size)
    if vert_ids is not None:
        sel = np.concatenate([np.asarray(vert_ids, np.int64).reshape(-1),
                              model.vtx_joint_ids.astype(np.int64)])
        sel_t = torch.as_tensor(sel, device=betas.device)
        v_shaped_s = v_shaped[:, sel_t]
        weights_s = model.lbs_weights[sel_t]
        P, V = model.posedirs.shape[0], model.num_verts
        posedirs_s = model.posedirs.reshape(P, V, 3)[:, sel_t].reshape(P, -1)
        extra_start = len(sel) - n_extra
    else:
        v_shaped_s, weights_s, posedirs_s = (v_shaped, model.lbs_weights,
                                             model.posedirs)
        extra_start = None

    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feat = (rot_mats[:, 1:] - eye).reshape(B, -1)
    posed_joints, Rw, t_rel = _rigid_transform_chain(rot_mats, rest_joints,
                                                     model.parents)
    if compute_dtype is not None:
        cd = compute_dtype
        pose_feat, posedirs_s, v_shaped_s = (
            pose_feat.to(cd), posedirs_s.to(cd), v_shaped_s.to(cd))
        weights_s, Rw, t_rel = weights_s.to(cd), Rw.to(cd), t_rel.to(cd)
    v_posed = v_shaped_s + torch.matmul(pose_feat, posedirs_s).reshape(
        B, -1, 3)
    R_v = torch.einsum("vj,bjik->bvik", weights_s, Rw)
    t_v = torch.einsum("vj,bji->bvi", weights_s, t_rel)
    v_out = torch.einsum("bvik,bvk->bvi", R_v, v_posed) + t_v
    v_out = v_out.to(betas.dtype) + trans[:, None, :]
    joints_out = posed_joints + trans[:, None, :]
    if n_extra > 0:
        if extra_start is not None:
            extra = v_out[:, extra_start:]
            v_out = v_out[:, :extra_start]
        else:
            extra = v_out[:, torch.as_tensor(model.vtx_joint_ids.astype(
                np.int64), device=v_out.device)]
        joints_out = torch.cat([joints_out, extra], dim=1)
    return SmplOutput(v=v_out, Jtr=joints_out)


def rest_root_joint(model: SmplModel, betas: torch.Tensor) -> torch.Tensor:
    """Shaped rest-pose root joint j0 (B, 3), a function of betas only."""
    v_shaped = model.v_template + torch.einsum("bl,vcl->bvc", betas,
                                               model.shapedirs)
    return torch.einsum("v,bvc->bc", model.j_regressor[0], v_shaped)


def forward(model: SmplModel, root_orient: torch.Tensor,
            pose_body: torch.Tensor, betas: torch.Tensor,
            trans: torch.Tensor, pose_hand: Optional[torch.Tensor] = None,
            vert_ids: Optional[np.ndarray] = None,
            compute_dtype: Optional[torch.dtype] = None) -> SmplOutput:
    """root_orient (B, 3) aa or (B, 3, 3); pose_body (B, 63) aa or
    (B, 21, 3, 3); hands flat unless pose_hand (B, 90) aa is given;
    compute_dtype: see `lbs` (the loss bodies' bf16 per-vertex
    pipeline)."""
    B = betas.shape[0]
    J = model.num_joints
    n_body = min(C.NUM_BODY_JOINTS, J - 1)
    if root_orient.dim() == 2:
        root_mat = transforms.aa_to_rotmat(root_orient)[:, None]
    else:
        root_mat = root_orient.reshape(B, 1, 3, 3)
    if pose_body.dim() == 2:
        body_mat = transforms.aa_to_rotmat(pose_body.reshape(B, n_body, 3))
    else:
        body_mat = pose_body.reshape(B, n_body, 3, 3)
    mats = [root_mat, body_mat]
    n_rest = J - 1 - n_body
    if n_rest > 0:
        if pose_hand is not None:
            mats.append(transforms.aa_to_rotmat(
                pose_hand.reshape(B, n_rest, 3)))
        else:
            mats.append(torch.eye(3, dtype=betas.dtype,
                                  device=betas.device).expand(B, n_rest, 3, 3))
    return lbs(model, betas, torch.cat(mats, dim=1), trans,
               vert_ids=vert_ids, compute_dtype=compute_dtype)
