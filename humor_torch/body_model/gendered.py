"""Mixed-gender batched SMPL forward (port of
humor_tpu/body_model/gendered.py).

Each gender's body runs over the whole batch and a `where` picks each
sample's gender: static shapes, and the gradient of every sample flows
through its own gender's forward only, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from humor_torch.body_model import constants as C
from humor_torch.body_model.smpl import SmplModel, SmplOutput, forward
from humor_torch.ops import transforms

def gendered_forward(models: Dict[str, SmplModel],
                     gender_ids: torch.Tensor,   # (B,) ints indexing `order`
                     root_orient: torch.Tensor, pose_body: torch.Tensor,
                     betas: torch.Tensor, trans: torch.Tensor,
                     pose_hand: Optional[torch.Tensor] = None,
                     order: Tuple[str, ...] = ("male", "female"),
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> SmplOutput:
    """SMPL for a batch with per-sample gender: only the genders in
    `order` are evaluated (training uses male and female).
    compute_dtype: see smpl.lbs (the loss bodies' bf16 per-vertex
    pipeline; the joints stay exact f32)."""
    v = j = None
    for gid, name in enumerate(order):
        out = forward(models[name], root_orient, pose_body, betas, trans,
                      pose_hand, compute_dtype=compute_dtype)
        sel = (gender_ids == gid)[:, None, None]
        v = out.v if v is None else torch.where(sel, out.v, v)
        j = out.Jtr if j is None else torch.where(sel, out.Jtr, j)
    return SmplOutput(v=v, Jtr=j)


def make_rollout_joint_fn(models: Dict[str, SmplModel],
                          gender_ids: torch.Tensor, betas: torch.Tensor,
                          order: Tuple[str, ...] = ("male", "female")):
    """HuMoR-Qual joint feedback for models.humor.scheduled_sampling:
    (trans (B, 3), root_orient_mat (B, 9), pose_body_mat (B, 21*9)) ->
    the gendered SMPL forward's flat (B, 22*3) joints."""

    def joint_fn(trans, root_orient_mat, pose_body_mat):
        B = trans.shape[0]
        root_aa = transforms.rotmat_to_aa(root_orient_mat.reshape(B, 3, 3))
        pose_aa = transforms.rotmat_to_aa(
            pose_body_mat.reshape(B, -1, 3, 3)).reshape(B, -1)
        out = gendered_forward(models, gender_ids, root_aa, pose_aa, betas,
                               trans, order=order)
        return out.Jtr[:, :C.NUM_SMPL_JOINTS].reshape(B, -1)

    return joint_fn
