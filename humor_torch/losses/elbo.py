"""HuMoR training loss: weighted ELBO over typed state predictions (port
of humor_tpu/losses/elbo.py): per-component mean squared error, the
closed-form KL(q || p) with linear or cyclic annealing, the contact BCE
and its confusion stats, the contact-velocity term, and the SMPL joint,
mesh and consistency losses through the gendered body forward.

The ground-truth bodies of the SMPL terms run without a graph: only the
prediction is differentiated. The SMPL terms run in the span
"train.smpl_losses" (utils/profiling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from humor_torch.body_model import constants as C
from humor_torch.body_model.gendered import gendered_forward
from humor_torch.device import device_index
from humor_torch.ops import transforms
from humor_torch.utils import profiling as PR

CONTACT_THRESH = 0.5
SMPL_LOSS_DTYPES = {"": None, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class LossConfig:
    """Weights (0 disables a term); defaults follow
    configs/train_humor.cfg."""

    kl_loss: float = 0.0004
    kl_loss_anneal_start: int = 0
    kl_loss_anneal_end: int = 50
    kl_loss_cycle_len: int = -1

    regr_trans_loss: float = 1.0
    regr_trans_vel_loss: float = 1.0
    regr_root_orient_loss: float = 1.0
    regr_root_orient_vel_loss: float = 1.0
    regr_pose_loss: float = 1.0
    regr_pose_vel_loss: float = 1.0
    regr_joint_loss: float = 1.0
    regr_joint_vel_loss: float = 1.0
    regr_joint_orient_vel_loss: float = 1.0
    regr_vert_loss: float = 1.0
    regr_vert_vel_loss: float = 1.0

    contacts_loss: float = 0.01
    contacts_vel_loss: float = 0.01

    smpl_joint_loss: float = 1.0
    smpl_mesh_loss: float = 1.0
    smpl_joint_consistency_loss: float = 1.0
    smpl_vert_consistency_loss: float = 0.0

    # "bfloat16" runs the loss bodies' per-vertex skinning in bf16 (the
    # joints stay exact f32: smpl.lbs compute_dtype); "" = f32
    smpl_loss_dtype: str = ""

    def __post_init__(self):
        if self.smpl_loss_dtype not in SMPL_LOSS_DTYPES:
            raise ValueError(f"smpl_loss_dtype {self.smpl_loss_dtype!r} not "
                             f"in {tuple(SMPL_LOSS_DTYPES)}")

    @property
    def smpl_compute_dtype(self) -> Optional[torch.dtype]:
        return SMPL_LOSS_DTYPES[self.smpl_loss_dtype]

    @property
    def regr_weights(self) -> Dict[str, float]:
        return {
            "trans": self.regr_trans_loss,
            "trans_vel": self.regr_trans_vel_loss,
            "root_orient": self.regr_root_orient_loss,
            "root_orient_vel": self.regr_root_orient_vel_loss,
            "pose_body": self.regr_pose_loss,
            "pose_body_vel": self.regr_pose_vel_loss,
            "joints": self.regr_joint_loss,
            "joints_vel": self.regr_joint_vel_loss,
            "joints_orient_vel": self.regr_joint_orient_vel_loss,
            "verts": self.regr_vert_loss,
            "verts_vel": self.regr_vert_vel_loss,
        }

    @property
    def use_smpl_losses(self) -> bool:
        return (self.smpl_joint_loss + self.smpl_mesh_loss
                + self.smpl_joint_consistency_loss
                + self.smpl_vert_consistency_loss) > 0.0


def kl_normal(qm, qv, pm, pv):
    """KL(q || p) between diagonal Gaussians, summed over the last dim."""
    el = 0.5 * (torch.log(pv) - torch.log(qv) + qv / pv
                + torch.square(qm - pm) / pv - 1.0)
    return torch.sum(el, dim=-1)


def log_normal(x, m, v):
    """Diagonal-Gaussian log density summed over the last dim."""
    lp = (-0.5 * math.log(2.0 * math.pi) - 0.5 * torch.log(v)
          - torch.square(x - m) / (2.0 * v))
    return torch.sum(lp, dim=-1)


def kl_anneal_weight(cfg: LossConfig, epoch, device="cpu") -> torch.Tensor:
    """Linear or cyclic KL annealing weight in [0, 1] (float32). `epoch`
    is a number or a float32 0-d tensor on `device` (a CUDA-graphed step
    reads the epoch from the device, train/step.make_multi_steps)."""
    e = (epoch if torch.is_tensor(epoch) else
         torch.tensor(float(epoch), dtype=torch.float32, device=device))
    if cfg.kl_loss_cycle_len > 0:
        e = torch.remainder(e, cfg.kl_loss_cycle_len)
        start, end = 0.0, cfg.kl_loss_cycle_len / 2.0
    elif cfg.kl_loss_anneal_end > cfg.kl_loss_anneal_start:
        start = float(cfg.kl_loss_anneal_start)
        end = float(cfg.kl_loss_anneal_end)
    else:
        return torch.ones((), dtype=torch.float32, device=device)
    w = (e - start) / (end - start)
    return torch.clamp(torch.where(e >= start, w, torch.zeros_like(w)),
                       0.0, 1.0)


def elbo_loss(cfg: LossConfig,
              pred: Dict[str, torch.Tensor],   # typed (N, D), mat rotations
              posterior: Tuple[torch.Tensor, torch.Tensor],
              prior: Tuple[torch.Tensor, torch.Tensor],
              gt: Dict[str, torch.Tensor],     # typed (N, D), mat rotations
              epoch,
              gender_ids: Optional[torch.Tensor] = None,  # (N,)
              betas: Optional[torch.Tensor] = None,       # (N, 16)
              smpl_models: Optional[Dict] = None,  # {"male", "female"}
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss and a dict of 0-d stats over step-flattened
    rows (N = B*T). Every loss term is a mean over the N rows: the
    data-parallel steps (train/step.py) average the ranks' losses and
    gradients over equal shards, which is the global mean only so."""
    dev = pred["trans"].device
    stats: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    kl_weighted = None
    if cfg.kl_loss > 0.0:
        kl = kl_normal(posterior[0], posterior[1], prior[0], prior[1]).mean()
        aw = kl_anneal_weight(cfg, epoch, dev)
        kl_weighted = aw * cfg.kl_loss * kl
        loss = loss + kl_weighted
        stats["kl_loss"] = kl
        stats["kl_anneal_weight"] = aw
        stats["kl_weighted_loss"] = kl_weighted

    for name, w in cfg.regr_weights.items():
        if w > 0.0 and name in gt and name in pred:
            term = torch.mean(torch.square(pred[name] - gt[name]))
            stats[f"{name}_loss"] = term
            loss = loss + w * term

    if cfg.contacts_loss > 0.0 and "contacts" in pred and "contacts" in gt:
        logits, labels = pred["contacts"], gt["contacts"]
        # the stable form of BCE with logits
        bce = torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                         + torch.log1p(torch.exp(-torch.abs(logits))))
        stats["contacts_loss"] = bce
        loss = loss + cfg.contacts_loss * bce
        with torch.no_grad():
            p = torch.sigmoid(logits) > CONTACT_THRESH
            g = labels > 0.5
            tp = torch.sum(p & g).float()
            fp = torch.sum(p & ~g).float()
            fn = torch.sum(~p & g).float()
            tn = torch.sum(~p & ~g).float()
            stats["contacts_acc"] = (tp + tn) / (tp + fp + fn + tn)
            stats["contacts_pos_acc"] = tp / torch.clamp(tp + fn, min=1.0)
            stats["contacts_neg_acc"] = tn / torch.clamp(tn + fp, min=1.0)

    if (cfg.contacts_vel_loss > 0.0 and "contacts" in pred
            and "joints_vel" in pred):
        probs = torch.sigmoid(pred["contacts"])                 # (N, 9)
        jv = pred["joints_vel"].reshape(-1, C.NUM_SMPL_JOINTS, 3)
        cv = jv[:, device_index(C.CONTACT_INDS, jv.device)]
        term = torch.mean(probs * torch.sum(cv * cv, dim=-1))
        stats["contacts_vel_loss"] = term
        loss = loss + cfg.contacts_vel_loss * term

    if cfg.use_smpl_losses and smpl_models is not None:
        with PR.span("train.smpl_losses"):
            if gender_ids is None or betas is None:
                raise ValueError("SMPL losses require gender_ids and betas")
            N = pred["trans"].shape[0]
            nb = C.NUM_BODY_JOINTS
            p_orient = transforms.rotmat_to_aa(
                pred["root_orient"].reshape(N, 3, 3))
            p_pose = transforms.rotmat_to_aa(
                pred["pose_body"].reshape(N, nb, 3, 3)).reshape(N, -1)
            cd = cfg.smpl_compute_dtype
            pred_body = gendered_forward(smpl_models, gender_ids, p_orient,
                                         p_pose, betas, pred["trans"],
                                         compute_dtype=cd)
            with torch.no_grad():
                g_orient = transforms.rotmat_to_aa(
                    gt["root_orient"].reshape(N, 3, 3))
                g_pose = transforms.rotmat_to_aa(
                    gt["pose_body"].reshape(N, nb, 3, 3)).reshape(N, -1)
                gt_body = gendered_forward(smpl_models, gender_ids, g_orient,
                                           g_pose, betas, gt["trans"],
                                           compute_dtype=cd)
            pj = pred_body.Jtr[:, :C.NUM_SMPL_JOINTS]
            gj = gt_body.Jtr[:, :C.NUM_SMPL_JOINTS]
            if cfg.smpl_joint_loss > 0.0:
                term = torch.mean(torch.square(pj - gj))
                stats["smpl_joint_loss"] = term
                loss = loss + cfg.smpl_joint_loss * term
            if cfg.smpl_mesh_loss > 0.0:
                term = torch.mean(torch.square(pred_body.v - gt_body.v))
                stats["smpl_mesh_loss"] = term
                loss = loss + cfg.smpl_mesh_loss * term
            if cfg.smpl_joint_consistency_loss > 0.0 and "joints" in pred:
                rj = pred["joints"].reshape(N, C.NUM_SMPL_JOINTS, 3)
                term = torch.mean(torch.square(pj - rj))
                stats["smpl_joint_consistency_loss"] = term
                loss = loss + cfg.smpl_joint_consistency_loss * term
            if cfg.smpl_vert_consistency_loss > 0.0 and "verts" in pred:
                kv = pred_body.v[:, device_index(C.KEYPT_VERTS,
                                                 pred_body.v.device)]
                rv = pred["verts"].reshape(N, C.NUM_KEYPT_VERTS, 3)
                term = torch.mean(torch.square(kv - rv))
                stats["smpl_vert_consistency_loss"] = term
                loss = loss + cfg.smpl_vert_consistency_loss * term

    if kl_weighted is not None:
        stats["reconstr_weighted_loss"] = loss - kl_weighted
    return loss, stats
