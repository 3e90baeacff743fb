"""3-stage test-time motion optimizer (port of
humor_tpu/fitting/optimizer.py): the joints3d and keypoint-vertex fits,
the RGB video fit (2D keypoints, floor plane, overlapping windows) and
the PROX RGB-D fit (point cloud, 2D keypoints, floor plane).

Fits SMPL shape and motion to the observations by optimizing in VPoser's
pose latent space (stages 1-2) and HuMoR's motion latent space (stage 3):

  * init: a point cloud puts each frame's translation at its centroid;
    2D keypoints without one put the depth where the mean bone length of
    the rest body, seen at the focal length, matches the 2D one at the
    best-visible frame;
  * stage 1: root translation/orientation only. Pose and shape are
    frozen, so the body is skinned once and each evaluation applies the
    SMPL root identity p = R (base - j0) + j0 + trans to every skinned
    point (joints, keypoint vertices, the whole mesh for a point cloud);
  * stage 2: all per-frame variables, with pose/shape priors and joint
    smoothness; the floor plane stays frozen;
  * stage 3: the initial state, the latent motion and the floor plane;
    every evaluation rolls the frozen HuMoR CVAE out over the window
    through the fused rollout kernels (ops/rollout_kernel.py; a HuMoR
    configuration other than the default rolls out through the typed
    models.humor.rollout, as the kernels cover the default only), in three
    sub-phases (tune the initial state on the first frames without the
    overlap terms, freeze it, refine all). With `optim_floor` the rollout
    runs in the prior frame that the floor and the first frame define
    (cam2prior), and the camera-frame prediction is an exact rigid map of
    the prior-frame one.

A video's windows ("seq_interval", (B, 2) frame intervals) are fitted
together: the overlap-consistency terms tie each window's keypoint
vertices, shape and floor to its neighbour's, and to the previous
batch's last window ("prev_batch_overlap_res"). A point-cloud
observation ("points3d") makes every evaluation skin the whole mesh and
search nearest neighbours (ops/chamfer.py, a CUDA kernel on the card).
Each L-BFGS line search evaluates its K candidate steps as one batch of
K*B windows (see fitting/lbfgs.py); the rollout kernel then sees M = K*B
rows. The per-window observations are tiled to K*B rows; seq_interval
and the previous batch's result are not, and the overlap terms
(fitting/energies.py) reshape their rows to (K, B); the zoom search
evaluates one candidate at a time (M = B rows).

With a `mesh` (parallel/mesh.py) the windows are split over ranks, as the
JAX package shards them over its "dp" mesh: each rank fits its B/W
consecutive windows, the L-BFGS reductions run over ranks
(fitting/lbfgs.py), the overlap terms exchange the windows at the ranks'
edges (fitting/energies.py), and `run` returns the whole batch's result
on every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from humor_torch.body_model import constants as C
from humor_torch.body_model import smpl as smpl_lib
from humor_torch.device import device_index, resolve_device
from humor_torch.fitting import energies as E
from humor_torch.fitting import geometry as geo
from humor_torch.fitting.lbfgs import make_mask, run_lbfgs
from humor_torch.models import gmm as gmm_lib
from humor_torch.models import humor as H
from humor_torch.models import vposer as vp
from humor_torch.ops import rollout_kernel as RK
from humor_torch.ops import transforms
from humor_torch.parallel import mesh as P
from humor_torch.utils import profiling as PR

CONTACT_THRESH = 0.5


@dataclass(frozen=True)
class TTOConfig:
    seq_len: int
    num_betas: int = C.BETA_SIZE
    stage_weights: Tuple[E.StageWeights, E.StageWeights, E.StageWeights] = (
        E.StageWeights(joints3d=1.0),
        E.StageWeights(joints3d=1.0, pose_prior=4e-4, shape_prior=6e-3,
                       joints3d_smooth=1.0),
        E.StageWeights(joints3d=1.0, pose_prior=4e-4, shape_prior=6e-3,
                       motion_prior=7.5e-4, init_motion_prior=7.5e-4,
                       joint_consistency=100.0, bone_length=2000.0),
    )
    energy: E.EnergyConfig = E.EnergyConfig()
    num_iters: Tuple[int, int, int] = (30, 70, 70)
    lbfgs_max_linesearch: int = 20  # zoom search only (probe budget)
    lbfgs_history: int = 10
    # "auto": "parallel" below 12 windows, "armijo" from 12; or one name
    # for all stages, or a 3-tuple per stage: "parallel", "armijo",
    # "zoom" (sequential strong-Wolfe, one K=1 evaluation a probe) or
    # "hybrid" (parallel, then a zoom polish of lbfgs_polish_frac of the
    # stage's iterations)
    lbfgs_linesearch: Any = "auto"
    lbfgs_polish_frac: float = 0.08
    # line-search grid size; None/0 = clamp(128 // B, 4, 16)
    lbfgs_candidates: Optional[int] = 8
    # convergence early exit (fitting/lbfgs.run_lbfgs); None = the fixed
    # iteration count
    lbfgs_tol_grad: Optional[float] = None
    lbfgs_tol_change: Optional[float] = None
    lbfgs_stall_patience: int = 3
    data_fps: float = 30.0
    optim_floor: bool = False
    stage3_tune_init_state: bool = True
    stage3_tune_init_num_frames: int = 15
    stage3_freeze_start: int = 30
    stage3_freeze_end: int = 55
    stage3_contact_refine_only: bool = False


class TTOModels(NamedTuple):
    """Frozen model parameters the optimizer closes over."""
    body: smpl_lib.SmplModel
    vposer_cfg: vp.VPoserConfig
    vposer: Dict
    humor_cfg: H.HumorConfig
    humor: Dict
    init_gmm: Optional[gmm_lib.GmmParams] = None


class TTOResult(NamedTuple):
    final: Dict[str, torch.Tensor]
    per_stage: Dict[str, Dict]
    losses: Dict[str, torch.Tensor]


def resolve_candidates(num: Optional[int], batch: int) -> int:
    if num:
        return num
    return max(4, min(16, 128 // max(int(batch), 1)))


def hybrid_polish_iters(iters: int, frac: float) -> int:
    """The hybrid search's zoom polish: the last max(2, round(iters *
    frac)) of a stage's iterations, none in a stage of 4 or fewer."""
    return max(2, int(round(iters * frac))) if iters > 4 else 0


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def models_to(models: TTOModels, device) -> TTOModels:
    gmm = models.init_gmm
    return models._replace(
        body=models.body.to(device), vposer=_tree_to(models.vposer, device),
        humor=_tree_to(models.humor, device),
        init_gmm=None if gmm is None else gmm_lib.GmmParams(
            *[t.to(device) for t in gmm]))


# ---------------------------------------------------------------------------
# SMPL over a sequence batch, velocities
# ---------------------------------------------------------------------------

def _keypt_ids(body: smpl_lib.SmplModel) -> np.ndarray:
    return np.asarray([i for i in C.KEYPT_VERTS if i < body.num_verts],
                      np.int64)


def verts_mode_for(observed) -> str:
    """The cheapest vertex set the energies read, by observed keys: 'full'
    (a point cloud needs the whole mesh), 'keypt' (the 43 keypoint
    vertices: their data term or the overlap consistency), 'none'
    (joints only)."""
    if "points3d" in observed:
        return "full"
    if "verts3d" in observed or "seq_interval" in observed:
        return "keypt"
    return "none"


def batch_size_of(observed: Dict[str, Any]) -> int:
    """Window-batch size: the leading dimension of the per-window
    observations (all but E.BATCH_OBS_KEYS)."""
    return next(v for k, v in observed.items()
                if k not in E.BATCH_OBS_KEYS).shape[0]


def smpl_results(body: smpl_lib.SmplModel, trans: torch.Tensor,
                 root_orient: torch.Tensor, body_pose: torch.Tensor,
                 betas: torch.Tensor, verts: str = "none"
                 ) -> Dict[str, torch.Tensor]:
    """One LBS pass over all B*T frames. verts: 'full' (the whole mesh as
    "points3d", its 43 keypoint vertices as "verts3d"), 'keypt' (only the
    keypoint vertices, "verts3d"), 'none' (joints only, the default)."""
    B, T = trans.shape[:2]
    if verts == "full":
        vert_ids = None
    elif verts == "keypt":
        vert_ids = _keypt_ids(body)
    else:
        vert_ids = np.zeros((0,), np.int64)
    out = smpl_lib.forward(body, root_orient.reshape(B * T, 3),
                           body_pose.reshape(B * T, -1),
                           betas.repeat_interleave(T, dim=0),
                           trans.reshape(B * T, 3), vert_ids=vert_ids)
    Jtr = out.Jtr.reshape(B, T, -1, 3)
    nj = C.NUM_SMPL_JOINTS
    res = {"joints3d": Jtr[:, :, :nj], "joints3d_extra": Jtr[:, :, nj:]}
    if verts == "full":
        v = out.v.reshape(B, T, -1, 3)
        res["points3d"] = v
        res["verts3d"] = v[:, :, device_index(_keypt_ids(body), v.device)]
    elif verts == "keypt":
        res["verts3d"] = out.v.reshape(B, T, -1, 3)
    return res


def estimate_linear_velocity(seq: torch.Tensor, h: float) -> torch.Tensor:
    """(B, T, ...) -> forward/central/backward differences."""
    init = (seq[:, 1:2] - seq[:, 0:1]) / h
    mid = (seq[:, 2:] - seq[:, :-2]) / (2.0 * h)
    last = (seq[:, -1:] - seq[:, -2:-1]) / h
    return torch.cat([init, mid, last], dim=1)


def estimate_angular_velocity(rot_seq: torch.Tensor, h: float
                              ) -> torch.Tensor:
    """(B, T, 3, 3) -> (B, T, 3) via skew(dR/dt R^T)."""
    w = torch.matmul(estimate_linear_velocity(rot_seq, h),
                     rot_seq.transpose(-1, -2))
    return torch.stack([(-w[..., 1, 2] + w[..., 2, 1]) / 2.0,
                        (w[..., 0, 2] - w[..., 2, 0]) / 2.0,
                        (-w[..., 0, 1] + w[..., 1, 0]) / 2.0], dim=-1)


def _velocities(trans, root_orient, joints3d, fps):
    h = 1.0 / fps
    return (estimate_linear_velocity(trans, h),
            estimate_linear_velocity(joints3d, h),
            estimate_angular_velocity(transforms.aa_to_rotmat(root_orient),
                                      h))


def estimate_velocities(body, trans, root_orient, body_pose, betas, fps):
    """(trans_vel, joints_vel, root_orient_vel) of an SMPL sequence."""
    pred = smpl_results(body, trans, root_orient, body_pose, betas)
    return _velocities(trans, root_orient, pred["joints3d"], fps)


def infer_latent_motion(models: TTOModels, trans, root_orient, body_pose,
                        betas, fps) -> torch.Tensor:
    """Posterior-mean latents z_{1..T-1} of an SMPL trajectory."""
    return _infer_and_velocities(models, trans, root_orient, body_pose,
                                 betas, fps)[0]


def _infer_and_velocities(models, trans, root_orient, body_pose, betas, fps):
    B, T = trans.shape[:2]
    pred = smpl_results(models.body, trans, root_orient, body_pose, betas)
    trans_vel, joints_vel, root_vel = _velocities(trans, root_orient,
                                                  pred["joints3d"], fps)
    seq = {
        "trans": trans, "trans_vel": trans_vel,
        "root_orient": transforms.aa_to_rotmat(root_orient).reshape(B, T, 9),
        "root_orient_vel": root_vel,
        "pose_body": transforms.aa_to_rotmat(
            body_pose.reshape(B, T, -1, 3)).reshape(B, T, -1),
        "joints": pred["joints3d"].reshape(B, T, -1),
        "joints_vel": joints_vel.reshape(B, T, -1),
    }
    z = H.infer_global_seq(models.humor_cfg, models.humor, seq).posterior[0]
    return z, trans_vel, joints_vel, root_vel


def _expand_contacts(logits: torch.Tensor):
    """(B, T-1, 9) logits -> (B, T, 22) confidences and binary contacts,
    first frame repeated."""
    conf9 = torch.sigmoid(logits)
    B, Tm1 = conf9.shape[:2]
    full = torch.zeros(B, Tm1, C.NUM_SMPL_JOINTS, dtype=conf9.dtype,
                       device=conf9.device)
    full[:, :, device_index(C.CONTACT_INDS, conf9.device)] = conf9
    conf = torch.cat([full[:, 0:1], full], dim=1)
    return conf, (conf > CONTACT_THRESH).to(conf9.dtype)


def _key_frames(B: int, device) -> torch.Tensor:
    return torch.zeros(B, dtype=torch.long, device=device)


def uses_rollout_kernels(cfg: H.HumorConfig) -> bool:
    """The rollout kernels' fixed layout is the default configuration's
    (as the JAX package's Pallas kernel's); any other rolls out through
    the typed models.humor.rollout."""
    return replace(cfg, detach_sched_samp=True) == H.HumorConfig()


def rollout_latent_motion(models: TTOModels,
                          weights: Optional[RK.RolloutWeights],
                          variables: Dict[str, torch.Tensor],
                          latent_motion: torch.Tensor,
                          cam2prior: Optional[Tuple] = None
                          ) -> Tuple[Dict, Dict]:
    """Roll the initial-state variables (B, 1, .) forward through HuMoR
    with the latents (B, T-1, latent), canonicalizing the first input and
    returning the trajectory in the input frame: through the fused
    rollout kernels with `weights`, through the typed rollout when
    `weights` is None (a configuration other than the default; steps_in
    > 1 raises there, as in the JAX package). With `cam2prior` (R, t,
    root height) the variables are camera-frame and the rollout runs in
    the prior frame. Returns (prior-frame dict, camera-frame
    trans/root_orient/pose_body), the same frame when cam2prior is
    None."""
    B = variables["trans"].shape[0]
    Tm1 = latent_motion.shape[1]
    body_pose0 = vp.latent2pose(models.vposer_cfg, models.vposer,
                                variables["latent_pose"])
    trans0, root0 = variables["trans"], variables["root_orient"]
    keys = _key_frames(B, trans0.device)
    if cam2prior is not None:
        R, t, rh = cam2prior
        prior = geo.apply_cam2prior(
            trans0, root0, R, t, rh, keys,
            smpl_root_joint_fn=lambda tr, ro: smpl_results(
                models.body, tr, ro, body_pose0,
                variables["betas"])["joints3d"][..., 0, 2])
        trans0, root0 = prior["trans"], prior["root_orient"]
    joints0 = smpl_results(models.body, trans0, root0, body_pose0,
                           variables["betas"])["joints3d"]
    init_state = {
        "trans": trans0[:, 0],
        "trans_vel": variables["trans_vel"][:, 0],
        "root_orient": transforms.aa_to_rotmat(root0[:, 0]).reshape(B, 9),
        "root_orient_vel": variables["root_orient_vel"][:, 0],
        "pose_body": transforms.aa_to_rotmat(
            body_pose0[:, 0].reshape(B, -1, 3)).reshape(B, -1),
        "joints": joints0[:, 0].reshape(B, -1),
        "joints_vel": variables["joints_vel"][:, 0].reshape(B, -1),
    }
    with PR.span("rollout"):
        if weights is not None:
            w, prior = RK.rollout(weights, init_state, latent_motion)
        else:
            roll = H.rollout(models.humor_cfg, models.humor, init_state, Tm1,
                             z_seq=latent_motion, canonicalize_input=True,
                             uncanonicalize_output=True)
            w, prior = roll.world, roll.prior
    root_mats = w["root_orient"].reshape(B, Tm1, 3, 3)
    pose_mats = w["pose_body"].reshape(B, Tm1, -1, 3, 3)
    out = {
        "trans": torch.cat([trans0, w["trans"]], dim=1),
        "root_orient": torch.cat([root0, transforms.rotmat_to_aa(root_mats)],
                                 dim=1),
        "pose_body": torch.cat(
            [body_pose0, transforms.rotmat_to_aa(pose_mats).reshape(
                B, Tm1, -1)], dim=1),
        "joints": torch.cat([joints0, w["joints"].reshape(B, Tm1, -1, 3)],
                            dim=1),
        "cond_prior": prior,
    }
    if "contacts" in w:
        out["contacts_conf"], out["contacts"] = _expand_contacts(
            w["contacts"])
    if cam2prior is not None:
        cam = geo.apply_cam2prior(out["trans"], out["root_orient"], R, t, rh,
                                  keys, inverse=True)
    else:
        cam = {"trans": out["trans"], "root_orient": out["root_orient"]}
    cam["pose_body"] = out["pose_body"]
    return out, cam


def init_variables(cfg: TTOConfig, models: TTOModels, batch_size: int,
                   observed: Dict[str, torch.Tensor], device
                   ) -> Dict[str, torch.Tensor]:
    """Stage-1/2 variables. With `optim_floor` the floor plane (from the
    observed one) is a variable; a point cloud sets each frame's
    translation to the mean of its visible points."""
    B, T = batch_size, cfg.seq_len
    root = torch.zeros(B, T, 3, device=device)
    root[..., 0] = torch.pi
    variables = {
        "trans": torch.zeros(B, T, 3, device=device),
        "root_orient": root,
        "latent_pose": torch.zeros(B, T, models.vposer_cfg.latent_dim,
                                   device=device),
        "betas": torch.zeros(B, cfg.num_betas, device=device),
    }
    if cfg.optim_floor and "floor_plane" in observed:
        fp = observed["floor_plane"]
        variables["floor_plane"] = fp[..., :3] * fp[..., 3:]
    if "points3d" in observed:
        pts = observed["points3d"]
        vis = E.visible_mask(pts)
        cnt = torch.clamp(vis[..., 0].sum(dim=2, keepdim=True), min=1)
        variables["trans"] = torch.where(vis, pts, torch.zeros_like(
            pts)).sum(dim=2) / cnt
    elif "joints2d" in observed and "cam_f" in observed:
        variables["trans"] = _init_z_from_bones(cfg, models, variables,
                                                observed)
    return variables


def _init_z_from_bones(cfg: TTOConfig, models: TTOModels, variables,
                       observed) -> torch.Tensor:
    """The translation with its depth from the ratio of mean bone lengths
    over C.OP_EDGE_LIST: the rest body's 3D bones at frame 0 against the
    observed 2D ones at each window's best-visible frame (the first of
    those with the most confident keypoints), times the focal length."""
    with torch.no_grad():
        pose = vp.latent2pose(models.vposer_cfg, models.vposer,
                              variables["latent_pose"])
        pred = smpl_results(models.body, variables["trans"],
                            variables["root_orient"], pose,
                            variables["betas"])
        full = torch.cat([pred["joints3d"], pred["joints3d_extra"]], dim=2)
        op3d = full[:, :, device_index(cfg.energy.smpl2op_map,
                                       full.device)]
        obs2d = observed["joints2d"][..., :2]
        conf2d = observed["joints2d"][..., 2]
        best_t = (conf2d > 0.0).sum(dim=2).argmax(dim=1)          # (B,)
        edges = device_index(C.OP_EDGE_LIST, full.device).reshape(-1, 2)
        b3d = torch.linalg.vector_norm(
            op3d[:, 0, edges[:, 0]] - op3d[:, 0, edges[:, 1]], dim=-1)
        rows = torch.arange(obs2d.shape[0], device=obs2d.device)
        best2d, best_c = obs2d[rows, best_t], conf2d[rows, best_t]
        b2d = torch.linalg.vector_norm(
            best2d[:, edges[:, 0]] - best2d[:, edges[:, 1]], dim=-1)
        c2d = torch.minimum(best_c[:, edges[:, 0]], best_c[:, edges[:, 1]])
        mean_b2d = (b2d * (c2d > 0.0)).mean(dim=1)
        init_z = observed["cam_f"][:, 0] * (
            b3d.mean(dim=1) / torch.clamp(mean_b2d, min=1e-6))
        trans = variables["trans"].clone()
        trans[..., 2] = init_z[:, None]
    return trans


def slice_observations(observed: Dict[str, Any], nsteps: int):
    return {k: (v[:, :nsteps] if k in E.TIME_INDEXED_OBS_KEYS else v)
            for k, v in observed.items()}


def _tile(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, ...) -> (K*B, ...), candidate-major."""
    return x.repeat(K, *([1] * (x.dim() - 1)))


def tile_observations(observed: Dict[str, Any], K: int) -> Dict[str, Any]:
    """The observations as an objective sees them for K line-search
    candidates folded into K*B rows: the per-window ones tiled, the
    batch's own (E.BATCH_OBS_KEYS) untiled."""
    return {k: v if k in E.BATCH_OBS_KEYS else _tile(v, K)
            for k, v in observed.items()}


# ---------------------------------------------------------------------------
# Stage objectives (per window: v has leading batch K*B, returns (K*B,))
# ---------------------------------------------------------------------------

class FitModels(NamedTuple):
    """Models on one device, with the rollout kernels' weight layout (None
    for a configuration the kernels do not cover) and the GMM's Cholesky
    terms made once."""
    models: TTOModels
    rollout_weights: Optional[RK.RolloutWeights]
    gmm_terms: Optional[Tuple]


def prepare_models(models: TTOModels, device) -> FitModels:
    models = models_to(models, device)
    gmm = models.init_gmm
    weights = (RK.RolloutWeights(models.humor, device)
               if uses_rollout_kernels(models.humor_cfg) else None)
    return FitModels(models, weights,
                     gmm_lib.chol_terms(gmm) if gmm is not None else None)


def _pose(fm: FitModels, latent):
    return vp.latent2pose(fm.models.vposer_cfg, fm.models.vposer, latent)


_RIGID_KEYS = ("joints3d", "joints3d_extra", "verts3d", "points3d")


def stage1_objective(cfg: TTOConfig, fm: FitModels, vars_,
                     verts: str = "none", mesh: Optional[P.Mesh] = None):
    """Root-only data terms. Pose and shape are frozen in stage 1, so the
    body is skinned once (identity root, zero trans; `verts` as in
    smpl_results) and each evaluation applies p = R_root (base - j0) + j0
    + trans to every skinned point."""
    B = vars_["trans"].shape[0]
    body = fm.models.body
    with torch.no_grad():
        base = smpl_results(body, torch.zeros_like(vars_["trans"]),
                            torch.zeros_like(vars_["root_orient"]),
                            _pose(fm, vars_["latent_pose"]), vars_["betas"],
                            verts=verts)
        j0b = smpl_lib.rest_root_joint(body, vars_["betas"])[:, None, None]
        base_pts = {k: base[k] - j0b for k in _RIGID_KEYS if k in base}
    w1 = cfg.stage_weights[0]
    tiled = {}

    def loss(v, obs):
        K = v["trans"].shape[0] // B
        if K not in tiled:
            tiled[K] = ({k: _tile(p, K) for k, p in base_pts.items()},
                        _tile(j0b, K))
        pts, j0 = tiled[K]
        R = transforms.aa_to_rotmat(v["root_orient"])
        off = j0 + v["trans"][:, :, None]
        pred = {k: torch.einsum("btij,btnj->btni", R, p) + off
                for k, p in pts.items()}
        with PR.span("energies"):
            return E.root_fit(cfg.energy, w1, obs, pred, mesh)
    return loss


def stage2_objective(cfg: TTOConfig, fm: FitModels,
                     mesh: Optional[P.Mesh] = None):
    """Data terms + pose/shape priors + joint smoothness."""
    def loss(v, obs):
        pred = smpl_results(fm.models.body, v["trans"], v["root_orient"],
                            _pose(fm, v["latent_pose"]), v["betas"],
                            verts=verts_mode_for(obs))
        pred["latent_pose"] = v["latent_pose"]
        pred["betas"] = v["betas"]
        with PR.span("energies"):
            return E.smpl_fit(cfg.energy, cfg.stage_weights[1], obs, pred,
                              cfg.seq_len, mesh)
    return loss


def cam2prior_of(fm: FitModels, v) -> Tuple:
    """(R, t, root height) of the camera-to-prior map at frame 0: only
    frame 0 is decoded and skinned, all compute_cam2prior reads."""
    m = fm.models
    pose0 = _pose(fm, v["latent_pose"][:, :1])
    joints0 = smpl_results(m.body, v["trans"][:, :1], v["root_orient"][:, :1],
                           pose0, v["betas"])["joints3d"]
    return geo.compute_cam2prior(v["floor_plane"], v["trans"][:, 0],
                                 v["root_orient"][:, 0], joints0[:, 0])


def stage3_setup(cfg: TTOConfig, fm: FitModels, vars_):
    """Latent-motion inference + velocity estimation (in the prior frame
    under `optim_floor`) + the shrink to the initial-state variables."""
    m = fm.models
    pose = _pose(fm, vars_["latent_pose"])
    trans, root = vars_["trans"], vars_["root_orient"]
    if cfg.optim_floor:
        R, t, rh = cam2prior_of(fm, vars_)
        prior = geo.apply_cam2prior(
            trans, root, R, t, rh, _key_frames(trans.shape[0], trans.device),
            smpl_root_joint_fn=lambda tr, ro: smpl_results(
                m.body, tr, ro, pose, vars_["betas"])["joints3d"][..., 0, 2])
        trans, root = prior["trans"], prior["root_orient"]
    z, trans_vel, joints_vel, root_vel = _infer_and_velocities(
        m, trans, root, pose, vars_["betas"], cfg.data_fps)
    s3 = {
        "trans": vars_["trans"][:, :1],
        "root_orient": vars_["root_orient"][:, :1],
        "latent_pose": vars_["latent_pose"][:, :1],
        "betas": vars_["betas"],
        "latent_motion": z,
        "trans_vel": trans_vel[:, :1],
        "joints_vel": joints_vel[:, :1],
        "root_orient_vel": root_vel[:, :1],
    }
    if cfg.optim_floor:
        s3["floor_plane"] = vars_["floor_plane"]
    return s3


def stage3_objective(fm: FitModels, weights3: E.StageWeights, nsteps: int,
                     scale: float, energy: E.EnergyConfig = E.EnergyConfig(),
                     optim_floor: bool = False,
                     mesh: Optional[P.Mesh] = None):
    """Stage-3 objective over the first `nsteps` frames: the rollout of
    the initial state under the latents, then the stage-2 terms (in the
    camera frame) and the motion, initial-state, consistency, contact and
    floor terms (in the prior frame)."""
    m = fm.models

    def loss(v, obs):
        c2p = cam2prior_of(fm, v) if optim_floor else None
        zm = v["latent_motion"][:, : nsteps - 1]
        prior_out, _ = rollout_latent_motion(m, fm.rollout_weights, v, zm,
                                             cam2prior=c2p)
        pred = smpl_results(m.body, prior_out["trans"],
                            prior_out["root_orient"], prior_out["pose_body"],
                            v["betas"], verts=verts_mode_for(obs))
        if weights3.pose_prior > 0:
            pred["latent_pose"] = vp.pose2latent(m.vposer_cfg, m.vposer,
                                                 prior_out["pose_body"])
        pred["betas"] = v["betas"]
        pred["latent_motion"] = zm
        for k in ("joints_vel", "trans_vel", "root_orient_vel"):
            pred[k] = v[k]
        pred["joints3d_rollout"] = prior_out["joints"]
        if "contacts_conf" in prior_out:
            pred["contacts_conf"] = prior_out["contacts_conf"]
        if optim_floor:
            # The camera-frame prediction is an exact rigid map of the
            # prior-frame one: SMPL turns the body about the shaped rest
            # root joint j0, so the inverse cam2prior parameters move
            # every point by p_cam = R^T (p - trans[:, 0] - j0) + j0 - t
            # (no second skinning pass).
            R, t, _ = c2p
            j0 = smpl_lib.rest_root_joint(m.body, v["betas"])
            shift = (prior_out["trans"][:, 0] + j0)[:, None, None]
            off = (j0 - t)[:, None, None]
            cam_pred = {k: torch.einsum("bji,btnj->btni", R, pred[k] - shift)
                        + off for k in _RIGID_KEYS if k in pred}
            for k in ("latent_pose", "betas"):
                if k in pred:
                    cam_pred[k] = pred[k]
            cam_pred["floor_plane"] = v["floor_plane"]
        else:
            cam_pred = pred
        with PR.span("energies"):
            return E.motion_fit(
                energy, weights3, slice_observations(obs, nsteps), pred,
                cam_pred, nsteps, gmm=m.init_gmm,
                cond_prior=(prior_out["cond_prior"]
                            if m.humor_cfg.conditional_prior else None),
                init_motion_scale=scale, gmm_terms=fm.gmm_terms, mesh=mesh)
    return loss


def stage3_phases(cfg: TTOConfig):
    """(weights, nsteps, init-motion scale, iterations, trainable) of the
    stage-3 sub-phases: tune the initial state on the first frames
    (without the overlap terms: the sub-window holds no window's last
    frames, which they pair with the next window's first), freeze it,
    refine everything."""
    T = cfg.seq_len
    w3 = cfg.stage_weights[2]
    iters = cfg.num_iters[2]
    if not cfg.stage3_tune_init_state:
        return ((w3, T, 1.0, iters, lambda k: True),)
    n_init = min(cfg.stage3_tune_init_num_frames, T)
    f0 = min(cfg.stage3_freeze_start, iters)
    f1 = min(cfg.stage3_freeze_end, iters)
    freeze = ("trans", "root_orient", "latent_pose", "trans_vel",
              "joints_vel", "root_orient_vel")
    wB = (replace(w3, contact_vel=0.0, contact_height=0.0)
          if cfg.stage3_contact_refine_only else w3)
    scale = float(T) / n_init
    wA = replace(w3, rgb_overlap_consist=0.0)
    return ((wA, n_init, 1.0, f0, lambda k: True),
            (wB, T, scale, f1 - f0, lambda k: k not in freeze),
            (w3, T, scale, iters - f1, lambda k: True))


# ---------------------------------------------------------------------------
# The 3-stage runner
# ---------------------------------------------------------------------------

def make_runner(cfg: TTOConfig, models: TTOModels, device="cuda",
                mesh: Optional[P.Mesh] = None):
    """A reusable fit `run(observed) -> TTOResult` on `device` (the GPU
    unless the caller asks for the CPU). With `mesh`
    (parallel.mesh.make_mesh()) the windows are split over its ranks:
    every rank calls `run` with the whole observation, fits its windows,
    and gets the whole batch's TTOResult; W must divide the windows.
    `observed` holds one of
      * "joints3d" (B, T, 22, 3) or "verts3d" (B, T, 43, 3), inf where
        a point is missing;
      * an RGB video's windows: "joints2d" (B, T, 25, 3) with
        confidences, "cam_f" and "cam_center" (B, 2), "floor_plane"
        (B, 4) (fitted with `cfg.optim_floor`), "seq_interval" (B, 2)
        [start, end) frames (data/rgb.py makes these), and optionally
        "prev_batch_overlap_res": the previous batch's last window
        ("verts3d" (Tp, 43, 3), "betas", "floor_plane" (4,),
        "seq_interval" (2,));
      * a PROX RGB-D observation: "points3d" (B, T, N, 3) inf-padded
        with the RGB keys but seq_interval."""
    dev = resolve_device(device)
    fm = prepare_models(models, dev)

    def _lbfgs(loss_fn: Callable, vars_, iters, observed, trainable,
               stage):
        """L-BFGS over a per-row `loss_fn(v, obs) -> (K*B,)`, the
        line-search candidates folded into the window batch (the batch's
        own observations, E.BATCH_OBS_KEYS, stay untiled)."""
        if iters == 0:
            return vars_, torch.zeros(0, device=dev)
        B = batch_size_of(observed)       # this rank's windows
        ls = cfg.lbfgs_linesearch
        if isinstance(ls, (tuple, list)):
            ls = ls[stage]
        # the auto search and the candidate count key off the windows a
        # device holds (B // W under a mesh, as the JAX package's B_dev)
        if ls == "auto":
            ls = "parallel" if B < 12 else "armijo"
        tiled = {}

        def batched(vk):
            K = next(iter(vk.values())).shape[0]
            if K not in tiled:
                tiled[K] = tile_observations(observed, K)
            flat = {k: v.reshape(K * B, *v.shape[2:]) for k, v in vk.items()}
            return loss_fn(flat, tiled[K]).reshape(K, B).sum(dim=1)

        def run_(linesearch, v, n):
            return run_lbfgs(batched, v, n, mask=make_mask(vars_, trainable),
                             history_size=cfg.lbfgs_history,
                             linesearch=linesearch,
                             num_candidates=resolve_candidates(
                                 cfg.lbfgs_candidates, B),
                             max_linesearch_steps=cfg.lbfgs_max_linesearch,
                             tol_grad=cfg.lbfgs_tol_grad,
                             tol_change=cfg.lbfgs_tol_change,
                             stall_patience=cfg.lbfgs_stall_patience,
                             reduce=mesh)

        if ls == "hybrid":
            polish = hybrid_polish_iters(iters, cfg.lbfgs_polish_frac)
            res = run_("parallel", vars_, iters - polish)
            if polish:
                res2 = run_("zoom", res.params, polish)
                res = res2._replace(loss_history=torch.cat(
                    [res.loss_history, res2.loss_history]))
        else:
            res = run_(ls, vars_, iters)
        return res.params, res.loss_history

    def gather(tree):
        """The whole batch from every rank's windows (the loss histories
        are sums over ranks already)."""
        if mesh is None:
            return tree
        return {k: P.all_gather_batch(mesh, v) for k, v in tree.items()}

    def export(vars_):
        return {"trans": vars_["trans"].clone(),
                "root_orient": vars_["root_orient"].clone(),
                "pose_body": _pose(fm, vars_["latent_pose"]),
                "betas": vars_["betas"].clone()}

    def run(observed: Dict[str, torch.Tensor],
            timings: Optional[Dict[str, float]] = None) -> TTOResult:
        """Fit one observation batch. With a `timings` dict, the device is
        synchronised after each stage and its wall-clock seconds recorded
        there (stage1, stage2, stage3_setup, stage3, final). While
        recording (utils/profiling), the same stretches are the spans
        fit.stage1, ..., fit.final, with no synchronisation."""
        t_last = [time.perf_counter()]

        def mark(name):
            if timings is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                now = time.perf_counter()
                timings[name] = now - t_last[0]
                t_last[0] = now

        losses, per_stage = {}, {}
        with PR.span("fit.stage1"):
            observed = _tree_to(observed, dev)
            if mesh is not None:
                # this rank's windows; the batch's own observations whole
                observed = {k: v if k in E.BATCH_OBS_KEYS
                            else P.shard_batch(mesh, v)
                            for k, v in observed.items()}
            B = batch_size_of(observed)
            vars_ = init_variables(cfg, fm.models, B, observed, dev)
            vars_, losses["stage1"] = _lbfgs(
                stage1_objective(cfg, fm, vars_, verts_mode_for(observed),
                                 mesh),
                vars_, cfg.num_iters[0], observed,
                lambda k: k in ("trans", "root_orient"), 0)
            with torch.no_grad():
                per_stage["stage1"] = gather(export(vars_))
        mark("stage1")
        with PR.span("fit.stage2"):
            vars_, losses["stage2"] = _lbfgs(
                stage2_objective(cfg, fm, mesh), vars_, cfg.num_iters[1],
                observed, lambda k: k != "floor_plane", 1)
            with torch.no_grad():
                per_stage["stage2"] = gather(export(vars_))
        mark("stage2")
        with PR.span("fit.stage3_setup"), torch.no_grad():
            s3 = stage3_setup(cfg, fm, vars_)
        mark("stage3_setup")
        hist3 = []
        with PR.span("fit.stage3"):
            for wts, nsteps, scale, n, trainable in stage3_phases(cfg):
                s3, h = _lbfgs(stage3_objective(fm, wts, nsteps, scale,
                                                cfg.energy, cfg.optim_floor,
                                                mesh),
                               s3, n, observed, trainable, 2)
                hist3.append(h)
            losses["stage3"] = torch.cat(hist3)
        mark("stage3")
        with PR.span("fit.final"), torch.no_grad():
            c2p = cam2prior_of(fm, s3) if cfg.optim_floor else None
            prior_out, cam_out = rollout_latent_motion(
                fm.models, fm.rollout_weights, s3, s3["latent_motion"],
                cam2prior=c2p)
            m = fm.models
            final = {
                "trans": cam_out["trans"],
                "root_orient": cam_out["root_orient"],
                "pose_body": cam_out["pose_body"],
                "betas": s3["betas"],
                "latent_motion": s3["latent_motion"],
                "latent_pose": vp.pose2latent(m.vposer_cfg, m.vposer,
                                              cam_out["pose_body"]),
                "prior_trans": prior_out["trans"],
                "prior_root_orient": prior_out["root_orient"],
                "joints3d_rollout": prior_out["joints"],
            }
            if "contacts" in prior_out:
                final["contacts"] = prior_out["contacts"]
            if cfg.optim_floor:
                final["floor_plane"] = geo.parse_floor_plane(
                    s3["floor_plane"])
            final = gather(final)
        per_stage["stage3"] = {k: final[k] for k in
                               ("trans", "root_orient", "pose_body", "betas")}
        mark("final")
        return TTOResult(final=final, per_stage=per_stage, losses=losses)

    return run


def run(cfg: TTOConfig, models: TTOModels, observed: Dict[str, torch.Tensor],
        device="cuda", timings: Optional[Dict[str, float]] = None
        ) -> TTOResult:
    """One-shot convenience wrapper around make_runner."""
    return make_runner(cfg, models, device=device)(observed, timings=timings)
