"""Fitting energies of the 3-stage TTO (port of
humor_tpu/fitting/energies.py): the joints3d, keypoint-vertex, point-cloud,
2D-keypoint and floor terms, the priors, the overlap-consistency terms of
a video's windows, and the stage objectives over them.

Every term returns one value per row, summed over everything else; a
stage objective is the weighted sum of its terms, still one per row. The
optimizer sums rows, and folds its K line-search candidates into the
window batch: the rows are K candidates x B windows, candidate-major.
The per-window terms need nothing more (the point-cloud term's robust
scale is per window, as in JAX). The overlap terms couple windows, so
they reshape the rows to (K, B) with the untiled (B, 2) `seq_interval`,
compare window b with window b + 1 of the same candidate only, and
charge the pair to row b (the cross-batch terms to row 0): each
candidate's row sum is JAX's scalar for that candidate. Missing
observations carry an inf sentinel and are masked with `torch.where`,
never by multiplying (0 * inf is NaN, in the gradient too); the overlap
masks multiply, as JAX's do, because predictions are finite.

Windows split over ranks (the sharded fit, `mesh`): each rank holds B/W
consecutive windows and the whole `seq_interval`. Every term but the
overlap ones is per window (the point-cloud term's robust scale
included), so it needs nothing. A rank charges the pairs whose first
window it holds: the pair of its last window with the next rank's first
takes that window through a differentiable all-gather, and the
cross-batch terms are charged by the rank holding window 0. Each pair
is charged once: the gather's backward sums every rank's cotangents, so
a term charged on every rank would count W times in the gradient. Every
rank builds the same terms and masks out with `torch.where` what it does
not charge (the last rank's missing pair, window 0's terms elsewhere),
so that all ranks enter the gather's backward together.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from humor_torch.body_model import constants as C
from humor_torch.device import device_index
from humor_torch.fitting import geometry as geo
from humor_torch.fitting import robust as rob
from humor_torch.models import gmm as gmm_lib
from humor_torch.ops import chamfer
from humor_torch.parallel import mesh as P

CONTACT_HEIGHT_THRESH = 0.08

# Observation keys whose axis 1 is time (sliced to a stage-3 sub-window);
# everything else (floor_plane, cam_f, cam_center, ...) is per-window
# metadata and passes through unsliced whatever its shape.
TIME_INDEXED_OBS_KEYS = frozenset(
    {"joints3d", "verts3d", "points3d", "joints2d"})
# Observations of the window batch as a whole: the (B, 2) frame intervals
# and the previous batch's last window. The optimizer does not tile them
# over line-search candidates.
BATCH_OBS_KEYS = frozenset({"seq_interval", "prev_batch_overlap_res"})


@dataclass(frozen=True)
class StageWeights:
    """Loss weights of one stage; zero = term absent."""

    joints3d: float = 0.0
    joints3d_rollout: float = 0.0
    verts3d: float = 0.0
    points3d: float = 0.0
    joints2d: float = 0.0
    pose_prior: float = 0.0
    shape_prior: float = 0.0
    motion_prior: float = 0.0
    init_motion_prior: float = 0.0
    joint_consistency: float = 0.0
    bone_length: float = 0.0
    joints3d_smooth: float = 0.0
    contact_vel: float = 0.0
    contact_height: float = 0.0
    floor_reg: float = 0.0
    rgb_overlap_consist: float = 0.0


@dataclass(frozen=True)
class EnergyConfig:
    """Settings shared by all stages."""

    robust_loss: str = "none"           # for points3d: 'none' | 'bisquare'
    robust_tuning_const: float = rob.BISQUARE_TUNE_CONST
    joints2d_sigma: float = 100.0
    smpl2op_map: Optional[Tuple[int, ...]] = None
    ignore_op_joints: Tuple[int, ...] = tuple(C.OP_IGNORE_JOINTS)


def _per_window(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def visible_mask(obs: torch.Tensor) -> torch.Tensor:
    return ~torch.isinf(obs)


def joints3d_loss(obs: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Visibility-masked 0.5 * squared error."""
    diff = torch.where(visible_mask(obs), obs - pred, torch.zeros_like(pred))
    return 0.5 * _per_window(diff * diff)


def verts3d_loss(obs: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return joints3d_loss(obs, pred)


def points3d_loss(cfg: EnergyConfig, obs: torch.Tensor, pred: torch.Tensor
                  ) -> torch.Tensor:
    """One-way chamfer from the observed cloud (B, T, N, 3), inf-padded,
    to the predicted mesh (B, T, V, 3), with robust weighting of the
    distances. Padded points sit at 1e6 for the nearest-neighbour search
    and are masked out of the robust scale (per window, over T*N) and of
    the sum."""
    B, T, N, _ = obs.shape
    vis = visible_mask(obs)
    obs_safe = torch.where(vis, obs, torch.full_like(obs, 1e6))
    sqr, _ = chamfer.nn_distance(obs_safe.reshape(B * T, N, 3),
                                 pred.reshape(B * T, -1, 3))
    dist = torch.sqrt(torch.clamp(sqr.reshape(B, T * N), min=1e-12))
    mask = vis[..., 0].reshape(B, T * N)
    weighted, _ = rob.apply_robust_weighting(
        dist, cfg.robust_loss, cfg.robust_tuning_const, mask=mask)
    return 0.5 * (weighted * mask).sum(dim=1)


def joints2d_loss(cfg: EnergyConfig, obs2d: torch.Tensor,
                  joints3d: torch.Tensor, joints3d_extra: torch.Tensor,
                  cam_f: torch.Tensor, cam_center: torch.Tensor
                  ) -> torch.Tensor:
    """Confidence^2-weighted Geman-McClure reprojection error of the
    OpenPose joints (obs2d (B, T, 25, 3): x, y, confidence)."""
    if cfg.smpl2op_map is None:
        raise ValueError("joints2d_loss needs EnergyConfig.smpl2op_map")
    B, T = obs2d.shape[:2]
    full = torch.cat([joints3d, joints3d_extra], dim=2)
    op = full[:, :, device_index(cfg.smpl2op_map, full.device)]
    pts = op.reshape(B * T, C.OP_NUM_JOINTS, 3)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(
        B * T, 3, 3)
    uv = geo.perspective_projection(
        pts, eye, torch.zeros_like(pts[:, 0]),
        cam_f.repeat_interleave(T, dim=0),
        cam_center.repeat_interleave(T, dim=0)
    ).reshape(B, T, C.OP_NUM_JOINTS, 2)
    conf = obs2d[..., 2:3]
    if cfg.ignore_op_joints:
        keep = torch.ones(C.OP_NUM_JOINTS, dtype=conf.dtype,
                          device=conf.device)
        keep[list(cfg.ignore_op_joints)] = 0.0
        conf = conf * keep[:, None]
    robust_sq = rob.gmof(uv - obs2d[..., :2], cfg.joints2d_sigma)
    return _per_window(conf * conf * robust_sq)


def floor_reg_loss(pred_floor3: torch.Tensor, obs_floor4: torch.Tensor
                   ) -> torch.Tensor:
    """Predicted floor (B, 3) close to the observed (B, 4) one."""
    d = pred_floor3 - obs_floor4[..., :3] * obs_floor4[..., 3:]
    return 0.5 * _per_window(d * d)


def joints3d_smooth_loss(pred: torch.Tensor) -> torch.Tensor:
    d = pred[:, 1:] - pred[:, :-1]
    return 0.5 * _per_window(d * d)


def pose_prior_loss(latent_pose: torch.Tensor) -> torch.Tensor:
    return _per_window(latent_pose * latent_pose)


def shape_prior_loss(betas: torch.Tensor) -> torch.Tensor:
    return _per_window(betas * betas)


def log_normal(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Gaussian log-density summed over the last dim."""
    lp = (-0.5 * torch.log(v) - 0.5 * math.log(2.0 * math.pi)
          - (x - m) ** 2 / (2.0 * v))
    return lp.sum(dim=-1)


def motion_prior_loss(latent_motion: torch.Tensor,
                      cond_prior: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> torch.Tensor:
    """-log N(z; mu, var) under the conditional prior, else ||z||^2."""
    if cond_prior is None:
        return _per_window(latent_motion ** 2)
    pm, pv = cond_prior
    return -_per_window(log_normal(latent_motion, pm, pv))


def init_motion_prior_loss(gmm: gmm_lib.GmmParams, joints: torch.Tensor,
                           joints_vel: torch.Tensor, trans_vel: torch.Tensor,
                           root_orient_vel: torch.Tensor,
                           gmm_terms: Optional[Tuple] = None) -> torch.Tensor:
    """GMM NLL of the 138-d initial state."""
    B = joints.shape[0]
    state = torch.cat([joints.reshape(B, -1), joints_vel.reshape(B, -1),
                       trans_vel.reshape(B, -1),
                       root_orient_vel.reshape(B, -1)], dim=-1)
    return -gmm_lib.log_prob(gmm, state, gmm_terms)


def joint_consistency_loss(smpl_joints: torch.Tensor,
                           rollout_joints: torch.Tensor) -> torch.Tensor:
    d = smpl_joints - rollout_joints
    return 0.5 * _per_window(d * d)


def bone_length_loss(rollout_joints: torch.Tensor) -> torch.Tensor:
    """Temporal bone-length consistency over the kinematic tree."""
    parents = device_index(C.SMPL_PARENTS[1:], rollout_joints.device)
    bones = rollout_joints[:, :, 1:] - rollout_joints[:, :, parents]
    lengths = torch.linalg.vector_norm(bones, dim=-1)
    diff = lengths[:, 1:] - lengths[:, :-1]
    return 0.5 * _per_window(diff * diff)


def contact_vel_loss(contacts_conf: torch.Tensor, joints3d: torch.Tensor
                     ) -> torch.Tensor:
    """Zero joint velocity where contact is predicted."""
    delta_sq = ((joints3d[:, 1:] - joints3d[:, :-1]) ** 2).sum(dim=-1)
    return 0.5 * _per_window(delta_sq * contacts_conf[:, 1:])


def contact_height_loss(contacts_conf: torch.Tensor, joints3d: torch.Tensor
                        ) -> torch.Tensor:
    """Contacting joints near the z=0 floor."""
    floor_diff = torch.relu(torch.abs(joints3d[..., 2])
                            - CONTACT_HEIGHT_THRESH)
    return _per_window(floor_diff * contacts_conf)


# ---------------------------------------------------------------------------
# Overlap consistency of a video's windows
# ---------------------------------------------------------------------------

def _candidates(x: torch.Tensor, num_windows: int) -> torch.Tensor:
    """(K*B, ...) rows, candidate-major -> (K, B, ...)."""
    rows = x.shape[0]
    if rows % num_windows:
        raise ValueError(f"{rows} rows are no multiple of {num_windows} "
                         "windows")
    return x.reshape(rows // num_windows, num_windows, *x.shape[1:])


def _charge_pairs(pair_loss: torch.Tensor) -> torch.Tensor:
    """(K, B-1) losses of the pairs (b, b+1) -> (K*B,), pair b on row b."""
    return torch.cat([pair_loss, torch.zeros_like(pair_loss[:, :1])],
                     dim=1).reshape(-1)


def _charge_first(loss: torch.Tensor, num_windows: int) -> torch.Tensor:
    """(K,) losses of each candidate's window 0 -> (K*B,) on row 0."""
    rest = loss.new_zeros(loss.shape[0], num_windows - 1)
    return torch.cat([loss[:, None], rest], dim=1).reshape(-1)


def _time_mask(valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(..., T) booleans -> 0/1 of `like`'s dtype, broadcast over the
    trailing dims of `like` (..., T, ...)."""
    extra = like.dim() - valid.dim()
    return valid.to(like.dtype).reshape(*valid.shape, *([1] * extra))


def _sum_after(x: torch.Tensor, lead: int) -> torch.Tensor:
    return x.reshape(*x.shape[:lead], -1).sum(dim=-1)


def _masked_overlap_l2(prev_seq: torch.Tensor, cur_seq: torch.Tensor,
                       overlap: torch.Tensor, with_vel: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum-of-squares agreement between the last `overlap` frames of
    prev_seq and the first `overlap` frames of cur_seq, both (..., T, ...)
    with `overlap` (...) as a tensor of the leading dims. Frame i of the
    current window is aligned with frame (i - overlap) mod T of the
    previous one (JAX's roll, one per pair, never across pairs) and kept
    for i < overlap; velocities likewise with overlap - 1. Returns the
    position and velocity sums over (...)."""
    lead = overlap.dim()
    T = prev_seq.shape[lead]
    tail = prev_seq.shape[lead + 1:]

    def aligned(seq, shift, n):
        t = torch.arange(n, device=seq.device)
        idx = torch.remainder(t - shift[..., None], n)       # (..., n)
        idx = idx.reshape(*idx.shape, *([1] * len(tail))).expand(
            *idx.shape, *tail)
        return torch.gather(seq, lead, idx)

    t = torch.arange(T, device=prev_seq.device)
    m = _time_mask(t < overlap[..., None], prev_seq)
    d = (aligned(prev_seq, overlap, T) - cur_seq) * m
    pos = 0.5 * _sum_after(d * d, lead)
    vel = torch.zeros_like(pos)
    if with_vel and T > 1:
        dprev = prev_seq.narrow(lead, 1, T - 1) \
            - prev_seq.narrow(lead, 0, T - 1)
        dcur = cur_seq.narrow(lead, 1, T - 1) - cur_seq.narrow(lead, 0, T - 1)
        mv = _time_mask(t[:-1] < overlap[..., None] - 1, dprev)
        dv = (aligned(dprev, overlap - 1, T - 1) - dcur) * mv
        vel = 0.5 * _sum_after(dv * dv, lead)
    return pos, vel


def _local_windows(num_windows: int, mesh) -> int:
    return num_windows if mesh is None else num_windows // mesh.size


def _with_next(c: torch.Tensor, seq_interval: torch.Tensor, mesh):
    """This rank's windows (K, Bl, ...) followed by the next rank's first
    -> (windows (K, Bl+1, ...), their intervals (Bl+1, 2), pair mask
    (Bl,)). The last rank has no next window: it pairs its last with its
    own first, which the mask drops."""
    Bl = c.shape[1]
    lo, last = mesh.rank * Bl, mesh.rank == mesh.size - 1
    firsts = P.all_gather_batch(mesh, c[:, :1], dim=1)       # (K, W, ...)
    nxt = mesh.rank if last else mesh.rank + 1
    ext = torch.cat([c, firsts[:, nxt:nxt + 1]], dim=1)
    rows = device_index(list(range(lo, lo + Bl)) + [lo if last else
                                                     lo + Bl],
                        seq_interval.device)
    valid = torch.ones(Bl, dtype=torch.bool, device=c.device)
    valid[-1] = not last
    return ext, seq_interval[rows], valid


def _on_first_rank(loss: torch.Tensor, mesh) -> torch.Tensor:
    """A term of global window 0: kept by the rank that holds it."""
    if mesh is None or mesh.rank == 0:
        return loss
    return torch.where(torch.zeros_like(loss, dtype=torch.bool), loss,
                       torch.zeros_like(loss))


def overlap_consist_loss(verts3d: torch.Tensor, seq_interval: torch.Tensor,
                         mesh=None) -> torch.Tensor:
    """Within-batch agreement of consecutive windows: position and
    velocity of the predicted keypoint vertices (K*B, T, V, 3) over the
    frames two windows share, from the untiled (B, 2) [start, end)
    intervals. Returns (K*B,), the pair (b, b+1) of each candidate on its
    row b. With `mesh`, B is this rank's share of the windows and
    `seq_interval` is the whole batch's."""
    B = seq_interval.shape[0]
    if B < 2:
        return verts3d.new_zeros(verts3d.shape[0])
    v = _candidates(verts3d, _local_windows(B, mesh))
    if mesh is not None:
        v, seq_interval, valid = _with_next(v, seq_interval, mesh)
    overlaps = (seq_interval[:-1, 1] - seq_interval[1:, 0]).long().expand(
        v.shape[0], v.shape[1] - 1)
    pos, vel = _masked_overlap_l2(v[:, :-1], v[:, 1:], overlaps,
                                  with_vel=True)
    if mesh is None:
        return _charge_pairs(pos + vel)
    return torch.where(valid, pos + vel, torch.zeros_like(pos)).reshape(-1)


def xbatch_overlap_loss(verts3d_first: torch.Tensor,
                        prev_verts3d: torch.Tensor, overlap: torch.Tensor
                        ) -> torch.Tensor:
    """Cross-batch version: each candidate's window 0 (K, T, V, 3) against
    the previous batch's cached last window (Tp, V, 3), which may be
    shorter than the overlap (a stage-3 sub-window). Frame i of window 0
    is frame Tp - overlap + i of the previous window, kept where that is
    in range: i < min(overlap, T) and i >= overlap - Tp. Returns (K,)."""
    Tp, T = prev_verts3d.shape[0], verts3d_first.shape[1]
    dev = verts3d_first.device
    overlap = torch.as_tensor(overlap, device=dev).long()
    t = torch.arange(T, device=dev)
    ov = torch.clamp(overlap, max=T)
    idx = torch.clamp(Tp - overlap + t, 0, Tp - 1)
    aligned_prev = prev_verts3d[idx][None]                      # (1, T, ..)
    valid = ((t < ov) & (t >= overlap - Tp))[None]
    d = (aligned_prev - verts3d_first) * _time_mask(valid, aligned_prev)
    loss = 0.5 * _sum_after(d * d, 1)
    if T > 1:
        dprev = aligned_prev[:, 1:] - aligned_prev[:, :-1]
        dcur = verts3d_first[:, 1:] - verts3d_first[:, :-1]
        mv = ((t[:-1] < ov - 1) & (t[:-1] >= overlap - Tp))[None]
        dv = (dprev - dcur) * _time_mask(mv, dprev)
        loss = loss + 0.5 * _sum_after(dv * dv, 1)
    return loss


def neighbour_l2_loss(x: torch.Tensor, num_windows: int, mesh=None,
                      seq_interval: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """0.5 * ||x[b] - x[b+1]||^2 of consecutive windows' per-window
    quantities (betas, floor plane), (K*B, ...) -> (K*B,) on row b. With
    `mesh` (and the whole batch's `seq_interval`, which only sizes the
    exchange), B is this rank's share of the num_windows windows."""
    if num_windows < 2:
        return x.new_zeros(x.shape[0])
    c = _candidates(x, _local_windows(num_windows, mesh))
    if mesh is not None:
        c, _, valid = _with_next(c, seq_interval, mesh)
    d = c[:, :-1] - c[:, 1:]
    pair = 0.5 * _sum_after(d * d, 2)
    if mesh is None:
        return _charge_pairs(pair)
    return torch.where(valid, pair, torch.zeros_like(pair)).reshape(-1)


def xbatch_l2_loss(x: torch.Tensor, prev: torch.Tensor, num_windows: int,
                   mesh=None) -> torch.Tensor:
    """0.5 * ||x[0] - prev||^2 of each candidate's window 0, on row 0 (of
    the rank holding window 0, with `mesh`)."""
    nb = _local_windows(num_windows, mesh)
    d = _candidates(x, nb)[:, 0] - prev
    return _charge_first(_on_first_rank(0.5 * _sum_after(d * d, 1), mesh),
                         nb)


def root_fit(cfg: EnergyConfig, w: StageWeights,
             observed: Dict[str, torch.Tensor],
             pred: Dict[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """Data terms (the stage-1 objective); `mesh` for windows split over
    ranks (see the module docstring)."""
    loss = torch.zeros(pred["joints3d"].shape[0], dtype=pred["joints3d"].dtype,
                       device=pred["joints3d"].device)
    if w.joints3d > 0 and "joints3d" in observed:
        loss = loss + w.joints3d * joints3d_loss(observed["joints3d"],
                                                 pred["joints3d"])
    if w.verts3d > 0 and "verts3d" in observed:
        loss = loss + w.verts3d * verts3d_loss(observed["verts3d"],
                                               pred["verts3d"])
    if w.points3d > 0 and "points3d" in observed:
        loss = loss + w.points3d * points3d_loss(cfg, observed["points3d"],
                                                 pred["points3d"])
    if (w.joints2d > 0 and "joints2d" in observed
            and "joints3d_extra" in pred):
        loss = loss + w.joints2d * joints2d_loss(
            cfg, observed["joints2d"], pred["joints3d"],
            pred["joints3d_extra"], observed["cam_f"],
            observed["cam_center"])
    if (w.rgb_overlap_consist > 0 and "seq_interval" in observed
            and "verts3d" in pred):
        iv = observed["seq_interval"]
        loss = loss + w.rgb_overlap_consist * overlap_consist_loss(
            pred["verts3d"], iv, mesh)
        if "prev_batch_overlap_res" in observed:
            prev = observed["prev_batch_overlap_res"]
            nb = _local_windows(iv.shape[0], mesh)
            first = _candidates(pred["verts3d"], nb)[:, 0]
            loss = loss + w.rgb_overlap_consist * _charge_first(
                _on_first_rank(xbatch_overlap_loss(
                    first, prev["verts3d"],
                    prev["seq_interval"][1] - iv[0, 0]), mesh), nb)
    return loss


def smpl_fit(cfg: EnergyConfig, w: StageWeights,
             observed: Dict[str, torch.Tensor],
             pred: Dict[str, torch.Tensor], nsteps: int,
             mesh=None) -> torch.Tensor:
    """Stage-2 objective: data + pose/shape priors + smoothness."""
    loss = root_fit(cfg, w, observed, pred, mesh)
    if w.pose_prior > 0 and "latent_pose" in pred:
        loss = loss + w.pose_prior * pose_prior_loss(pred["latent_pose"])
    if w.shape_prior > 0 and "betas" in pred:
        loss = loss + w.shape_prior * nsteps * shape_prior_loss(pred["betas"])
    if w.joints3d_smooth > 0:
        loss = loss + w.joints3d_smooth * joints3d_smooth_loss(
            pred["joints3d"])
    if (w.rgb_overlap_consist > 0 and "seq_interval" in observed
            and "betas" in pred):
        iv = observed["seq_interval"]
        loss = loss + w.rgb_overlap_consist * neighbour_l2_loss(
            pred["betas"], iv.shape[0], mesh, iv)
        if "prev_batch_overlap_res" in observed:
            loss = loss + w.rgb_overlap_consist * xbatch_l2_loss(
                pred["betas"], observed["prev_batch_overlap_res"]["betas"],
                iv.shape[0], mesh)
    return loss


def motion_fit(cfg: EnergyConfig, w: StageWeights,
               observed: Dict[str, torch.Tensor],
               pred: Dict[str, torch.Tensor],
               cam_pred: Dict[str, torch.Tensor], nsteps: int,
               gmm: Optional[gmm_lib.GmmParams] = None,
               cond_prior: Optional[Tuple] = None,
               init_motion_scale: float = 1.0,
               gmm_terms: Optional[Tuple] = None,
               mesh=None) -> torch.Tensor:
    """Stage-3 objective: the stage-2 terms on the camera-frame prediction
    `cam_pred`, the motion/init priors and the consistency and contact
    terms on the prior-frame `pred`, and the floor term."""
    loss = smpl_fit(cfg, w, observed, cam_pred, nsteps, mesh)
    if w.motion_prior > 0 and "latent_motion" in pred:
        loss = loss + w.motion_prior * motion_prior_loss(
            pred["latent_motion"], cond_prior)
    if w.init_motion_prior > 0 and gmm is not None and "joints_vel" in pred:
        loss = loss + w.init_motion_prior * init_motion_scale * \
            init_motion_prior_loss(gmm, pred["joints3d"][:, 0:1],
                                   pred["joints_vel"], pred["trans_vel"],
                                   pred["root_orient_vel"], gmm_terms)
    if w.joint_consistency > 0 and "joints3d_rollout" in pred:
        loss = loss + w.joint_consistency * joint_consistency_loss(
            pred["joints3d"], pred["joints3d_rollout"])
    if w.bone_length > 0 and "joints3d_rollout" in pred:
        loss = loss + w.bone_length * bone_length_loss(
            pred["joints3d_rollout"])
    if (w.joints3d_rollout > 0 and "joints3d" in observed
            and "joints3d_rollout" in pred):
        loss = loss + w.joints3d_rollout * joints3d_loss(
            observed["joints3d"], pred["joints3d_rollout"])
    if w.contact_vel > 0 and "contacts_conf" in pred:
        loss = loss + w.contact_vel * contact_vel_loss(
            pred["contacts_conf"], pred["joints3d"])
    if w.contact_height > 0 and "contacts_conf" in pred:
        loss = loss + w.contact_height * contact_height_loss(
            pred["contacts_conf"], pred["joints3d"])
    if (w.floor_reg > 0 and "floor_plane" in cam_pred
            and "floor_plane" in observed):
        loss = loss + w.floor_reg * nsteps * floor_reg_loss(
            cam_pred["floor_plane"], observed["floor_plane"])
    if (w.rgb_overlap_consist > 0 and "seq_interval" in observed
            and "floor_plane" in cam_pred):
        iv = observed["seq_interval"]
        loss = loss + w.rgb_overlap_consist * neighbour_l2_loss(
            cam_pred["floor_plane"], iv.shape[0], mesh, iv)
        if "prev_batch_overlap_res" in observed:
            fp = observed["prev_batch_overlap_res"]["floor_plane"]
            loss = loss + w.rgb_overlap_consist * xbatch_l2_loss(
                cam_pred["floor_plane"], fp[..., :3] * fp[..., 3:],
                iv.shape[0], mesh)
    return loss
