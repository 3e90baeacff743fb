"""In-repo model fixtures: a briefly trained mini HuMoR and VPoser on the
procedural synthetic-AMASS generator (port of humor_tpu/testing.py).

The accuracy checks (tests/test_torch_accuracy.py, chip_smoke.py) fit
held-out synthetic windows with these models and hold the recovered motion
to absolute MPJPE bounds. With random weights the stage-3 rollout cannot
represent motion and L-BFGS cannot invert a random 4x1024 MLP, so
accuracy is only well-posed against a trained prior; released checkpoints
cannot ship here.

The schedule, the batches and the optimizers are the JAX package's; the
random draws (initial weights, posterior noise, scheduled-sampling
choices) come from torch generators, since JAX's keys cannot be replayed
in torch. The trained weights therefore differ from the JAX fixture's;
its accuracy bounds hold for both, its numbers for neither.

    models = trained_tto_models(device="cpu")   # the card by default
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

SUP_BATCHES = 40        # supervised batches from seeds 0..39
SS_SEED, SS_BATCHES = 100, 20


def mini_humor_schedule(sup_steps: int, ss_steps: int, n_ss: int
                        ) -> List[Tuple]:
    """The curriculum of train_mini_humor, step by step: ("sup", batch
    index, epoch) then ("ss", batch index, epoch, use_gt_p), as the JAX
    fixture walks it (`n_ss` scheduled-sampling batches)."""
    steps = [("sup", i % SUP_BATCHES, min(i // 60, 5))
             for i in range(sup_steps)]
    steps += [("ss", (i * 7) % n_ss, 15, max(0.0, 1.0 - i / 100.0))
              for i in range(ss_steps)]
    return steps


def _batch(model, seed: int, batch: int, frames: int, device) -> Dict:
    """`frames` transitions of seeded synthetic windows; both genders
    skin the one synthetic body (the gender ids still select per row)."""
    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.data.windows import window_to_pairs

    world, meta = synthetic_world_batch(seed, batch, frames + 1,
                                        model=model, device=device)
    data_in, data_out, _ = window_to_pairs(world)
    return {"data_in": data_in, "data_out": data_out,
            "betas": meta["betas"],
            "gender_ids": meta["gender_ids"].long().to(device)}


def train_mini_humor(model, cfg, sup_steps: int = 300, ss_steps: int = 150,
                     batch: int = 48, frames: int = 10, ss_len: int = 10,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[Dict] = None,
                     draws: Optional[Callable[[int], Dict]] = None,
                     device="cuda") -> Dict:
    """Supervised then scheduled-sampling steps with the full SMPL losses
    (Adamax at 5e-4, milestones at 50 steps an epoch). The scheduled
    sampling runs on windows of `ss_len` transitions (seeds 100..119)
    when that differs from `frames`: the rollout horizon trained there
    sets the stage-3 rollout's stability. Initial weights from `params`
    or a CPU generator seeded 0; the posterior noise and the curriculum's
    choices from `draws(i)` for step i when given ({"eps"} for a
    supervised step, {"eps", "use_gt"} for a scheduled-sampling one, as
    the train steps take them), else from `generator` (default: seeded 1
    on the device). Returns the trained params (detached)."""
    from humor_torch.device import resolve_device
    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS

    dev = resolve_device(device)
    model = model.to(dev)
    opt = TS.make_optimizer(lr=5e-4, steps_per_epoch=50)
    if params is None:
        params = H.init_params(cfg, torch.Generator().manual_seed(0))
    state = TS.make_train_state(TS.tree_map(lambda p: p.to(dev), params),
                                opt)
    sup, ss, _ = TS.make_train_steps(cfg, LossConfig(), opt,
                                     {"male": model, "female": model})
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1)
    batches = [_batch(model, s, batch, frames, dev)
               for s in range(SUP_BATCHES)]
    ss_batches = (batches if ss_len == frames else
                  [_batch(model, SS_SEED + s, batch, ss_len, dev)
                   for s in range(SS_BATCHES)])
    schedule = mini_humor_schedule(sup_steps, ss_steps, len(ss_batches))
    for i, step in enumerate(schedule):
        given = draws(i) if draws is not None else {}
        given = {k: v.to(dev) if torch.is_tensor(v) else v
                 for k, v in given.items()}
        if step[0] == "sup":
            state, _ = sup(state, batches[step[1]], step[2],
                           generator=generator, **given)
        else:
            state, _ = ss(state, ss_batches[step[1]], step[2], step[3],
                          generator=generator, **given)
    return TS.tree_map(lambda p: p.detach(), state.params)


def vposer_training_poses(model, n_seqs: int = 64) -> torch.Tensor:
    """(n_seqs * 20, 63) aa body poses of the synthetic sequences of seed
    100, on the CPU."""
    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.ops import transforms

    world, _ = synthetic_world_batch(100, n_seqs, 20, model=model)
    return transforms.rotmat_to_aa(
        world["pose_body"].reshape(-1, 21, 3, 3)).reshape(-1, 63)


def train_mini_vposer(model, hidden: int = 96, steps: int = 800,
                      n_seqs: int = 64, params: Optional[Dict] = None,
                      device="cuda") -> Tuple:
    """Mini VPoser autoencoding the synthetic pose distribution: Adam at
    2e-3 on batches of 256 poses chosen by numpy's RandomState(0), as the
    JAX fixture chooses them. Every leaf trains, the BatchNorm statistics
    included, through the eval-mode encode and latent2pose (as in JAX).
    Initial weights from `params` or a CPU generator seeded 3. Returns
    (vposer_cfg, params).

    The fixture routes all body pose through latent2pose, so its
    round-trip error on GT poses (`vposer_roundtrip_mae`) bounds every
    stage-2/3 MPJPE from below."""
    from humor_torch.device import resolve_device
    from humor_torch.models import vposer as vp
    from humor_torch.train import step as TS

    dev = resolve_device(device)
    vcfg = vp.VPoserConfig(hidden=hidden)
    if params is None:
        params = vp.init_params(vcfg, torch.Generator().manual_seed(3))
    poses = vposer_training_poses(model, n_seqs).to(dev)
    opt = TS.Adam(lr=2e-3)
    state = TS.make_train_state(TS.tree_map(lambda p: p.to(dev), params),
                                opt)
    leaves = TS.tree_leaves(state.params)
    opt_state = state.opt_state
    rng = np.random.RandomState(0)
    for _ in range(steps):
        idx = rng.choice(poses.shape[0], 256, replace=False)
        loss = vp.train_loss(vcfg, state.params,
                             poses[torch.as_tensor(idx, device=dev)])
        grads = torch.autograd.grad(loss, leaves)
        opt_state = opt.update(list(grads), opt_state, state.params)
    return vcfg, TS.tree_map(lambda p: p.detach(), state.params)


@torch.no_grad()
def vposer_roundtrip_mae(vcfg, vparams, poses: torch.Tensor) -> float:
    """Mean absolute aa error (rad) of poses through encode's mean and
    latent2pose."""
    from humor_torch.models import vposer as vp

    poses = poses.to(vparams["dec_fc1"]["w"].device)
    rec = vp.latent2pose(vcfg, vparams, vp.pose2latent(vcfg, vparams, poses))
    return float(torch.mean(torch.abs(rec - poses)))


def trained_tto_models(sup_steps: int = 300, ss_steps: int = 150,
                       ss_len: int = 10, cache: Optional[str] = None,
                       vp_hidden: int = 96, vp_steps: int = 800,
                       vp_seqs: int = 64, device="cuda"):
    """TTOModels with the trained mini HuMoR and VPoser over the
    synthetic body (seed 1234, 256 vertices), on `device`.

    cache: an npz of {"humor", "vposer"} params, read when it exists (a
    file the JAX package's trained_tto_models(cache=...) wrote, or one
    written here: both use its checkpoint layout), else trained and
    written there."""
    from humor_torch import convert
    from humor_torch.body_model.smpl import synthetic_smpl_model
    from humor_torch.device import resolve_device
    from humor_torch.fitting.optimizer import TTOModels
    from humor_torch.models import humor as H
    from humor_torch.models import vposer as vp
    from humor_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    model = synthetic_smpl_model(device=dev)
    cfg = H.HumorConfig()
    vcfg = vp.VPoserConfig(hidden=vp_hidden)
    if cache and os.path.exists(cache):
        both = convert.load_checkpoint(cache, dev)["params"]
        return TTOModels(body=model, vposer_cfg=vcfg, vposer=both["vposer"],
                         humor_cfg=cfg, humor=both["humor"], init_gmm=None)
    humor = train_mini_humor(model, cfg, sup_steps=sup_steps,
                             ss_steps=ss_steps, ss_len=ss_len, device=dev)
    _, vparams = train_mini_vposer(model, hidden=vp_hidden, steps=vp_steps,
                                   n_seqs=vp_seqs, device=dev)
    if cache:
        ckpt.save_state(cache, {"humor": humor, "vposer": vparams})
    return TTOModels(body=model, vposer_cfg=vcfg, vposer=vparams,
                     humor_cfg=cfg, humor=humor, init_gmm=None)


# ---------------------------------------------------------------------------
# The synthetic-GT accuracy fits (tests/test_tto_accuracy.py's fixtures):
# held-out synthetic windows, corrupted, fitted by the full 3-stage TTO
# with the zoom line search, the recovered motion held to absolute MPJPE
# bounds. The bounds are the JAX test's (about 1.3x the JAX fixture's
# measured values, tests/test_tto_accuracy.py:11-19).
# ---------------------------------------------------------------------------

ACC_B, ACC_T = 2, 10
NOISE_STD = 0.02        # m, per coordinate
JOINTS3D_SEED, EQUIVARIANCE_SEED, RGB_SEED = 777, 778, 901
JOINTS3D_ITERS, RGB_ITERS = (15, 25, 40), (60, 100, 120)
RGB_OVERLAP, PIX_NOISE = 4, 2.0
# camera frame: x = world x, y = -world z (y down), z = world y
R_WC = np.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]],
                  np.float32)
# name: (bound, what must stay under it); tests/test_tto_accuracy.py lines
JOINTS3D_BOUNDS = {
    "vis_stage2_m": 0.13,                  # :153
    "vis_stage3_m": 0.14,                  # :154
    "vis_stage3_over_init_div20": 1.0,     # :155, stage 3 < init / 20
    "occ_stage3_m": 0.13,                  # :171
    "occ_stage3_over_0.6_stage2": 1.0,     # :172
    "betas_abs_max": 2.0,                  # :224
    "equivariance_err_m": 5e-3,            # :216
}
RGB_BOUNDS = {
    "vis_stage3_m": 0.23,                  # :398
    "vis_stage3_root_aligned_m": 0.21,     # :401
    "occ_stage3_m": 0.24,                  # :419
    "occ_stage3_over_stage2": 1.0,         # :420, stage 3 < stage 2
    "floor_cos_min_neg": -0.96,            # :437, cos > 0.96
    "floor_offset_err_m": 0.22,            # :438
}
# The RGB bounds that depend on the fit's absolute depth along the view
# ray, which a monocular fit pins only through the body-size prior and the
# floor. The JAX package's own fit on its own fixture misses each of them
# when its observation moves by less than 2.5e-4 px: visible 0.523 m,
# occluded 0.548 m and floor offset 0.99 m on this module's observation
# (rgb_case: the same construction, within 2.44e-4 px of JAX's), floor
# offset 0.926 m with the keypoints moved 1e-4 px, on the CPU
# (scripts/fixture_seed_study.py --jax --port-observation / --nudge-px).
# chip_smoke.py prints them beside their bounds and holds the rest,
# the floor normal's cosine too, which the nudged JAX fit misses by 2e-4
# (0.9598); tests/test_torch_accuracy.py holds all six on JAX's fixture
# and observation.
RGB_DEPTH_BOUNDS = ("vis_stage3_m", "occ_stage3_m", "floor_offset_err_m")


def _visible(T: int = ACC_T) -> np.ndarray:
    vis = np.ones(T, bool)
    vis[T // 3: 2 * T // 3] = False      # the occluded middle third
    return vis


def mpjpe(pred_joints, gt_joints, frame_mask, align_root=False) -> float:
    """Mean per-joint position error (m) over the frames in frame_mask."""
    p = np.asarray(pred_joints, np.float64)
    g = np.asarray(gt_joints, np.float64)
    p = p.reshape(g.shape)
    if align_root:
        p = p - p[:, :, :1]
        g = g - g[:, :, :1]
    return float(np.linalg.norm(p - g, axis=-1)[:, frame_mask].mean())


def misses(metrics: Dict[str, float], bounds: Dict[str, float]) -> List[str]:
    """The metrics at or over their bounds (a passing metric is strictly
    under, as the JAX test asserts)."""
    return [f"{k} {metrics[k]} >= {b}" for k, b in bounds.items()
            if not metrics[k] < b]


def _stage_joints(models, res, stage):
    from humor_torch.fitting import optimizer as O

    s = res.per_stage[stage]
    with torch.no_grad():
        return O.smpl_results(models.body, s["trans"], s["root_orient"],
                              s["pose_body"], s["betas"])["joints3d"].cpu()


def joints3d_case(models):
    """(TTOConfig, observation, GT joints (B, T, 22, 3)) of the joints3d
    accuracy fit: seed 777, 2 cm noise, the middle third at inf."""
    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O

    wt, _ = synthetic_world_batch(JOINTS3D_SEED, ACC_B, ACC_T,
                                  model=models.body)
    gt = wt["joints"].reshape(ACC_B, ACC_T, -1, 3).numpy()
    rng = np.random.RandomState(11)
    occ = gt + rng.randn(*gt.shape).astype(np.float32) * NOISE_STD
    occ[:, ~_visible()] = np.inf
    w1 = E.StageWeights(joints3d=1.0)
    w2 = E.StageWeights(joints3d=1.0, pose_prior=4e-4, shape_prior=6e-3,
                        joints3d_smooth=0.1)
    w3 = E.StageWeights(joints3d=1.0, pose_prior=4e-4, shape_prior=6e-3,
                        motion_prior=1e-4, joint_consistency=10.0,
                        bone_length=10.0, joints3d_rollout=0.1)
    cfg = O.TTOConfig(seq_len=ACC_T, stage_weights=(w1, w2, w3),
                      num_iters=JOINTS3D_ITERS, lbfgs_linesearch="zoom",
                      stage3_tune_init_num_frames=5,
                      stage3_freeze_start=10, stage3_freeze_end=20)
    return cfg, {"joints3d": torch.as_tensor(occ)}, gt


def rollout_equivariance_m(models, device) -> float:
    """Largest gap (m) between the stage-3 init rollout of a held-out
    window (seed 778) moved +5 m and that rollout moved +5 m
    (tests/test_tto_accuracy.py:175-216), through the runner's rollout."""
    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import vposer as vp
    from humor_torch.ops import transforms

    fm = O.prepare_models(models, device)
    m = fm.models
    wt, meta = synthetic_world_batch(EQUIVARIANCE_SEED, ACC_B, ACC_T,
                                     model=models.body, device=device)
    B, T = ACC_B, ACC_T
    root = transforms.rotmat_to_aa(wt["root_orient"].reshape(B, T, 3, 3))
    pose = transforms.rotmat_to_aa(
        wt["pose_body"].reshape(B, T, 21, 3, 3)).reshape(B, T, 63)
    betas = meta["betas"].to(device)

    @torch.no_grad()
    def roll(tr):
        zm = O.infer_latent_motion(m, tr, root, pose, betas, 30.0)
        tv, jv, rv = O.estimate_velocities(m.body, tr, root, pose, betas,
                                           30.0)
        lp = vp.pose2latent(m.vposer_cfg, m.vposer, pose)
        vars_ = {"trans": tr[:, :1], "root_orient": root[:, :1],
                 "latent_pose": lp[:, :1], "betas": betas,
                 "trans_vel": tv[:, :1], "joints_vel": jv[:, :1],
                 "root_orient_vel": rv[:, :1]}
        out, _ = O.rollout_latent_motion(m, fm.rollout_weights, vars_, zm)
        return out["joints"].cpu()

    off = torch.tensor([5.0, 5.0, 0.0], device=device)
    trans = wt["trans"]
    return float((roll(trans + off) - (roll(trans) + off.cpu())).abs().max())


def joints3d_accuracy(models, device="cuda") -> Tuple[Dict, Dict]:
    """The joints3d accuracy fit on `device`: (metrics, timings). The
    metrics are tests/test_tto_accuracy.py's (JOINTS3D_BOUNDS' names;
    the two ratio metrics are 1 at their bound)."""
    import time

    from humor_torch.device import resolve_device
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import vposer as vp

    dev = resolve_device(device)
    cfg, obs, gt = joints3d_case(models)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    res = O.make_runner(cfg, models, device=dev)(obs, timings=timings)
    timings["fit"] = time.perf_counter() - t0
    vis = _visible()
    body = models.body.to("cpu")
    with torch.no_grad():
        init = O.init_variables(cfg, models, ACC_B, obs, "cpu")
        pose0 = vp.latent2pose(models.vposer_cfg,
                               O._tree_to(models.vposer, "cpu"),
                               init["latent_pose"])
        j0 = O.smpl_results(body, init["trans"], init["root_orient"], pose0,
                            init["betas"])["joints3d"]
    j2 = _stage_joints(models, res, "stage2")
    j3 = _stage_joints(models, res, "stage3")
    init_m = mpjpe(j0, gt, vis)
    vis2, vis3 = mpjpe(j2, gt, vis), mpjpe(j3, gt, vis)
    occ2, occ3 = mpjpe(j2, gt, ~vis), mpjpe(j3, gt, ~vis)
    metrics = {
        "vis_init_m": init_m, "vis_stage2_m": vis2, "vis_stage3_m": vis3,
        "vis_stage3_over_init_div20": vis3 / (init_m / 20.0),
        "occ_stage2_m": occ2, "occ_stage3_m": occ3,
        "occ_stage3_over_0.6_stage2": occ3 / (0.6 * occ2),
        "betas_abs_max": float(res.final["betas"].abs().max()),
        "stage3_finite": bool(torch.isfinite(j3).all()),
        "equivariance_err_m": rollout_equivariance_m(models, dev),
    }
    if not metrics["stage3_finite"]:
        metrics["occ_stage3_m"] = float("inf")
    if not init_m > 1.0:        # tests/test_tto_accuracy.py:150
        metrics["vis_stage3_over_init_div20"] = float("inf")
    return metrics, timings


def rgb_case(models):
    """(TTOConfig, observation, GT joints (2, T, 22, 3), GT floor (4,)) of
    the RGB accuracy fit: one synthetic sequence (seed 901) moved ~3 m in
    front of a 500 px camera, two windows of 10 sharing 4, projected with
    2 px noise, the middle third of each window at zero confidence."""
    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import geometry as geo
    from humor_torch.fitting import optimizer as O
    from humor_torch.ops import transforms

    body = models.body.to("cpu")
    T, OV = ACC_T, RGB_OVERLAP
    Tt = 2 * T - OV
    wt, meta = synthetic_world_batch(RGB_SEED, 1, Tt, model=body)
    root_w = transforms.rotmat_to_aa(wt["root_orient"].reshape(1, Tt, 3, 3))
    pose_w = transforms.rotmat_to_aa(
        wt["pose_body"].reshape(1, Tt, 21, 3, 3)).reshape(1, Tt, 63)
    betas = meta["betas"]
    joints_w = wt["joints"].reshape(1, Tt, -1, 3).numpy()
    c = wt["trans"].numpy().mean(axis=(0, 1))
    t_wc = np.asarray([0.0, 0.0, 3.0], np.float32) - R_WC @ c
    R, t = torch.as_tensor(R_WC), torch.as_tensor(t_wc)
    with torch.no_grad():
        j0 = O.smpl_results(body, torch.zeros(1, 1, 3), torch.zeros(1, 1, 3),
                            torch.zeros(1, 1, 63), betas)["joints3d"][:, 0, 0]
        trans_c, root_c = geo.rigid_transform_smpl_params(
            wt["trans"], root_w, j0, R, t)
        jc = O.smpl_results(body, trans_c, root_c, pose_w,
                            betas)["joints3d"].numpy()
    iv = np.asarray([[0, T], [T - OV, 2 * T - OV]])
    win = lambda x: torch.cat([x[:, a:b] for a, b in iv], dim=0)
    gt_joints = np.stack([jc[0, a:b] for a, b in iv])
    z0 = float(joints_w[..., 2].min())
    n_c = R_WC @ np.asarray([0.0, 0.0, 1.0], np.float32)
    plane4 = np.concatenate([n_c, [z0 + float(n_c @ t_wc)]]).astype(
        np.float32)
    n_out = body.num_joints + body.vtx_joint_ids.size
    smpl2op = tuple(int(i % n_out) for i in range(25))
    cam_f = torch.tensor([[500.0, 500.0]]).repeat(2, 1)
    cam_center = torch.tensor([[320.0, 240.0]]).repeat(2, 1)
    with torch.no_grad():
        pred = O.smpl_results(body, win(trans_c), win(root_c), win(pose_w),
                              betas.repeat(2, 1))
        full = torch.cat([pred["joints3d"], pred["joints3d_extra"]], dim=2)
        op3d = full[:, :, list(smpl2op)].reshape(2 * T, -1, 3)
        uv = geo.perspective_projection(
            op3d, torch.eye(3).expand(2 * T, 3, 3), torch.zeros(2 * T, 3),
            cam_f.repeat_interleave(T, dim=0),
            cam_center.repeat_interleave(T, dim=0)).reshape(2, T, 25, 2)
    rng = np.random.RandomState(13)
    uv = uv.numpy() + rng.randn(2, T, 25, 2).astype(np.float32) * PIX_NOISE
    conf = np.ones((2, T, 25, 1), np.float32)
    vis = _visible()
    conf[:, ~vis] = 0.0
    uv[:, ~vis] = 0.0
    observed = {
        "joints2d": torch.as_tensor(np.concatenate([uv, conf], axis=-1)),
        "cam_f": cam_f, "cam_center": cam_center,
        "floor_plane": torch.as_tensor(plane4).repeat(2, 1),
        "seq_interval": torch.as_tensor(iv, dtype=torch.int32),
    }
    w1 = E.StageWeights(joints2d=0.001, joints3d_smooth=100.0,
                        rgb_overlap_consist=200.0)
    w2 = E.StageWeights(joints2d=0.001, pose_prior=4e-4, shape_prior=6e-3,
                        joints3d_smooth=100.0, rgb_overlap_consist=200.0)
    w3 = E.StageWeights(joints2d=0.001, pose_prior=4e-4, shape_prior=6e-3,
                        motion_prior=1e-4, joint_consistency=10.0,
                        bone_length=10.0, contact_vel=100.0,
                        contact_height=10.0, floor_reg=0.167,
                        rgb_overlap_consist=200.0)
    cfg = O.TTOConfig(seq_len=T, stage_weights=(w1, w2, w3),
                      energy=E.EnergyConfig(smpl2op_map=smpl2op),
                      num_iters=RGB_ITERS, lbfgs_linesearch="zoom",
                      optim_floor=True, stage3_tune_init_num_frames=5,
                      stage3_freeze_start=40, stage3_freeze_end=80)
    return cfg, observed, gt_joints, plane4


def rgb_accuracy(models, device="cuda") -> Tuple[Dict, Dict]:
    """The RGB accuracy fit on `device`: (metrics, timings), the metrics
    named as RGB_BOUNDS (the floor's cosine negated so that every bound
    is an upper one; the ratio is 1 at its bound)."""
    import time

    from humor_torch.device import resolve_device
    from humor_torch.fitting import optimizer as O

    dev = resolve_device(device)
    cfg, obs, gt, plane4 = rgb_case(models)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    res = O.make_runner(cfg, models, device=dev)(obs, timings=timings)
    timings["fit"] = time.perf_counter() - t0
    vis = _visible()
    j2 = _stage_joints(models, res, "stage2")
    j3 = _stage_joints(models, res, "stage3")
    occ2, occ3 = mpjpe(j2, gt, ~vis), mpjpe(j3, gt, ~vis)
    fitted = res.final["floor_plane"].cpu().numpy()
    cos = np.sum(fitted[..., :3] * plane4[:3], axis=-1)
    metrics = {
        "vis_stage2_m": mpjpe(j2, gt, vis),
        "vis_stage3_m": mpjpe(j3, gt, vis),
        "vis_stage3_root_aligned_m": mpjpe(j3, gt, vis, align_root=True),
        "occ_stage2_m": occ2, "occ_stage3_m": occ3,
        "occ_stage3_over_stage2": occ3 / occ2,
        "floor_cos": cos.tolist(),
        "floor_cos_min_neg": -float(cos.min()),
        "floor_offset_err_m": float(np.abs(fitted[..., 3] - plane4[3]).max()),
    }
    if not np.isfinite(occ3):
        metrics["occ_stage3_m"] = float("inf")
    return metrics, timings
