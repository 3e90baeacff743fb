"""Test-time-optimization CLI for video inputs (port of
humor_tpu/fitting/cli.py):

    python -m humor_torch.fitting.cli @configs/fit_rgb_demo_no_split.cfg \
        [--device cpu]

`--data-type` RGB (a folder of OpenPose JSONs, optional person masks),
PROX-RGB / PROX-RGBD (a PROX recording, with depth clouds for RGBD) or
iMapper-RGB (an i3DB scene). The camera and the floor come from the
data: RGB's from --rgb-intrinsics (else the RGB loader's default camera)
and the RGB loader's default ground plane, as in the JAX CLI; PROX's from its calibration
and, for the floor, a RANSAC fit to the scene in the recording's depth
images (ProxDataset.scene_floor_plane); iMapper's from --rgb-intrinsics,
which it requires, and the scene's annotated floor-contact boxes. A
PROX or iMapper input without them raises. All windows of the video are fitted as one
batch, tied by the overlap-consistency terms, then saved per stage and
stitched into one sequence. The fit runs on the card unless `--device
cpu` is given; asking for the card without one raises. AMASS joint
fitting (the JAX package's data/fit_dataset.py over this package's
training data pipeline) is not ported yet (ROADMAP A6). Missing
checkpoints fall back to a synthetic body and random weights from fixed
seeds.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

VIDEO_TYPES = ("RGB", "PROX-RGB", "PROX-RGBD", "iMapper-RGB")


def load_body(smplh_root: str):
    """The neutral SMPL+H body under `smplh_root`, else the synthetic
    one (seed 1234, the JAX package's default body)."""
    from humor_torch.body_model import smpl as S

    neutral = S.find_model_path(smplh_root, "neutral")
    if os.path.exists(neutral):
        return S.load_smpl_npz(neutral, use_vtx_selector=True)
    print(f"[body] no body model at {neutral!r}; using synthetic")
    return S.synthetic_smpl_model()


def load_models(cfg):
    """TTOModels from the checkpoints the config names, each falling back
    to seeded random weights (HuMoR seed 2, VPoser seed 1) when absent;
    on the CPU (the runner moves them to its device)."""
    from humor_torch import convert
    from humor_torch.fitting.optimizer import TTOModels
    from humor_torch.models import humor as H
    from humor_torch.models import vposer as vp
    from humor_torch.utils import import_torch as IT

    if cfg.model_compute_dtype:
        raise NotImplementedError(
            "humor_torch runs the HuMoR MLPs in float32 only "
            f"(--model-compute-dtype {cfg.model_compute_dtype!r})")
    body = load_body(cfg.smplh_root)
    hcfg = H.HumorConfig()
    if cfg.humor_ckpt and os.path.exists(cfg.humor_ckpt):
        if cfg.humor_ckpt.endswith((".pth", ".pt")):
            humor_params = IT.load_humor_checkpoint(cfg.humor_ckpt)
        else:
            humor_params = convert.load_checkpoint(cfg.humor_ckpt)["params"]
    else:
        print("[fit] no HuMoR checkpoint; using random init")
        humor_params = H.init_params(hcfg, torch.Generator().manual_seed(2))
    vcfg = vp.VPoserConfig()
    if cfg.vposer_ckpt and os.path.exists(cfg.vposer_ckpt):
        vposer_params = IT.load_vposer_checkpoint(cfg.vposer_ckpt)
    else:
        print("[fit] no VPoser checkpoint; using random init")
        vposer_params = vp.init_params(vcfg, torch.Generator().manual_seed(1))
    gmm = None
    if (cfg.init_motion_prior_ckpt
            and os.path.exists(cfg.init_motion_prior_ckpt)):
        gmm = IT.load_gmm_checkpoint(cfg.init_motion_prior_ckpt)
    return TTOModels(body=body, vposer_cfg=vcfg, vposer=vposer_params,
                     humor_cfg=hcfg, humor=humor_params, init_gmm=gmm)


def main(argv=None):
    from humor_torch.device import resolve_device
    from humor_torch.utils.config import FitCLIConfig, parse_into

    cfg = parse_into(FitCLIConfig, argv, prog="humor-torch-fit")
    dev = resolve_device(cfg.device)
    if cfg.data_type == "AMASS":
        raise NotImplementedError(
            "--data-type AMASS (observations from AMASS sequences, the "
            "JAX package's data/fit_dataset.py) is not ported yet (ROADMAP "
            "A6); the video types are " + ", ".join(VIDEO_TYPES))
    if cfg.data_type not in VIDEO_TYPES:
        raise NotImplementedError(f"unknown data type {cfg.data_type!r}")
    os.makedirs(cfg.out, exist_ok=True)
    return _run_rgb(cfg, load_models(cfg), dev)


def _smpl2op_for(body) -> tuple:
    """smpl->openpose map valid for the loaded body: the real table for a
    full SMPL+H (52 joints + 21 extra vertex joints), a modulo stand-in
    for synthetic test bodies."""
    from humor_torch.body_model import constants as C

    n_out = body.num_joints + body.vtx_joint_ids.size
    table = C.smpl_to_openpose("smplh", use_hands=False)
    if int(table.max()) < n_out:
        return tuple(int(i) for i in table)
    return tuple(int(i % n_out) for i in range(C.OP_NUM_JOINTS))


def _intrinsics(path: str) -> Optional[np.ndarray]:
    if not path:
        return None
    with open(path) as f:
        return np.asarray(json.load(f), np.float32)


def _run_rgb(cfg, models, device):
    """RGB / PROX / iMapper fitting: all overlapping windows of a video in
    one batch with the overlap terms, then the saves and the stitching."""
    from humor_torch.data.rgb import RGBVideoConfig, RGBVideoDataset
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O
    from humor_torch.fitting import results as R

    prox_gt = None
    if cfg.data_type.startswith("PROX"):
        from humor_torch.data.prox import ProxConfig, ProxDataset

        ds = ProxDataset(
            cfg.data_path,
            os.path.join(os.path.dirname(cfg.data_path.rstrip("/")),
                         "..", "calibration"),
            ProxConfig(seq_len=cfg.seq_len,
                       use_depth=cfg.data_type == "PROX-RGBD",
                       load_fitting=cfg.prox_load_fitting),
            fitting_root=cfg.prox_fitting_root or None)
        observed = ds.observation_batch()
        if "cam_f" not in observed:
            raise ValueError(f"no PROX calibration (Color.json) for "
                             f"{cfg.data_path!r}")
        observed["floor_plane"] = np.tile(
            ds.scene_floor_plane(), (observed["joints2d"].shape[0], 1))
        prox_gt = ds.fitting_batch()
    elif cfg.data_type == "iMapper-RGB":
        from humor_torch.data.imapper import IMapperConfig, IMapperDataset

        cam = _intrinsics(cfg.rgb_intrinsics)
        if cam is None:
            raise ValueError("iMapper-RGB needs the camera's intrinsics: "
                             "pass --rgb-intrinsics (a 3x3 JSON matrix)")
        ds = IMapperDataset(cfg.data_path,
                            IMapperConfig(seq_len=cfg.seq_len), cam_mat=cam)
        observed, _ = ds.observation_batch()
        if "floor_plane" not in observed:
            raise ValueError(
                f"no floor for {cfg.data_path!r}: iMapper-RGB fits it to "
                "the scene's annotated floor-contact boxes (gt/*.json)")
    else:
        ds = RGBVideoDataset(
            cfg.data_path,
            RGBVideoConfig(
                seq_len=0 if cfg.rgb_no_split else cfg.seq_len,
                overlap_len=cfg.overlap_len),
            cam_mat=_intrinsics(cfg.rgb_intrinsics),
            mask_path=(cfg.mask_path or None) if cfg.mask_joints2d
            else None)
        observed = ds.observation_batch()

    weights = cfg.stage_weights()
    if all(w.joints2d == 0 for w in weights):
        weights = (
            E.StageWeights(joints2d=0.001),
            E.StageWeights(joints2d=0.001, pose_prior=4e-4,
                           shape_prior=6e-3, joints3d_smooth=100.0,
                           rgb_overlap_consist=200.0),
            E.StageWeights(joints2d=0.001, pose_prior=4e-4,
                           shape_prior=6e-3, motion_prior=7.5e-4,
                           init_motion_prior=7.5e-4,
                           joint_consistency=100.0, bone_length=2000.0,
                           contact_vel=100.0, contact_height=10.0,
                           floor_reg=0.167, rgb_overlap_consist=200.0),
        )
    T = observed["joints2d"].shape[1]
    tto_cfg = O.TTOConfig(
        seq_len=T,
        stage_weights=weights,
        energy=E.EnergyConfig(robust_loss=cfg.robust_loss,
                              joints2d_sigma=cfg.joint2d_sigma,
                              smpl2op_map=_smpl2op_for(models.body)),
        num_iters=tuple(int(n) * cfg.num_iters_scale
                        for n in cfg.num_iters),
        lbfgs_max_linesearch=cfg.lbfgs_max_iter,
        lbfgs_linesearch=cfg.lbfgs_linesearch,
        lbfgs_polish_frac=cfg.lbfgs_polish_frac,
        lbfgs_candidates=cfg.lbfgs_candidates or None,
        lbfgs_tol_grad=cfg.lbfgs_tol_grad or None,
        lbfgs_tol_change=cfg.lbfgs_tol_change or None,
        lbfgs_stall_patience=cfg.lbfgs_stall_patience,
        optim_floor=True,
        stage3_tune_init_state=not cfg.stage3_no_tune_init_state,
        stage3_tune_init_num_frames=cfg.stage3_tune_init_num_frames,
        stage3_freeze_start=cfg.stage3_freeze_start * cfg.num_iters_scale,
        stage3_freeze_end=cfg.stage3_freeze_end * cfg.num_iters_scale)

    obs = {k: torch.as_tensor(v) for k, v in observed.items()}
    t0 = time.time()
    stage_s = {}
    res = O.run(tto_cfg, models, obs, device=device, timings=stage_s)
    print(f"[fit] video optimized in {time.time()-t0:.1f}s "
          f"({observed['joints2d'].shape[0]} windows x {T} frames); stage "
          f"seconds {json.dumps(stage_s)}")

    if cfg.save_results:
        R.save_stage_results(cfg.out, "final", res.final)
        R.save_observations(cfg.out, observed, gt=prox_gt)
        has_floor = "floor_plane" in res.final
        if cfg.save_stages_results:
            for sname, sres in res.per_stage.items():
                R.save_stage_results(cfg.out, sname, sres)
            if has_floor:
                # stage-2 results re-expressed with the final floor
                R.save_prior_stage_results(
                    cfg.out, "stage2", res.per_stage["stage2"],
                    models.body, res.final["floor_plane"].cpu().numpy(),
                    device=device)
        if has_floor:
            # per-window prior-frame final result, from the rollout
            prior3 = {"trans": res.final["prior_trans"],
                      "root_orient": res.final["prior_root_orient"],
                      "pose_body": res.final["pose_body"],
                      "betas": res.final["betas"]}
            if "contacts" in res.final:
                prior3["contacts"] = res.final["contacts"]
            R.save_stage_results(cfg.out, "final", prior3,
                                 fname="final_results_prior.npz")
        stitched = R.save_stitched_result(
            cfg.out, res.final, observed,
            body=models.body if has_floor else None, device=device)
        print(f"[fit] wrote stitched result "
              f"({stitched['trans'].shape[0]} frames)")
    return res


if __name__ == "__main__":
    main()
