"""Fit-result visualization over RGB frames (port of
humor_tpu/viz/fitting.py): project the fitted skeleton with the camera
intrinsics and overlay it on the video frames (or a blank canvas when
frames are unavailable), and rasterize the fitted mesh.

    python -m humor_torch.viz.fitting --results ./out/fit \
        --out ./out/fit_viz [--frames DIR] [--intrinsics JSON] [--device cpu]

The meshes are skinned with the port's SMPL on the card unless `--device
cpu` is given; drawing is host-only (matplotlib, PIL).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

import torch

from humor_torch.viz.utils import SMPL_BONES, create_video


def project_to_image(points3d: np.ndarray, cam_f: Sequence[float],
                     cam_center: Sequence[float]) -> np.ndarray:
    """(..., 3) camera-frame points -> (..., 2) pixels (pinhole)."""
    z = np.maximum(np.abs(points3d[..., 2:3]), 1e-9) \
        * np.sign(points3d[..., 2:3] + 1e-12)
    uv = points3d[..., :2] / z
    return uv * np.asarray(cam_f) + np.asarray(cam_center)


def overlay_skeleton_frames(
    joints3d: np.ndarray,          # (T, J, 3) camera frame
    cam_f: Sequence[float],
    cam_center: Sequence[float],
    out_dir: str,
    img_paths: Optional[Sequence[str]] = None,
    img_size: tuple = (1920, 1080),
    joints2d_obs: Optional[np.ndarray] = None,  # (T, 25, 3) observations
    make_video: bool = True,
) -> List[str]:
    """Render per-frame overlays of the fitted skeleton (and observed 2D
    keypoints) on the video frames."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    uv = project_to_image(joints3d, cam_f, cam_center)  # (T, J, 2)
    paths = []
    for t in range(joints3d.shape[0]):
        fig, ax = plt.subplots(figsize=(8, 4.5))
        if img_paths is not None and t < len(img_paths) \
                and os.path.exists(img_paths[t]):
            from PIL import Image

            im = np.asarray(Image.open(img_paths[t]))
            ax.imshow(im)
            w, h = im.shape[1], im.shape[0]
        else:
            w, h = img_size
            ax.set_facecolor("black")
        for p, c in SMPL_BONES:
            ax.plot([uv[t, p, 0], uv[t, c, 0]],
                    [uv[t, p, 1], uv[t, c, 1]], c="#2ca02c", lw=2)
        ax.scatter(uv[t, :, 0], uv[t, :, 1], c="#2ca02c", s=8)
        if joints2d_obs is not None:
            conf = joints2d_obs[t, :, 2]
            vis = conf > 0
            ax.scatter(joints2d_obs[t, vis, 0], joints2d_obs[t, vis, 1],
                       c="#d62728", s=10, marker="x")
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
        ax.set_axis_off()
        path = os.path.join(out_dir, f"overlay_{t:06d}.png")
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    if make_video:
        create_video(out_dir, os.path.join(out_dir, "overlay.mp4"),
                     pattern="overlay_%06d.png")
    return paths


def viz_stitched_result(stitched_npz: str, out_dir: str,
                        body=None, cam_f=(1060.5, 1060.4),
                        cam_center=(960.0, 540.0),
                        max_frames: int = 120,
                        img_paths: Optional[Sequence[str]] = None,
                        mesh: bool = True,
                        joints2d_obs: Optional[np.ndarray] = None,
                        img_size: tuple = (1920, 1080),
                        device="cuda") -> List[str]:
    """Load a stitched fitting result and render it over the video frames.

    With a body model the fitted MESH is rasterized (shaded, floor
    checkerboard, contacts colored; skinned on `device`) in addition to
    skeleton overlays; without one, the stored rollout joints give
    skeleton overlays only."""
    data = dict(np.load(stitched_npz))
    T = min(data["trans"].shape[0], max_frames)
    paths: List[str] = []
    if body is not None:
        from humor_torch.device import resolve_device
        from humor_torch.fitting.optimizer import smpl_results

        dev = resolve_device(device)
        betas = np.asarray(data["betas"])
        if betas.ndim == 2:
            # stitched results carry per-frame betas (window-constant);
            # skin with the first frame's
            betas = betas[0]
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=dev)[None]
        with torch.no_grad():
            pred = smpl_results(
                body.to(dev), t(data["trans"][:T]),
                t(data["root_orient"][:T]), t(data["pose_body"][:T]),
                t(betas), verts="full" if mesh else "none")
        pred = {k: v.cpu().numpy() for k, v in pred.items()}
        joints = pred["joints3d"][0]
        if mesh and body.faces is not None and "points3d" in pred:
            from humor_torch.viz.raster import render_mesh_over_frames

            verts = pred["points3d"][0]  # (T, V, 3)
            contact_verts = None
            if "contacts" in data:
                # per-joint contacts -> the verts each joint dominates
                w = body.lbs_weights.cpu().numpy()     # (V, J)
                cj = np.asarray(data["contacts"][:T])  # (T, J)
                nj = min(cj.shape[1], w.shape[1])
                contact_verts = (cj[:, :nj] @ w[:, :nj].T) > 0.5
            floor = data.get("floor_plane")
            if floor is not None:
                floor = np.asarray(floor).reshape(-1, 4)[0]
            paths += render_mesh_over_frames(
                verts, np.asarray(body.faces), cam_f, cam_center,
                os.path.join(out_dir, "mesh"), img_paths=img_paths,
                img_size=img_size, floor_plane=floor,
                contact_verts=contact_verts)
    elif "joints3d_rollout" in data:
        joints = np.asarray(data["joints3d_rollout"][:T])
    else:
        raise ValueError("need a body model or stored rollout joints")
    if joints2d_obs is not None:
        joints2d_obs = np.asarray(joints2d_obs)[:T]
    paths += overlay_skeleton_frames(joints, cam_f, cam_center, out_dir,
                                     img_paths=img_paths,
                                     img_size=img_size,
                                     joints2d_obs=joints2d_obs)
    return paths


def _frame_paths(frames_dir: str) -> Optional[List[str]]:
    if not frames_dir or not os.path.isdir(frames_dir):
        return None
    exts = (".png", ".jpg", ".jpeg")
    return sorted(os.path.join(frames_dir, f)
                  for f in os.listdir(frames_dir)
                  if f.lower().endswith(exts))


def _obs_joints2d(seq_dir: str) -> Optional[np.ndarray]:
    p = os.path.join(seq_dir, "observations.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as obs:
        if "joints2d" not in obs:
            return None
        return np.asarray(obs["joints2d"])


def main(argv=None) -> List[str]:
    """Render fitting results over the source video: the stitched final
    result, the per-window sub-sequence results, and optionally the
    prior-frame (HuMoR canonical) views and observed 2D keypoints."""
    from humor_torch.device import resolve_device
    from humor_torch.fitting.cli import load_body
    from humor_torch.utils.config import VizCLIConfig, parse_into

    cfg = parse_into(VizCLIConfig, argv, prog="humor-torch-viz")
    resolve_device(cfg.device)
    if not cfg.results or not os.path.isdir(cfg.results):
        raise SystemExit(f"--results dir not found: {cfg.results!r}")
    os.makedirs(cfg.out, exist_ok=True)
    body = load_body(cfg.smplh_root)

    cam_f, cam_center = (1060.5, 1060.4), (960.0, 540.0)
    if cfg.intrinsics:
        import json

        with open(cfg.intrinsics) as f:
            m = np.asarray(json.load(f), np.float32)
        cam_f, cam_center = (m[0, 0], m[1, 1]), (m[0, 2], m[1, 2])

    img_paths = _frame_paths(cfg.frames)
    img_size = (cfg.render_width, cfg.render_height)
    mesh = not cfg.viz_no_mesh
    written: List[str] = []

    def render(npz_path: str, out_dir: str, frames, obs2d):
        if not os.path.exists(npz_path):
            return
        print(f"[viz] {npz_path} -> {out_dir}")
        written.extend(viz_stitched_result(
            npz_path, out_dir, body=body, cam_f=cam_f,
            cam_center=cam_center, max_frames=cfg.max_frames,
            img_paths=frames, mesh=mesh, joints2d_obs=obs2d,
            img_size=img_size, device=cfg.device))

    fr = os.path.join(cfg.results, "final_results")
    obs2d = _obs_joints2d(fr) if cfg.viz_obs_2d else None
    render(os.path.join(fr, "stage3_results.npz"),
           os.path.join(cfg.out, "final_results"), img_paths, obs2d)
    if cfg.viz_prior_frame:
        # canonical-frame view: no video frames behind it
        render(os.path.join(fr, "stage3_results_prior.npz"),
               os.path.join(cfg.out, "final_results_prior"), None, None)

    if not cfg.viz_final_only:
        for name in sorted(os.listdir(cfg.results)):
            seq_dir = os.path.join(cfg.results, name)
            npz = os.path.join(seq_dir, "final_results.npz")
            if name == "final_results" or not os.path.exists(npz):
                continue
            frames = img_paths
            if frames is not None:
                # align this window with its source-frame interval
                p = os.path.join(seq_dir, "observations.npz")
                if os.path.exists(p):
                    with np.load(p) as obs:
                        if "seq_interval" in obs:
                            s, e = (int(v) for v in obs["seq_interval"])
                            frames = img_paths[s:e]
            obs2d = _obs_joints2d(seq_dir) if cfg.viz_obs_2d else None
            render(npz, os.path.join(cfg.out, name), frames, obs2d)
            if cfg.viz_prior_frame:
                render(os.path.join(seq_dir, "final_results_prior.npz"),
                       os.path.join(cfg.out, f"{name}_prior"), None, None)

    print(f"[viz] wrote {len(written)} frames under {cfg.out}")
    return written


if __name__ == "__main__":
    main()
