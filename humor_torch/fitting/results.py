"""Fit results on the host (port of humor_tpu/fitting/results.py):
per-stage npz files, the prior-frame re-expression, and the stitching of
a video's overlapping windows into one sequence.

The npz layouts are the JAX module's: <seq>/<stage>_results.npz with
betas/trans/root_orient/pose_body (+ contacts/floor_plane),
<seq>/observations.npz, <seq>/<stage>_results_prior.npz, and for a whole
video final_results/{stage3_results,observations,stage3_results_prior}
.npz. Only `to_prior_frame` computes with torch, through the port's
SMPL and fitting/geometry.py, on the card unless the caller passes
device="cpu"; it and the writers that call it return or save numpy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _np(v):
    """numpy view of an array or a (CPU or CUDA) tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_stage_results(out_dir: str, stage_name: str,
                       results: Dict[str, np.ndarray],
                       batch_names: Optional[Sequence[str]] = None,
                       fname: Optional[str] = None) -> None:
    """Save one stage's per-sequence results: out_dir/<seq>/<stage>_results
    .npz with keys betas/trans/root_orient/pose_body (+contacts/floor).
    `fname` overrides the file name (e.g. 'stage3_results_prior.npz')."""
    B = _np(results["trans"]).shape[0]
    names = batch_names or [f"seq_{i:03d}" for i in range(B)]
    fname = fname or f"{stage_name}_results.npz"
    for b, name in enumerate(names):
        seq_dir = os.path.join(out_dir, name)
        os.makedirs(seq_dir, exist_ok=True)
        save = {k: _np(v)[b] for k, v in results.items()
                if hasattr(v, "shape") and _np(v).shape[:1] == (B,)}
        np.savez(os.path.join(seq_dir, fname), **save)


def save_observations(out_dir: str, observed: Dict[str, np.ndarray],
                      gt: Optional[Dict[str, np.ndarray]] = None,
                      batch_names: Optional[Sequence[str]] = None) -> None:
    """Persist the observations (and GT when known) beside the results."""
    ref = next(v for v in observed.values() if hasattr(v, "shape"))
    B = _np(ref).shape[0]
    names = batch_names or [f"seq_{i:03d}" for i in range(B)]
    for b, name in enumerate(names):
        seq_dir = os.path.join(out_dir, name)
        os.makedirs(seq_dir, exist_ok=True)
        obs = {k: _np(v)[b] for k, v in observed.items()
               if hasattr(v, "shape") and _np(v).shape[:1] == (B,)}
        np.savez(os.path.join(seq_dir, "observations.npz"), **obs)
        if gt is not None:
            g = {k: _np(v)[b] for k, v in gt.items()
                 if v is not None and hasattr(v, "shape")
                 and _np(v).shape[:1] == (B,)}
            np.savez(os.path.join(seq_dir, "gt_results.npz"), **g)


def seq_overlaps_of(seq_intervals: np.ndarray) -> np.ndarray:
    """Per-window overlap-with-previous frame counts: overlaps[0] = 0,
    overlaps[i] = max(0, prev_end - cur_start)."""
    iv = np.asarray(seq_intervals)
    out = [0]
    for i in range(len(iv) - 1):
        # a gap between consecutive windows (prev_end < cur_start) is not
        # an overlap — clamping at 0 keeps every frame of the new window
        # instead of silently duplicating its tail via a negative slice;
        # the splitter never produces gaps, but hand-built intervals can
        out.append(max(0, int(iv[i, 1] - iv[i + 1, 0])))
    return np.asarray(out, np.int64)


def stitch_windows(results: Dict[str, np.ndarray],
                   seq_intervals: np.ndarray) -> Dict[str, np.ndarray]:
    """De-overlap and concatenate a batch of overlapping sub-sequence
    windows into one full sequence. results components (B, T, ...);
    seq_intervals (B, 2) [start, end) frame labels.

      * each new window drops its first `overlap` frames, so overlapping
        frames keep the earlier window's estimate;
      * per-window `betas` are expanded per frame and concatenated with
        the same de-overlap, so the stitched betas vary across window
        boundaries;
      * `floor_plane` (and any other per-window quantity) is taken from
        the first window.
    """
    B, T = _np(results["trans"]).shape[:2]
    iv = np.asarray(seq_intervals)
    ov = seq_overlaps_of(iv)
    out: Dict[str, np.ndarray] = {}
    for k, v in results.items():
        v = _np(v)
        if v.ndim >= 2 and v.shape[:2] == (B, T):
            out[k] = np.concatenate(
                [v[b, ov[b]:] for b in range(B)], axis=0)
        elif k == "betas" and v.ndim == 2 and v.shape[0] == B:
            per_frame = np.repeat(v[:, None], T, axis=1)   # (B, T, nb)
            out[k] = np.concatenate(
                [per_frame[b, ov[b]:] for b in range(B)], axis=0)
        elif v.ndim >= 1 and v.shape[:1] == (B,):
            out[k] = v[0]
        else:
            out[k] = v
    return out


def stitch_observations(observed: Dict[str, np.ndarray],
                        seq_intervals: np.ndarray,
                        time_indexed_keys: Sequence[str] = ("joints2d",)
                        ) -> Dict[str, np.ndarray]:
    """De-overlap the observation windows the same way."""
    ref = next(v for k, v in observed.items() if k in time_indexed_keys
               and hasattr(v, "shape"))
    B = _np(ref).shape[0]
    ov = seq_overlaps_of(seq_intervals)
    out: Dict[str, np.ndarray] = {}
    for k in time_indexed_keys:
        if k not in observed:
            continue
        v = _np(observed[k])
        out[k] = np.concatenate([v[b, ov[b]:] for b in range(B)], axis=0)
    return out


def _floor_plane_3d(floor_plane: np.ndarray) -> np.ndarray:
    """Accept the optimization-form 3-vector n*d or the parsed 4-vector
    (unit normal, offset) and return the 3-vector form that
    geometry.compute_cam2prior expects."""
    fp = _np(floor_plane).reshape(-1)
    if fp.shape[0] == 4:
        return fp[:3] * fp[3]
    return fp


def to_prior_frame(stitched: Dict[str, np.ndarray], body,
                   floor_plane: Optional[np.ndarray] = None,
                   key_frame_idx: int = 0,
                   device="cuda") -> Dict[str, np.ndarray]:
    """Re-express a (stitched) camera-frame SMPL sequence in the canonical
    prior frame defined by one cam2prior transform computed at
    `key_frame_idx` from `floor_plane` (for a stitched video: the first
    window's floor and frame 0; for one window: its final floor).

    stitched: trans (T, 3), root_orient (T, 3), pose_body (T, 63), betas
    (T, nb) or (nb,) [+ contacts, carried through]. Returns the same dict
    with trans/root_orient transformed (numpy); pose_body/betas/contacts
    unchanged. The SMPL forward and cam2prior run on `device`.
    """
    from humor_torch.body_model import smpl as smpl_lib
    from humor_torch.device import resolve_device
    from humor_torch.fitting import geometry as geo

    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    trans = f32(_np(stitched["trans"]))
    root_orient = f32(_np(stitched["root_orient"]))
    pose_body = f32(_np(stitched["pose_body"]))
    T = trans.shape[0]
    betas = _np(stitched["betas"])
    if betas.ndim == 1:
        betas_seq = np.repeat(betas[None], T, axis=0)
    else:
        betas_seq = betas
    betas_seq = f32(betas_seq)
    if floor_plane is None:
        floor_plane = stitched["floor_plane"]
    fp3 = f32(_floor_plane_3d(floor_plane))[None]
    body = body.to(dev)

    def smpl_joints(tr, ro, bp, bt):   # per-frame batches -> (N, J, 3)
        return smpl_lib.forward(
            body, ro, bp, bt, tr,
            vert_ids=np.zeros((0,), np.int64)).Jtr

    k = key_frame_idx
    with torch.no_grad():
        joints_key = smpl_joints(trans[k:k + 1], root_orient[k:k + 1],
                                 pose_body[k:k + 1], betas_seq[k:k + 1])
        R, t, root_height = geo.compute_cam2prior(
            fp3, trans[k:k + 1], root_orient[k:k + 1], joints_key)
        prior = geo.apply_cam2prior(
            trans[None], root_orient[None], R, t, root_height,
            torch.full((1,), k, dtype=torch.long, device=dev),
            smpl_root_joint_fn=lambda tr, ro: smpl_joints(
                tr[0], ro[0], pose_body, betas_seq)[None, :, 0, 2])

    out = dict(stitched)
    out["trans"] = _np(prior["trans"][0])
    out["root_orient"] = _np(prior["root_orient"][0])
    out.pop("floor_plane", None)   # prior frame is floor-relative (z-up)
    return out


def save_prior_stage_results(out_dir: str, stage_name: str,
                             results: Dict[str, np.ndarray], body,
                             floor_plane: np.ndarray,
                             batch_names: Optional[Sequence[str]] = None,
                             device="cuda") -> None:
    """Per-window <stage>_results_prior.npz: each window's camera-frame
    result re-expressed in the prior frame of its final optimized floor
    (cam2prior recomputed from that floor)."""
    B = _np(results["trans"]).shape[0]
    names = batch_names or [f"seq_{i:03d}" for i in range(B)]
    fp = _np(floor_plane)
    for b, name in enumerate(names):
        win = {k: _np(v)[b] for k, v in results.items()
               if hasattr(v, "shape") and _np(v).shape[:1] == (B,)}
        win.pop("floor_plane", None)
        prior = to_prior_frame(win, body, floor_plane=fp[b], device=device)
        prior.pop("latent_motion", None)
        seq_dir = os.path.join(out_dir, name)
        os.makedirs(seq_dir, exist_ok=True)
        np.savez(os.path.join(seq_dir, f"{stage_name}_results_prior.npz"),
                 **{k: _np(v) for k, v in prior.items()})


def save_stitched_result(out_dir: str, final: Dict[str, np.ndarray],
                         observed: Dict[str, np.ndarray], body=None,
                         device="cuda") -> Dict[str, np.ndarray]:
    """Write the full-video final_results/ directory: stitched
    stage3_results.npz,
    observations.npz, and — when a floor + body model are available — the
    prior-frame stage3_results_prior.npz."""
    iv = _np(observed["seq_interval"])
    keys = {k: final[k] for k in ("trans", "root_orient", "pose_body",
                                  "betas", "contacts", "floor_plane")
            if k in final}
    stitched = stitch_windows(keys, iv)
    fr_dir = os.path.join(out_dir, "final_results")
    os.makedirs(fr_dir, exist_ok=True)
    np.savez(os.path.join(fr_dir, "stage3_results.npz"),
             **{k: _np(v) for k, v in stitched.items()})
    obs_keys = [k for k in ("joints2d",) if k in observed]
    if obs_keys:
        st_obs = stitch_observations(observed, iv, obs_keys)
        np.savez(os.path.join(fr_dir, "observations.npz"),
                 **{k: _np(v) for k, v in st_obs.items()})
    if body is not None and "floor_plane" in stitched:
        prior = to_prior_frame(stitched, body, device=device)
        np.savez(os.path.join(fr_dir, "stage3_results_prior.npz"),
                 **{k: _np(v) for k, v in prior.items()})
    return stitched
