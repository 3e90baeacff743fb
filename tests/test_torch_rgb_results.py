"""The video modules of humor_torch against humor_tpu on the same inputs:
data/rgb.py (window split, OpenPose keypoint reader, flip, occlusion
mask, PlaneRCNN floor, the observation batch of a synthetic keypoint
folder laid out as tests/test_fitting_cli_e2e.py lays it out) and
fitting/results.py (overlaps, stitching, the npz writers and the
prior-frame re-expression). Window and stitch outputs must be exact;
to_prior_frame agrees to 1e-5 (float32 SMPL and cam2prior on both
sides).
"""

import json
import os

import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.data import rgb as JD
from humor_tpu.fitting import results as JR

from humor_torch import convert
from humor_torch.data import rgb as TD
from humor_torch.fitting import results as TR


def _write_keypoints(dirpath, t, kp):
    data = {"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}
    with open(os.path.join(dirpath, f"frame_{t:06d}_keypoints.json"),
              "w") as f:
        json.dump(data, f)


@pytest.fixture()
def video(tmp_path):
    """25 frames of smoothly moving OpenPose detections; frame 7 has no
    person (an empty "people" list)."""
    rng = np.random.RandomState(0)
    base = rng.rand(25, 2).astype(np.float32) * np.asarray([200.0, 150.0])
    base += np.asarray([220.0, 160.0], np.float32)
    n = 25
    for t in range(n):
        kp = np.concatenate(
            [base + np.sin(t / 3.0) * 5.0
             + rng.randn(25, 2).astype(np.float32),
             rng.rand(25, 1).astype(np.float32)], axis=-1)
        if t == 7:
            with open(tmp_path / f"frame_{t:06d}_keypoints.json", "w") as f:
                json.dump({"people": []}, f)
        else:
            _write_keypoints(str(tmp_path), t, kp)
    return str(tmp_path), n


@pytest.mark.parametrize("frames,seq_len,overlap", [
    (110, 60, 10), (25, 8, 3), (25, 10, 2), (8, 10, 3), (61, 60, 10),
    (100, 30, 29), (100, 30, 40), (37, 7, 0)])
def test_split_overlapping_windows(frames, seq_len, overlap):
    assert TD.split_overlapping_windows(frames, seq_len, overlap) == \
        JD.split_overlapping_windows(frames, seq_len, overlap)


def test_keypoint_helpers(video, tmp_path):
    path, _ = video
    for t in (0, 7, 12):
        fn = os.path.join(path, f"frame_{t:06d}_keypoints.json")
        np.testing.assert_array_equal(TD.read_keypoints(fn),
                                      JD.read_keypoints(fn))
    kp = TD.read_keypoints(os.path.join(path, "frame_000003_keypoints.json"))
    np.testing.assert_array_equal(TD.flip_keypoints(kp, 640),
                                  JD.flip_keypoints(kp, 640))
    mask = (np.random.RandomState(1).rand(480, 640) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(TD.mask_occluded_joints(kp, mask),
                                  JD.mask_occluded_joints(kp, mask))
    rng = np.random.RandomState(2)
    plane_dir = tmp_path / "planes"
    plane_dir.mkdir()
    np.save(plane_dir / "f_plane_parameters_0.npy", rng.randn(4, 3))
    np.save(plane_dir / "f_plane_masks_0.npy", rng.rand(4, 30, 40) > 0.6)
    np.testing.assert_array_equal(TD.load_planercnn_floor(str(plane_dir)),
                                  JD.load_planercnn_floor(str(plane_dir)))
    assert TD.DEFAULT_GROUND.tolist() == JD.DEFAULT_GROUND.tolist()


@pytest.mark.parametrize("seq_len", [8, 0, 40])
def test_observation_batch(video, seq_len):
    """The stacked windows (a short last window zero-padded), the camera
    from the default intrinsics or a given matrix, the floor and the
    intervals: exactly JAX's."""
    path, n = video
    cam = np.asarray([[300.0, 0.0, 320.0], [0.0, 310.0, 240.0],
                      [0.0, 0.0, 1.0]], np.float32)
    for kw in ({}, {"cam_mat": cam, "floor_plane": [0.0, -1.0, 0.1, -1.2]}):
        cfg_t = TD.RGBVideoConfig(seq_len=seq_len, overlap_len=3)
        cfg_j = JD.RGBVideoConfig(seq_len=seq_len, overlap_len=3)
        out = TD.RGBVideoDataset(path, cfg_t, **kw).observation_batch()
        ref = JD.RGBVideoDataset(path, cfg_j, **kw).observation_batch()
        assert set(out) == set(ref)
        for k in ref:
            assert out[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_observation_batch_mask_path_waits(video, tmp_path):
    """The person masks (8-bit PNGs written with PIL, one frame without
    one, one as RGB): the port reads them with PIL where JAX reads them
    with cv2, and the masked batch is exactly JAX's."""
    from PIL import Image

    path, n = video
    mdir = tmp_path / "masks"
    mdir.mkdir()
    rng = np.random.RandomState(3)
    for t in range(n):
        if t == 4:
            continue
        m = ((rng.rand(480, 640) > 0.5) * 255).astype(np.uint8)
        im = Image.fromarray(m)
        (im.convert("RGB") if t == 5 else im).save(
            mdir / f"frame_{t:06d}.png")
    np.testing.assert_array_equal(
        TD.read_gray_png(str(mdir / "frame_000003.png")),
        np.asarray(Image.open(mdir / "frame_000003.png")))
    cfg_t = TD.RGBVideoConfig(seq_len=8, overlap_len=3)
    cfg_j = JD.RGBVideoConfig(seq_len=8, overlap_len=3)
    out = TD.RGBVideoDataset(path, cfg_t, mask_path=str(mdir))
    ref = JD.RGBVideoDataset(path, cfg_j, mask_path=str(mdir))
    assert (out.joints2d[..., 2] != ref.joints2d[..., 2]).sum() == 0
    assert (out.joints2d[..., 2] == 0).sum() > (
        TD.RGBVideoDataset(path, cfg_t).joints2d[..., 2] == 0).sum()
    ob, rb = out.observation_batch(), ref.observation_batch()
    for k in rb:
        np.testing.assert_array_equal(ob[k], rb[k], err_msg=k)


def _windows(rng, B, T, nb=16):
    return {
        "trans": rng.randn(B, T, 3).astype(np.float32),
        "root_orient": (rng.randn(B, T, 3) * 0.2
                        + [np.pi, 0.0, 0.0]).astype(np.float32),
        "pose_body": rng.randn(B, T, 63).astype(np.float32) * 0.05,
        "contacts": (rng.rand(B, T, 22) > 0.5).astype(np.float32),
        "betas": rng.randn(B, nb).astype(np.float32) * 0.1,
        "floor_plane": np.tile(np.asarray([0.02, -0.99, 0.05, 1.4],
                                          np.float32), (B, 1)),
    }


@pytest.mark.parametrize("iv", [[[0, 10], [8, 18], [16, 26]],
                                [[0, 6], [4, 10]], [[0, 5], [7, 12]],
                                [[0, 60], [50, 110]]])
def test_stitching_matches_jax(iv):
    """seq_overlaps_of, stitch_windows (numpy and torch inputs) and
    stitch_observations, exactly; a gap is no overlap."""
    iv = np.asarray(iv)
    B, T = len(iv), int(iv[0, 1] - iv[0, 0])
    rng = np.random.RandomState(B * T)
    res = _windows(rng, B, T)
    np.testing.assert_array_equal(TR.seq_overlaps_of(iv),
                                  JR.seq_overlaps_of(iv))
    ref = JR.stitch_windows(res, iv)
    for given in (res, {k: torch.tensor(v) for k, v in res.items()}):
        out = TR.stitch_windows(given, iv)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    obs = {"joints2d": rng.randn(B, T, 25, 3).astype(np.float32),
           "seq_interval": iv}
    out, ref = TR.stitch_observations(obs, iv), JR.stitch_observations(obs, iv)
    np.testing.assert_array_equal(out["joints2d"], ref["joints2d"])


@pytest.fixture(scope="module")
def bodies():
    body = jsmpl.synthetic_smpl_model()
    return body, convert.smpl_model(body)


@pytest.mark.parametrize("key_frame,floor", [(0, None), (3, [0.0, 1.5, 0.0]),
                                             (0, [0.05, -0.99, 0.1, -1.3])])
def test_to_prior_frame_matches_jax(bodies, key_frame, floor):
    """The stitched sequence in the prior frame of one cam2prior (the
    optimization-form or parsed floor, at a key frame), 1e-5."""
    jb, tb = bodies
    rng = np.random.RandomState(11 + key_frame)
    T = 7
    st = {k: v[0] for k, v in _windows(rng, 1, T).items()}
    st["trans"] = st["trans"] * 0.05 + [0.3, 1.2, 2.0]
    st["floor_plane"] = np.asarray([0.0, 1.5, 0.0], np.float32)
    st["betas"] = rng.randn(T, 16).astype(np.float32) * 0.1
    fp = None if floor is None else np.asarray(floor, np.float32)
    ref = JR.to_prior_frame(st, jb, floor_plane=fp, key_frame_idx=key_frame)
    out = TR.to_prior_frame(st, tb, floor_plane=fp, key_frame_idx=key_frame,
                            device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), atol=1e-5,
                                   err_msg=k)


def test_to_prior_frame_defaults_to_the_card(bodies):
    """Without device="cpu" the SMPL forward and cam2prior run on the GPU:
    where there is none the call raises instead of computing on the host;
    where there is one it agrees with the CPU (1e-4)."""
    _, tb = bodies
    rng = np.random.RandomState(3)
    st = {k: v[0] for k, v in _windows(rng, 1, 5).items()}
    st["floor_plane"] = np.asarray([0.0, 1.5, 0.0], np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.to_prior_frame(st, tb)
        return
    out, ref = TR.to_prior_frame(st, tb), TR.to_prior_frame(st, tb,
                                                            device="cpu")
    for k in ref:
        assert isinstance(out[k], np.ndarray), k
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_tree(a_dir, b_dir, atol):
    a_files = sorted(os.path.relpath(os.path.join(r, f), a_dir)
                     for r, _, fs in os.walk(a_dir) for f in fs)
    b_files = sorted(os.path.relpath(os.path.join(r, f), b_dir)
                     for r, _, fs in os.walk(b_dir) for f in fs)
    assert a_files == b_files
    for rel in a_files:
        a, b = _npz(os.path.join(a_dir, rel)), _npz(os.path.join(b_dir, rel))
        assert set(a) == set(b), rel
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=atol,
                                       err_msg=f"{rel} {k}")


def test_npz_writers_match_jax(bodies, tmp_path):
    """save_stage_results, save_observations, save_prior_stage_results and
    save_stitched_result write the same files and keys as JAX's, with the
    same values (the prior-frame ones to 1e-5)."""
    jb, tb = bodies
    rng = np.random.RandomState(5)
    B, T = 2, 6
    iv = np.asarray([[0, 6], [4, 10]])
    final = _windows(rng, B, T)
    observed = {"joints2d": rng.randn(B, T, 25, 3).astype(np.float32),
                "cam_f": np.tile([[300.0, 300.0]], (B, 1)),
                "seq_interval": iv}
    gt = {"trans": rng.randn(B, T, 3), "betas": None}
    for mod, body, name, dev in ((JR, jb, "jax", {}),
                                 (TR, tb, "torch", {"device": "cpu"})):
        out = str(tmp_path / name)
        mod.save_stage_results(out, "stage2", final,
                               batch_names=["win_a", "win_b"])
        mod.save_stage_results(out, "stage3", final,
                               fname="stage3_results_x.npz")
        mod.save_observations(out, observed, gt)
        mod.save_prior_stage_results(out, "stage2", final, body,
                                     final["floor_plane"], **dev)
        mod.save_stitched_result(out, final, observed, body, **dev)
    _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"), 1e-5)
    prior = _npz(tmp_path / "torch" / "final_results" /
                 "stage3_results_prior.npz")
    assert prior["trans"].shape == (10, 3) and "floor_plane" not in prior
