"""The PROX and iMapper loaders of humor_torch against humor_tpu's on
synthetic recordings written in the public layouts:

  * OpenCV's camera model without cv2: `undistort_points` against
    cv2.undistortPoints (5 fixed iterations, the fallback where the radial
    factor turns negative) within 1e-6, `project_points` against
    cv2.projectPoints within 1e-5 px, `rodrigues` against cv2.Rodrigues;
  * the PNGs through PIL against cv2.imread: 16-bit depth (written by PIL
    and by cv2, so both byte orders of the round trip are checked) and
    8-bit masks, exactly;
  * the PROX recording (chip_smoke.write_prox_recording: distortion on
    both cameras, 16-bit depth, body-index masks) through both packages'
    ProxDataset: keypoints, camera and windows exactly, the depth clouds
    within 1e-5 m, the pseudo-GT fitting batch exactly, the RANSAC floor
    exactly. The JAX loader was written for OpenCV 4, whose
    undistortPoints returns (1, N, 2); the cv2 here returns (N, 1, 2), so
    the JAX side runs with that call reshaped to OpenCV 4's layout;
  * an i3DB scene (keypoints, annotated GT skeleton, floor boxes) through
    both IMapperDataset's, and the pure functions, exactly.
"""

import json
import os
import pickle

import cv2
import numpy as np
import pytest
from PIL import Image

from humor_tpu.data import imapper as JI
from humor_tpu.data import prox as JP

from humor_torch.data import imapper as TI
from humor_torch.data import prox as TP
from humor_torch.data import rgb as TD

import chip_smoke

K = np.asarray([[1060.5, 0.0, 951.3], [0.0, 1060.4, 536.8], [0.0, 0.0, 1.0]])
DISTS = [[0.1, -0.2, 0.001, 0.002], [0.1, -0.2, 0.001, 0.002, 0.05],
         [0.3, -0.5, 0.01, -0.01, 0.2], [0.0, 0.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("dist", DISTS)
def test_undistort_points_matches_cv2(dist):
    """Pixels over the whole image, corners included (with [0.1, -0.2,
    ...] the radial factor turns negative there and OpenCV keeps the
    distorted coordinates)."""
    rng = np.random.RandomState(0)
    uv = np.concatenate([rng.rand(2000, 2) * [1920, 1080],
                         [[0, 0], [1919, 1079], [0, 1079], [1919, 0]]])
    ref = cv2.undistortPoints(uv.reshape(1, -1, 2), K,
                              np.asarray(dist)).reshape(-1, 2)
    np.testing.assert_allclose(TP.undistort_points(uv, K, dist), ref,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("rot", ["vector", "matrix", "zero"])
def test_project_points_matches_cv2(dist, rot):
    rng = np.random.RandomState(1)
    pts = rng.randn(500, 3) * [0.8, 0.6, 0.5] + [0.0, 0.0, 2.5]
    rvec = {"vector": np.asarray([0.05, -0.1, 0.02]),
            "zero": np.zeros(3)}.get(rot)
    if rot == "matrix":
        rvec = cv2.Rodrigues(np.asarray([0.05, -0.1, 0.02]))[0]
    tvec = np.asarray([0.05, -0.02, 0.1])
    ref = cv2.projectPoints(pts, rvec, tvec, K, np.asarray(dist))[0]
    np.testing.assert_allclose(TP.project_points(pts, rvec, tvec, K, dist),
                               ref.reshape(-1, 2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(TP.rodrigues([0.05, -0.1, 0.02]),
                               cv2.Rodrigues(np.asarray(
                                   [0.05, -0.1, 0.02]))[0], atol=1e-12)


def test_pngs_match_cv2(tmp_path):
    rng = np.random.RandomState(2)
    depth = (rng.rand(48, 64) * 60000).astype(np.uint16)
    Image.fromarray(depth).save(tmp_path / "pil.png")
    cv2.imwrite(str(tmp_path / "cv2.png"), depth)
    for name in ("pil.png", "cv2.png"):
        ours = TP.read_depth_png(str(tmp_path / name))
        ref = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
        assert ref.dtype == np.uint16
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, depth)
    mask = (rng.rand(48, 64) > 0.5).astype(np.uint8) * 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    np.testing.assert_array_equal(
        TD.read_gray_png(str(tmp_path / "mask.png")),
        cv2.imread(str(tmp_path / "mask.png"), cv2.IMREAD_GRAYSCALE))


def _write_fit_pkl(path, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"transl": rng.randn(1, 3), "betas": rng.randn(1, 10),
                     "body_pose": rng.randn(1, 63),
                     "global_orient": rng.randn(1, 3)}, f)


@pytest.fixture()
def prox(tmp_path):
    rec = chip_smoke.write_prox_recording(str(tmp_path), frames=12)
    rng = np.random.RandomState(4)
    names = sorted(n[:-len("_keypoints.json")] for n in
                   os.listdir(os.path.join(rec, "keypoints")))
    for name in names[::3]:   # pseudo-GT for every third frame
        _write_fit_pkl(os.path.join(str(tmp_path), "fittings", "mosh",
                                    os.path.basename(rec), "results", name,
                                    "000.pkl"), rng)
    return rec, os.path.join(str(tmp_path), "calibration")


def test_prox_dataset_matches_jax(prox, monkeypatch):
    rec, calib = prox
    undistort = cv2.undistortPoints
    monkeypatch.setattr(cv2, "undistortPoints", lambda *a, **k: undistort(
        *a, **k).reshape(1, -1, 2))
    kw = dict(seq_len=8, overlap_len=3, load_fitting=True)
    ds_j = JP.ProxDataset(rec, calib, JP.ProxConfig(**kw))
    ds_t = TP.ProxDataset(rec, calib, TP.ProxConfig(**kw))
    assert ds_t.intervals == ds_j.intervals
    oj, ot = ds_j.observation_batch(), ds_t.observation_batch()
    assert set(ot) == set(oj) == {"joints2d", "seq_interval", "cam_f",
                                  "cam_center", "points3d"}
    for k in ("joints2d", "seq_interval", "cam_f", "cam_center"):
        assert ot[k].dtype == oj[k].dtype, k
        np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
    pj, pt = oj["points3d"], ot["points3d"]
    assert pt.shape == pj.shape and pt.dtype == pj.dtype
    fin = np.isfinite(pj)
    np.testing.assert_array_equal(np.isfinite(pt), fin)
    assert 0 < fin.all(-1).sum(-1).min() < pj.shape[2]
    np.testing.assert_allclose(pt[fin], pj[fin], rtol=0, atol=1e-5)
    gj, gt = ds_j.fitting_batch(), ds_t.fitting_batch()
    assert set(gt) == set(gj) and gt["valid"].any() and not gt[
        "valid"].all()
    for k in gj:
        np.testing.assert_array_equal(gt[k], gj[k], err_msg=k)
    pts = np.random.RandomState(5).randn(40, 3) + [0.0, 0.0, 2.5]
    np.testing.assert_allclose(
        ds_t.projection.project_points(pts, ds_t.projection.color_cam),
        ds_j.projection.project_points(pts, ds_j.projection.color_cam),
        rtol=0, atol=1e-5)
    cloud = pt[0, 0][np.isfinite(pt[0, 0]).all(-1)]
    np.testing.assert_array_equal(TP.fit_floor_ransac(cloud, n_iters=50),
                                  JP.fit_floor_ransac(cloud, n_iters=50))
    assert TP.gender_of_subject(162) == JP.gender_of_subject(162)



def test_scene_floor_plane_matches_jax(prox, monkeypatch):
    """The fit CLI's PROX floor, ProxDataset.scene_floor_plane: the
    off-person depth points of the first frame in the colour camera's
    frame, through a RANSAC plane fit. Against the JAX package's pieces
    on the same frame (JAX's Projection cloud of those points, cv2's
    depth and mask reads, its fit_floor_ransac) within 1e-5; and against
    the synthetic recording's floor, the plane y = PROX_FLOOR_M of the
    depth camera carried into the colour camera's frame by the same two
    maps: normal within 0.01, offset within 2 cm (measured 0.0075 and
    1.3 cm: the wall's points within RANSAC's 5 cm of the floor join its
    least-squares refit and tilt it)."""
    rec, calib = prox
    undistort = cv2.undistortPoints
    monkeypatch.setattr(cv2, "undistortPoints", lambda *a, **k: undistort(
        *a, **k).reshape(1, -1, 2))
    plane = TP.ProxDataset(rec, calib, TP.ProxConfig(seq_len=8)
                           ).scene_floor_plane()
    ds_j = JP.ProxDataset(rec, calib, JP.ProxConfig(seq_len=8))
    name = os.path.basename(ds_j.keyp_paths[0])[:-len("_keypoints.json")]
    depth = cv2.imread(os.path.join(rec, "Depth", name + ".png"),
                       cv2.IMREAD_UNCHANGED).astype(np.float64) / 8000.0
    person = (cv2.imread(os.path.join(rec, "BodyIndex", name + ".png"),
                         cv2.IMREAD_GRAYSCALE) != 255).astype(np.uint8)
    pts = ds_j.projection.masked_point_cloud(depth, person,
                                             8 * JP.MAX_POINTS, 0)
    pts = pts[np.isfinite(pts[:, 0])].astype(np.float64)
    np.testing.assert_allclose(plane, JP.fit_floor_ransac(pts, seed=0),
                               rtol=0, atol=1e-5)
    ir, col = (np.asarray(c["view_mtx"]) for c in
               (ds_j.projection.depth_cam, ds_j.projection.color_cam))
    on = np.asarray([[0.0, chip_smoke.PROX_FLOOR_M, 2.0],
                     [1.0, chip_smoke.PROX_FLOOR_M, 3.0],
                     [-1.0, chip_smoke.PROX_FLOOR_M, 4.0]])
    on = ((on - ir[:, 3]) @ ir[:, :3]) @ col[:, :3].T + col[:, 3]
    n = np.cross(on[1] - on[0], on[2] - on[0])
    n = n / np.linalg.norm(n) * -np.sign(n[1])
    np.testing.assert_allclose(plane[:3], n, rtol=0, atol=0.01)
    np.testing.assert_allclose(plane[3], n @ on[0], rtol=0, atol=0.02)


def _write_imapper_scene(root, frames=30, annotated=10):
    """An i3DB scene, Scene05: OpenPose keypoints, the ~7.5 Hz annotated
    GT skeleton (16 joints, some unconfident, some occluded) and its
    floor-contact couch box."""
    rng = np.random.RandomState(6)
    scene = os.path.join(root, "Scene05")
    chip_smoke.write_keypoints(
        os.path.join(scene, "keypoints"),
        np.concatenate([rng.rand(frames, 25, 2) * [1920, 1080],
                        rng.rand(frames, 25, 1)], -1))
    info = {"3d": {str(f): {str(j): (rng.randn(3) + [0, 0, 3]).tolist()
                            for j in range(16)} for f in range(annotated)},
            "confidence": {"values": [
                {str(j): float(rng.rand() > 0.2) for j in range(16)}
                for _ in range(annotated)]},
            "occluded": {str(f + 1): (rng.rand(16) > 0.7).astype(
                int).tolist() for f in range(annotated)}}
    gt_json = os.path.join(scene, "gt_skel.json")
    with open(gt_json, "w") as f:
        json.dump(info, f)
    os.makedirs(os.path.join(scene, "gt"))
    c, s = np.cos(0.3), np.sin(0.3)
    with open(os.path.join(scene, "gt", "00_couch_seat.json"), "w") as f:
        json.dump({"centroid": [0.2, 1.6, 3.0],
                   "axes": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
                   "scales": [1.2, 0.5, 0.8]}, f)
    return scene, gt_json, info


def test_imapper_dataset_matches_jax(tmp_path):
    scene, gt_json, info = _write_imapper_scene(str(tmp_path))
    cam = np.asarray([[1000.0, 0, 960.0], [0, 1000.0, 540.0], [0, 0, 1]],
                     np.float32)
    for kw in ({}, {"gt_json": gt_json, "cam_mat": cam}):
        oj, gj = JI.IMapperDataset(scene, JI.IMapperConfig(seq_len=12),
                                   **kw).observation_batch()
        ot, gt = TI.IMapperDataset(scene, TI.IMapperConfig(seq_len=12),
                                   **kw).observation_batch()
        assert set(ot) == set(oj) and set(gt) == set(gj)
        assert "floor_plane" in ot and ("cam_f" in ot) == bool(kw)
        for k in oj:
            assert ot[k].dtype == oj[k].dtype, k
            np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
        for k in gj:
            np.testing.assert_array_equal(gt[k], gj[k], err_msg=k)
    j3d_t, occ_t = TI.parse_gt_skeleton(info)
    j3d_j, occ_j = JI.parse_gt_skeleton(info)
    np.testing.assert_array_equal(j3d_t, j3d_j)
    np.testing.assert_array_equal(occ_t, occ_j)
    for n in (5, 30, 40):
        np.testing.assert_array_equal(TI.align_to_30hz(j3d_t, n),
                                      JI.align_to_30hz(j3d_j, n))
    with open(os.path.join(scene, "gt", "00_couch_seat.json")) as f:
        box = json.load(f)
    for fn in ("corners_3d", "corners_3d_lower", "faces_3d"):
        np.testing.assert_array_equal(getattr(TI.Obb.from_json(box), fn)(),
                                      getattr(JI.Obb.from_json(box), fn)())
