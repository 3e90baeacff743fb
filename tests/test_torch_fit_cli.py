"""The port's command-line entry points on the CPU (--device cpu):

  * wiring against the JAX package without fitting: both fit CLIs' main()
    on the same argv (the port's with --device cpu) over tiny RGB (with
    person masks), PROX-RGBD and iMapper layouts, `optimizer.run` of each
    package replaced by a recorder: the TTOConfig each builds, field by
    field, and each observation within 1e-5. The JAX CLI's models are
    replaced by its synthetic body, the one part of them it reads before
    `run`. The port's CLI adds what the JAX CLI leaves out and the fit
    needs, each from the data: PROX's floor from the recording's scene
    depth (ProxDataset.scene_floor_plane), iMapper's camera from
    --rgb-intrinsics; the added values are checked as such;
  * the port alone, end to end: fitting.cli -> eval.fitting_cli ->
    viz.fitting as tests/test_fitting_cli_e2e.py drives JAX's (seq-len 6,
    overlap 2, 2/2/2 iterations, 4 candidates), with the hybrid search
    and the tolerances; then the configs' own files (fit_rgb_demo_no_split
    through `python -m`, fit_proxd and fit_imapper in process) on the
    layouts with short budgets;
  * AMASS raises naming ROADMAP A6; the default --device cuda raises
    without a GPU; iMapper without intrinsics or floor boxes and PROX
    without depth images raise; DeepLabv3's masks default to the card;
    the config parser against JAX's on the configs;
  * the checkpoint importers against JAX's on synthetic state dicts.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as JS
from humor_tpu.fitting import cli as JF
from humor_tpu.fitting import optimizer as JO
from humor_tpu.utils import config as JC
from humor_tpu.utils import import_torch as JIT

from humor_torch.data import prox as TP
from humor_torch.fitting import cli as TF
from humor_torch.fitting import optimizer as TO
from humor_torch.utils import config as TC
from humor_torch.utils import import_torch as TIT

import chip_smoke
from test_torch_loaders import _write_imapper_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs")
FAST = ["--num-iters", "2", "2", "2", "--num-iters-scale", "1",
        "--stage3-tune-init-num-frames", "3", "--stage3-freeze-start", "1",
        "--stage3-freeze-end", "2", "--lbfgs-candidates", "4"]


def _rgb_layout(root, n=10):
    """tests/test_fitting_cli_e2e.py's video: smoothly moving detections,
    an intrinsics json, and a person mask a frame (the left 300 columns
    white: joints there are occluded)."""
    rng = np.random.RandomState(0)
    base = rng.rand(25, 2) * [200.0, 150.0] + [220.0, 160.0]
    kp = [np.concatenate([base + np.sin(t / 3.0) * 5.0 + rng.randn(25, 2),
                          np.full((25, 1), 0.9)], -1) for t in range(n)]
    kp_dir = chip_smoke.write_keypoints(os.path.join(root, "video_kps"),
                                        np.stack(kp))
    masks = os.path.join(root, "masks")
    os.makedirs(masks)
    from PIL import Image

    m = np.zeros((480, 640), np.uint8)
    m[:, :300] = 255
    for t in range(n):
        Image.fromarray(m).save(os.path.join(masks, f"frame_{t:06d}.png"))
    intr = chip_smoke.write_intrinsics(os.path.join(root, "intr.json"),
                                       (300.0, 300.0), (320.0, 240.0))
    return kp_dir, masks, intr


class _Captured(Exception):
    pass


def _capture(monkeypatch, argv_j, argv_t):
    """Both CLIs' main() up to `optimizer.run`: (cfg, observed) each."""
    got = {}

    def rec(name):
        def run(cfg, models, observed, *a, **kw):
            got[name] = (cfg, {k: np.asarray(v) for k, v in
                               observed.items()})
            raise _Captured
        return run

    monkeypatch.setattr(JO, "run", rec("jax"))
    monkeypatch.setattr(TO, "run", rec("torch"))
    monkeypatch.setattr(JF, "load_models", lambda cfg: types.SimpleNamespace(
        body=JS.synthetic_smpl_model()))
    for name, fn, argv in (("jax", JF.main, argv_j),
                           ("torch", TF.main, argv_t)):
        with pytest.raises(_Captured):
            fn(argv)
    return got


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("layout", ["RGB", "PROX-RGBD", "iMapper-RGB"])
def test_cli_wiring_matches_jax(layout, tmp_path, monkeypatch):
    undistort = cv2.undistortPoints     # the JAX loader's OpenCV 4 layout
    monkeypatch.setattr(cv2, "undistortPoints",
                        lambda *a, **k: undistort(*a, **k).reshape(1, -1, 2))
    tol = ["--lbfgs-linesearch", "hybrid", "--lbfgs-tol-grad", "1e-7",
           "--lbfgs-tol-change", "1e-9", "--lbfgs-stall-patience", "4",
           "--lbfgs-polish-frac", "0.2", "--lbfgs-max-iter", "7",
           "--out", str(tmp_path / "out")]
    if layout == "RGB":
        kp, masks, intr = _rgb_layout(str(tmp_path))
        argv = [f"@{CFG}/fit_rgb_demo_no_split.cfg", "--data-path", kp,
                "--mask-path", masks, "--rgb-intrinsics", intr,
                "--num-iters-scale", "2", "--lbfgs-candidates", "0"] + tol
    elif layout == "PROX-RGBD":
        rec = chip_smoke.write_prox_recording(str(tmp_path), frames=12)
        argv = [f"@{CFG}/fit_proxd.cfg", "--data-path", rec,
                "--seq-len", "8"] + tol
    else:
        scene, _, _ = _write_imapper_scene(str(tmp_path))
        intr = chip_smoke.write_intrinsics(str(tmp_path / "intr.json"),
                                           (1000.0, 990.0), (950.0, 530.0))
        argv = [f"@{CFG}/fit_imapper.cfg", "--data-path", scene,
                "--seq-len", "12", "--stage3-no-tune-init-state",
                "--rgb-intrinsics", intr] + tol
    got = _capture(monkeypatch, argv, argv + ["--device", "cpu"])
    (cj, oj), (ct, ot) = got["jax"], got["torch"]
    fj, ft = _fields(cj), _fields(ct)
    assert set(fj) == set(ft)
    for k in fj:
        if k in ("stage_weights", "energy"):
            continue
        assert ft[k] == fj[k], k
    for wj, wt in zip(cj.stage_weights, ct.stage_weights):
        assert dataclasses.asdict(wt) == dataclasses.asdict(wj)
    assert dataclasses.asdict(ct.energy) == dataclasses.asdict(cj.energy)
    assert ct.lbfgs_linesearch == "hybrid" and ct.lbfgs_tol_grad == 1e-7
    for k in oj:
        assert ot[k].dtype == oj[k].dtype, k
        fin = np.isfinite(oj[k])
        np.testing.assert_array_equal(np.isfinite(ot[k]), fin, err_msg=k)
        np.testing.assert_allclose(ot[k][fin], oj[k][fin], rtol=0,
                                   atol=1e-5, err_msg=k)
    filled = set(ot) - set(oj)
    B = ot["joints2d"].shape[0]
    expect = {"RGB": set(), "PROX-RGBD": {"floor_plane"},
              "iMapper-RGB": {"cam_f", "cam_center"}}[layout]
    assert filled == expect
    assert "floor_plane" in ot
    if layout == "PROX-RGBD":
        floor = TP.ProxDataset(rec, str(tmp_path / "calibration"),
                               TP.ProxConfig(seq_len=8)).scene_floor_plane()
        np.testing.assert_array_equal(ot["floor_plane"],
                                      np.tile(floor, (B, 1)))
    if layout == "iMapper-RGB":
        np.testing.assert_array_equal(ot["cam_f"],
                                      np.tile([1000.0, 990.0], (B, 1)))
        np.testing.assert_array_equal(ot["cam_center"],
                                      np.tile([950.0, 530.0], (B, 1)))
    if layout == "RGB":   # the masks occluded some joints
        assert (ot["joints2d"][..., 2] == 0).any()


def test_cli_end_to_end(tmp_path):
    """The port's fit -> eval -> viz chain on test_fitting_cli_e2e.py's
    layout and budget, with person masks, the hybrid search and the
    tolerances: the files JAX's flow writes, finite metrics."""
    from humor_torch.eval import fitting_cli as FE
    from humor_torch.viz import fitting as VF

    kp, masks, intr = _rgb_layout(str(tmp_path))
    out = str(tmp_path / "fit_out")
    res = TF.main(["--data-path", kp, "--data-type", "RGB", "--seq-len", "6",
                   "--overlap-len", "2", "--rgb-intrinsics", intr,
                   "--mask-joints2d", "--mask-path", masks, "--out", out,
                   "--save-stages-results", "--lbfgs-linesearch", "hybrid",
                   "--lbfgs-tol-grad", "1e-9", "--lbfgs-tol-change", "1e-12",
                   "--device", "cpu"] + FAST)
    B, T = res.final["trans"].shape[:2]
    assert T == 6 and B >= 2
    for st, n in zip(("stage1", "stage2", "stage3"), (2, 2, 2)):
        assert res.losses[st].shape == (n,)
        assert torch.isfinite(res.losses[st]).all()
    for b in range(B):
        d = os.path.join(out, f"seq_{b:03d}")
        final = dict(np.load(os.path.join(d, "final_results.npz")))
        assert final["trans"].shape == (T, 3)
        assert final["pose_body"].shape == (T, 63)
        assert final["betas"].shape[-1] == 16 and "floor_plane" in final
        for st in ("stage1", "stage2", "stage3"):
            s = dict(np.load(os.path.join(d, f"{st}_results.npz")))
            assert s["trans"].shape == (T, 3), st
        for f in ("final_results_prior.npz", "stage2_results_prior.npz"):
            assert dict(np.load(os.path.join(d, f)))["trans"].shape == (
                T, 3)
        obs = dict(np.load(os.path.join(d, "observations.npz")))
        assert obs["joints2d"].shape == (T, 25, 3)
    fr = os.path.join(out, "final_results")
    stitched = dict(np.load(os.path.join(fr, "stage3_results.npz")))
    assert stitched["trans"].shape == (10, 3)
    assert all(np.isfinite(v).all() for v in stitched.values())
    assert os.path.exists(os.path.join(fr, "stage3_results_prior.npz"))

    eval_out = str(tmp_path / "fit_eval")
    tables = FE.main(["--results", out, "--out", eval_out,
                      "--stages", "final,stage2", "--mode", "2d",
                      "--smplh-root", str(tmp_path / "none"),
                      "--device", "cpu"])
    assert set(tables) == {"final", "stage2"}
    for table in tables.values():
        assert "accel_mag" in table and "ground_pen@0.00" in table
        for stats in table.values():
            assert all(np.isfinite(v) for v in stats.values())
    assert {"final_mean.csv", "stage2_mean.csv", "compare_mean.csv"} <= set(
        os.listdir(eval_out))

    viz_out = str(tmp_path / "fit_viz")
    written = VF.main(["--results", out, "--out", viz_out,
                       "--intrinsics", intr,
                       "--smplh-root", str(tmp_path / "none"),
                       "--viz-prior-frame", "--viz-obs-2d",
                       "--max-frames", "2", "--render-width", "640",
                       "--render-height", "480", "--device", "cpu"])
    assert written and all(os.path.exists(p) for p in written)
    for d in ("final_results", "final_results_prior", "seq_000",
              os.path.join("final_results", "mesh")):
        assert os.path.isdir(os.path.join(viz_out, d)), d


SHORT = ["--num-iters", "1", "1", "1", "--num-iters-scale", "1",
         "--stage3-freeze-start", "0", "--stage3-freeze-end", "1",
         "--device", "cpu"]


def test_cli_config_files(tmp_path):
    """The configs' own files on the test layouts with a short budget:
    fit_rgb_demo_no_split.cfg through `python -m` (the whole clip one
    window, person masks), fit_proxd.cfg (the depth clouds) and
    fit_imapper.cfg in process; each writes its stitched result."""
    kp, masks, intr = _rgb_layout(str(tmp_path))
    out = str(tmp_path / "rgb")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "humor_torch.fitting.cli",
         f"@{CFG}/fit_rgb_demo_no_split.cfg", "--data-path", kp,
         "--mask-path", masks, "--out", out] + SHORT,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "windows x 10 frames" in r.stdout
    rec = chip_smoke.write_prox_recording(str(tmp_path / "prox"), frames=12)
    scene, _, _ = _write_imapper_scene(str(tmp_path / "imapper"))
    runs = [(out, 10)]
    for cfg, path, n, seq, extra in (
            ("fit_proxd.cfg", rec, 12, 12, []),
            ("fit_imapper.cfg", scene, 30, 20, ["--rgb-intrinsics", intr])):
        o = str(tmp_path / cfg)
        res = TF.main([f"@{CFG}/{cfg}", "--data-path", path, "--seq-len",
                       str(seq), "--out", o] + extra + SHORT)
        assert all(torch.isfinite(v).all() for v in res.losses.values())
        runs.append((o, n))
    for o, n in runs:
        st = dict(np.load(os.path.join(o, "final_results",
                                       "stage3_results.npz")))
        assert st["trans"].shape == (n, 3) and np.isfinite(st["trans"]).all()


def test_cli_refusals(tmp_path):
    kp, _, _ = _rgb_layout(str(tmp_path))
    with pytest.raises(NotImplementedError, match="A6"):
        TF.main([f"@{CFG}/fit_amass_joints.cfg", "--device", "cpu",
                 "--out", str(tmp_path / "a")])
    with pytest.raises(NotImplementedError, match="unknown data type"):
        TF.main(["--data-type", "X", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TF.main(["--data-path", kp, "--data-type", "RGB",
                     "--out", str(tmp_path / "b")])
    scene, _, _ = _write_imapper_scene(str(tmp_path / "imapper"))
    intr = chip_smoke.write_intrinsics(str(tmp_path / "intr.json"))
    imapper = [f"@{CFG}/fit_imapper.cfg", "--data-path", scene,
               "--device", "cpu", "--out", str(tmp_path / "c")]
    with pytest.raises(ValueError, match="--rgb-intrinsics"):
        TF.main(imapper)
    os.remove(os.path.join(scene, "gt", "00_couch_seat.json"))
    with pytest.raises(ValueError, match="floor-contact boxes"):
        TF.main(imapper + ["--rgb-intrinsics", intr])
    rec = chip_smoke.write_prox_recording(str(tmp_path / "prox"), frames=4)
    for d in ("Depth", "BodyIndex"):
        shutil.rmtree(os.path.join(rec, d))
    with pytest.raises(ValueError, match="no depth frame"):
        TF.main([f"@{CFG}/fit_prox.cfg", "--data-path", rec,
                 "--device", "cpu", "--out", str(tmp_path / "d")])


class _HubLoad(Exception):
    pass


def test_deeplab_defaults_to_the_card(tmp_path, monkeypatch):
    """run_deeplab_v3 runs on the card unless asked for the CPU: without
    a GPU its default raises before it loads any weights; with
    device="cpu" it goes on to load them (torch.hub.load, replaced here
    by a stub that raises, so nothing is fetched)."""
    from humor_torch.utils import video as V

    def hub_load(*a, **kw):
        raise _HubLoad
    monkeypatch.setattr(torch.hub, "load", hub_load)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            V.run_deeplab_v3(str(tmp_path), str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="could not load DeepLabv3"):
        V.run_deeplab_v3(str(tmp_path), str(tmp_path / "m"), device="cpu")


@pytest.mark.parametrize("cfg", ["fit_rgb_demo_no_split.cfg",
                                 "fit_proxd.cfg", "fit_imapper.cfg",
                                 "fit_amass_joints.cfg"])
def test_config_parse_matches_jax(cfg):
    argv = [f"@{CFG}/{cfg}", "--lbfgs-linesearch", "zoom",
            "--lbfgs-tol-grad", "1e-7", "--seed", "3"]
    cj = JC.parse_into(JC.FitCLIConfig, argv)
    ct = TC.parse_into(TC.FitCLIConfig, argv)
    assert {k: v for k, v in _fields(ct).items() if k != "device"} == \
        _fields(cj)
    assert ct.device == "cuda"
    for wj, wt in zip(cj.stage_weights(), ct.stage_weights()):
        assert dataclasses.asdict(wt) == dataclasses.asdict(wj)
    vj = JC.parse_into(JC.VizCLIConfig, ["--results", "r", "--viz-no-mesh"])
    vt = TC.parse_into(TC.VizCLIConfig, ["--results", "r", "--viz-no-mesh"])
    assert {k: v for k, v in _fields(vt).items() if k != "device"} == \
        _fields(vj)


def _mlp_sd(rng, base, widths, skip=0):
    """A reference MLP's state dict: Linear at net.{3j}, the GroupNorm
    over its input at net.{3j-2}."""
    sd, prev = {}, widths[0]
    for j, w in enumerate(widths[1:]):
        fan_in = prev + (skip if j else 0)
        sd[f"{base}.net.{3 * j}.weight"] = torch.tensor(rng.randn(w, fan_in),
                                                        dtype=torch.float32)
        sd[f"{base}.net.{3 * j}.bias"] = torch.tensor(rng.randn(w),
                                                      dtype=torch.float32)
        if j:
            sd[f"{base}.net.{3 * j - 2}.weight"] = torch.tensor(
                rng.randn(prev), dtype=torch.float32)
            sd[f"{base}.net.{3 * j - 2}.bias"] = torch.tensor(
                rng.randn(prev), dtype=torch.float32)
        prev = w
    return sd


def _assert_tree_equal(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _assert_tree_equal(t[k], j[k])
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _assert_tree_equal(a, b)
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_checkpoint_importers_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    sd = {"module." + k: v for part in (
        _mlp_sd(rng, "encoder", [20, 32, 32, 8]),
        _mlp_sd(rng, "prior_net", [10, 32, 32, 8]),
        _mlp_sd(rng, "decoder", [14, 32, 16, 6], skip=4)) for k, v in
        part.items()}
    sd["module.bm.v_template"] = torch.zeros(3, 3)
    torch.save({"model_state_dict": sd, "epoch": 3}, tmp_path / "h.pth")
    _assert_tree_equal(TIT.load_humor_checkpoint(str(tmp_path / "h.pth")),
                       JIT.load_humor_checkpoint(str(tmp_path / "h.pth")))
    vsd = {}
    for ours, theirs in TIT._VPOSER_MAP.items():
        if ours.endswith(("bn1", "bn2")):
            for s in ("weight", "bias", "running_mean", "running_var"):
                vsd[f"{theirs}.{s}"] = torch.tensor(rng.rand(5),
                                                    dtype=torch.float32)
        else:
            vsd[f"{theirs}.weight"] = torch.tensor(rng.randn(4, 5),
                                                   dtype=torch.float32)
            vsd[f"{theirs}.bias"] = torch.tensor(rng.randn(4),
                                                 dtype=torch.float32)
    torch.save(vsd, tmp_path / "v.pt")
    _assert_tree_equal(TIT.load_vposer_checkpoint(str(tmp_path / "v.pt")),
                       JIT.load_vposer_checkpoint(str(tmp_path / "v.pt")))
    np.savez(tmp_path / "g.npz", weights=rng.rand(3), means=rng.randn(3, 4),
             covariances=rng.rand(3, 4, 4))
    _assert_tree_equal(
        tuple(TIT.load_gmm_checkpoint(str(tmp_path / "g.npz"))),
        tuple(JIT.load_gmm_checkpoint(str(tmp_path / "g.npz"))))
