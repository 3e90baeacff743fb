"""The port's AMASS preprocessing and cleanup CLIs (data/amass.py
process_file, data/process_amass.py, data/cleanup_amass.py) against the
JAX package's on the CPU, on the same synthetic raw tree: the same
output files, their arrays within 1e-5 (abs, plus 1e-5 relative for the
velocities, which divide float32 SMPL differences by 1/30 s), the gendered
body choice, a file that fails skipped, and the same files moved aside.
A file that numpy cannot read stops the JAX CLI (it reads the gender
outside its catch); the port skips it too. Also the profiling helpers."""

import os

import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as JS
from humor_tpu.data import amass as JA
from humor_tpu.data import cleanup_amass as JCL
from humor_tpu.data import process_amass as JPA

from humor_torch.body_model import smpl as TS
from humor_torch.data import amass as TA
from humor_torch.data import cleanup_amass as TCL
from humor_torch.data import process_amass as TPA
from humor_torch.data.dataset import AmassDataset, find_processed_files
from humor_torch.utils import profiling

import chip_smoke
from test_torch_fit_dataset import write_raw

torch.set_num_threads(2)


def _tree(root):
    """A raw tree: two CMU sequences (male, female), a KIT one, a
    BioMotionLab_NTroje treadmill one, and one without its poses."""
    write_raw(os.path.join(root, "CMU", "01", "a_poses.npz"), seed=0)
    write_raw(os.path.join(root, "CMU", "01", "b_poses.npz"), seed=1,
              gender="female")
    write_raw(os.path.join(root, "KIT", "3", "c_poses.npz"), seed=2,
              frames=200)
    write_raw(os.path.join(root, "BioMotionLab_NTroje", "rub001",
                           "treadmill_fast_poses.npz"), seed=3)
    np.savez(os.path.join(root, "KIT", "3", "broken_poses.npz"), fps=60.0)
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _check_npz(a_path, b_path):
    with np.load(a_path, allow_pickle=True) as a, \
            np.load(b_path, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            x, y = a[k], b[k]
            if x.dtype.kind in "US":
                assert x == y, k
                continue
            assert x.shape == y.shape, k
            assert np.abs(x - y).max(initial=0.0) <= 1e-5 + 1e-5 * np.abs(
                y).max(initial=0.0), (k, np.abs(x - y).max())


def test_filenames_match_jax():
    assert TA.output_filename("d/x", 55, 30.0) == JA.output_filename(
        "d/x", 55, 30.0) == "d/x_55_frames_30_fps.npz"
    assert TA.parse_filename("d/x_y_55_frames_30_fps.npz") == (55, 30)
    assert JA.parse_filename("d/x_y_55_frames_30_fps.npz") == (55, 30)


def test_process_file_matches_jax(tmp_path):
    raw = str(tmp_path / "raw.npz")
    write_raw(raw, seed=4, gender="female")
    jp = JA.process_file(JS.synthetic_smpl_model(), raw, str(tmp_path / "j"))
    tp = TA.process_file(TS.synthetic_smpl_model(), raw, str(tmp_path / "t"))
    assert os.path.basename(tp) == os.path.basename(jp)
    _check_npz(tp, jp)
    # discarded: shorter than a second after the trim
    write_raw(str(tmp_path / "short.npz"), frames=60)
    assert TA.process_file(TS.synthetic_smpl_model(),
                           str(tmp_path / "short.npz"),
                           str(tmp_path / "t")) is None


def test_process_amass_matches_jax(tmp_path, capsys):
    raw = _tree(str(tmp_path / "raw"))
    smplh = str(tmp_path / "smplh")
    for gender, seed in (("male", 10), ("female", 20)):
        chip_smoke.write_body_npz(smplh, TS.synthetic_smpl_model(seed),
                                  gender)
    common = ["--amass-root", raw, "--smplh-root", smplh]
    nj = JPA.main(common + ["--out", str(tmp_path / "j"), "--workers", "2"])
    nt = TPA.main(common + ["--out", str(tmp_path / "t"), "--workers", "3",
                            "--device", "cpu"])
    assert nt == nj == 4
    assert capsys.readouterr().out.count("FAILED") == 2   # broken_poses
    files = _files(str(tmp_path / "j"))
    assert _files(str(tmp_path / "t")) == files and len(files) == 4
    for f in files:
        _check_npz(str(tmp_path / "t" / f), str(tmp_path / "j" / f))
    # the gendered bodies were used: the female sequence differs from
    # what the neutral (synthetic) body gives
    b = next(f for f in files if "b_poses" in f)
    neutral = TA.process_file(TS.synthetic_smpl_model(),
                              os.path.join(raw, "CMU", "01", "b_poses.npz"),
                              str(tmp_path / "n"))
    with np.load(str(tmp_path / "t" / b)) as x, np.load(neutral) as y:
        assert np.abs(x["joints"] - y["joints"]).max() > 1e-3
    ds = AmassDataset.from_npz_files(find_processed_files(
        str(tmp_path / "t")))
    # BioMotionLab_NTroje, CMU a, CMU b (female), KIT
    assert ds.num_seqs == 4 and list(ds.gender_ids) == [0, 0, 1, 0]

    # cleanup: the treadmill sequence moves aside, in both packages
    moved_t = TCL.main(["--data-path", str(tmp_path / "t")])
    moved_j = JCL.cleanup(str(tmp_path / "j"))
    rel = lambda paths, root: [os.path.relpath(p, root) for p in paths]
    assert rel(moved_t, str(tmp_path / "t")) == rel(
        moved_j, str(tmp_path / "j")) == [
        os.path.join("BioMotionLab_NTroje", "rub001",
                     "treadmill_fast_poses_55_frames_30_fps.npz")]
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    assert len(find_processed_files(str(tmp_path / "t"))) == 3

    with open(os.path.join(raw, "KIT", "3", "broken_poses.npz"), "wb") as f:
        f.write(b"not an npz")
    assert TPA.main(common + ["--out", str(tmp_path / "t2"), "--device",
                              "cpu", "--datasets", "KIT"]) == 1


def test_cleanup_patterns_match_jax(tmp_path):
    assert TCL.BAD_PATTERNS == JCL.BAD_PATTERNS
    for rel in ("BioMotionLab_NTroje/rub001/treadmill_fast_poses.npz",
                "BioMotionLab_NTroje/rub002/normal_walk_poses.npz",
                "BioMotionLab_NTroje/rub001/walk_poses.npz",
                "MPI_HDM05/dg/HDM_dg_07-01_01_120_poses.npz",
                "MPI_HDM05/bk/HDM_dg_07-01_01_120_poses.npz",
                "CMU/01/01_01_poses.npz"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    root = str(tmp_path)
    bad = TCL.main(["--data-path", root, "--dry-run"])
    assert bad == JCL.find_bad_sequences(root) and len(bad) == 3
    backup = str(tmp_path / "backup")
    assert TCL.main(["--data-path", root, "--backup", backup]) == bad
    assert (tmp_path / "backup/MPI_HDM05/dg/"
            "HDM_dg_07-01_01_120_poses.npz").exists()
    assert TCL.find_bad_sequences(root) == []


def test_process_amass_needs_a_gpu_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPA.main(["--amass-root", str(tmp_path), "--out", str(tmp_path)])


def test_profiling(tmp_path):
    """The trace exporter records the program's spans: the Chrome trace
    it writes holds each span over the ops it ran."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("work"):
            torch.ones(8, 8) @ torch.ones(8, 8)
            profiling.count("products")
    assert profiling.span("a") is profiling.span("b")
    ev = {e.key: e for e in prof.key_averages()}
    assert "aten::matmul" in ev and ev["work"].count == 1
    files = os.listdir(str(tmp_path / "trace"))
    assert files
    text = open(os.path.join(str(tmp_path / "trace"), files[0])).read()
    assert '"work"' in text and "aten::matmul" in text
