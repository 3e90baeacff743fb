"""humor_torch's training data pipeline against humor_tpu's on the CPU:
synthetic windows, window pairs, AMASS sequence processing, the packed
frame store, the window sampler (equal indices and noise to the JAX
package's native sampler) and the device store (equal to the host gather
at noise 0, as tests/test_device_store.py pins it in JAX).

Tolerances: synthetic joints 1e-5 m and rotations 1e-6 (float32 SMPL and
Rodrigues in two packages; the numpy draws are equal), pairs 1e-5,
processed sequences 1e-5 (float64 arrays fed by float32 SMPL), sampler
indices exact, its noise 1e-6 (float32 rounding of the same
Box-Muller). Processed velocities 1e-4: central differences over 2/60 s
scale the float32 joint rounding by 30.
"""

import numpy as np
import pytest
import torch

from humor_tpu import native
from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.data import amass as JA
from humor_tpu.data import dataset as JD
from humor_tpu.data import synthetic as JS
from humor_tpu.data import windows as JW

from humor_torch.body_model import smpl as tsmpl
from humor_torch.data import amass as TA
from humor_torch.data import dataset as TD
from humor_torch.data import device_store as TDS
from humor_torch.data import sampler as TSam
from humor_torch.data import synthetic as TSyn
from humor_torch.data import windows as TW

torch.set_num_threads(2)

BODY_J = jsmpl.synthetic_smpl_model()
BODY_T = tsmpl.synthetic_smpl_model()


def test_synthetic_world_batch_and_pairs_match_jax():
    wj, mj = JS.synthetic_world_batch(3, 4, 8, model=BODY_J)
    wt, mt = TSyn.synthetic_world_batch(3, 4, 8, model=BODY_T)
    np.testing.assert_array_equal(mt["gender_ids"].numpy(),
                                  np.asarray(mj["gender_ids"]))
    np.testing.assert_allclose(mt["betas"].numpy(), np.asarray(mj["betas"]),
                               atol=0)
    for k, v in wj.items():
        atol = 1e-5 if k in ("joints", "joints_vel", "root_orient_vel") \
            else 1e-6
        if k == "joints_vel":
            atol = 1e-3     # (x_{t+1} - x_t) * fps of 1e-5 m joints
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(v), atol=atol,
                                   err_msg=k)
    # pairs from one world: the functions themselves at 1e-5
    pj = JW.window_to_pairs(wj)
    pt = TW.window_to_pairs({k: torch.as_tensor(np.array(v))
                             for k, v in wj.items()})
    for a, b in zip(pt, pj):
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=1e-5, err_msg=k)
    gj = JW.window_to_global(wj)
    gt = TW.window_to_global({k: torch.as_tensor(np.array(v))
                              for k, v in wj.items()})
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   atol=1e-5, err_msg=k)


def _raw(seed=0, n=200):
    rng = np.random.RandomState(seed)
    return {"fps": np.asarray(60.0), "gender": "female",
            "trans": np.cumsum(rng.randn(n, 3) * 0.01, axis=0),
            "root_orient": rng.randn(n, 3) * 0.2,
            "pose_body": rng.randn(n, 63) * 0.1,
            "betas": rng.randn(16) * 0.3}


def test_process_sequence_and_pack_match_jax():
    sj = JA.process_sequence(BODY_J, _raw(), discard_terrain=False)
    st = TA.process_sequence(BODY_T, _raw(), discard_terrain=False)
    assert set(st) == set(sj)
    for k, v in sj.items():
        if isinstance(v, str):
            assert st[k] == v
            continue
        # velocities are central differences over 2/60 s: 30x the
        # float32 joint rounding
        tol = 1e-4 if "vel" in k else 1e-5
        np.testing.assert_allclose(np.asarray(st[k], np.float64),
                                   np.asarray(v, np.float64), atol=tol,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(TD.pack_frames(st), JD.pack_frames(sj),
                               atol=1e-4, rtol=1e-5)
    assert TD.FRAME_DIM == JD.FRAME_DIM


@pytest.mark.parametrize("seed", [0, 11, 987654321])
def test_sampler_matches_native(seed):
    assert native.native_available()
    lengths = np.array([50, 3, 120, 0, 77, 11, 400])
    a = native.sample_windows(lengths, 11, seed, 257)
    b = TSam.sample_windows(lengths, 11, seed, 257)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    store = np.random.RandomState(seed % 7).randn(lengths.sum(), 30) \
        .astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    x = native.gather_windows(store, off, *b, 11, noise_std=0.1, seed=seed)
    y = TSam.gather_windows(store, off, *b, 11, noise_std=0.1, seed=seed)
    np.testing.assert_allclose(y, x, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        TSam.gather_windows(store, off, *b, 11),
        native.gather_windows(store, off, *b, 11))
    np.testing.assert_array_equal(
        TSam.gather_rows(store[:9], b[0] % 9),
        native.gather_rows(store[:9], b[0] % 9))


def test_device_store_equals_host_gather():
    seqs = [TA.process_sequence(BODY_T, _raw(s), discard_terrain=False)
            for s in range(3)]
    ds = TD.AmassDataset.from_processed(seqs)
    store = TDS.maybe_stage(ds, "cpu", mode=1)
    assert TDS.maybe_stage(ds, "cpu", mode=-1) is None   # no CPU budget
    assert TDS.maybe_stage(ds, "cpu", mode=0) is None
    for seed in (0, 5):
        world_h, meta_h = ds.sample_windows(seed, 6, 11)
        world_d, meta_d = store.sample_windows(seed, 6, 11)
        for k in TDS.TRAIN_COLUMNS:
            np.testing.assert_array_equal(world_d[k].numpy(), world_h[k])
        np.testing.assert_array_equal(meta_d["betas"].numpy(),
                                      meta_h["betas"])
        np.testing.assert_array_equal(meta_d["gender_ids"].numpy(),
                                      meta_h["gender_ids"] % 2)
    noisy, _ = store.sample_windows(0, 6, 11, noise_std=0.01)
    clean, _ = store.sample_windows(0, 6, 11)
    d = (noisy["trans"] - clean["trans"]).numpy()
    assert 0.005 < d.std() < 0.02


def test_processed_files_found_split_and_loaded(tmp_path):
    """Processed npz files in the AMASS layout: found, split and loaded
    as the JAX package does, and the train CLI's build_dataset takes them
    over the synthetic fallback."""
    from types import SimpleNamespace

    from humor_torch.train import cli as TC

    paths = []
    for i, ds_name in enumerate(["CMU", "CMU", "KIT", "SFU"]):
        seq = TA.process_sequence(BODY_T, _raw(i), discard_terrain=False)
        d = tmp_path / ds_name / f"subj{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        n = seq["trans"].shape[0]
        path = str(d / f"seq{i}_{n}_frames_30_fps.npz")
        np.savez(path, **seq)
        paths.append(path)
    root = str(tmp_path)
    for names in (None, ["CMU", "SFU"], ["KIT"]):
        assert TD.find_processed_files(root, names) == \
            JD.find_processed_files(root, names)
    assert TD.find_processed_files(root, None, custom_split=["subj1"]) == \
        JD.find_processed_files(root, None, custom_split=["subj1"])
    found = TD.find_processed_files(root)
    for split_by in ("sequence", "subject", "dataset", "single"):
        assert TD.split_files(found, split_by) == JD.split_files(found,
                                                                 split_by)
    dt, dj = TD.AmassDataset.from_npz_files(found), \
        JD.AmassDataset.from_npz_files(found)
    np.testing.assert_array_equal(dt.lengths, dj.lengths)
    np.testing.assert_array_equal(dt.gender_ids, dj.gender_ids)
    np.testing.assert_allclose(dt.store, dj.store, atol=1e-6)
    for k, v in dj.sequence(2).items():
        np.testing.assert_allclose(dt.sequence(2)[k], v, atol=1e-6)
    cfg = SimpleNamespace(data_path=root)
    ds = TC.build_dataset(cfg, (), default_names=TA.TRAIN_DATASETS)
    assert ds.num_seqs == 3          # the CMU and KIT files
    ds = TC.build_dataset(cfg, ("SFU",))
    assert ds.num_seqs == 1
