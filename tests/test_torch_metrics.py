"""humor_torch.eval.metrics against humor_tpu.eval.metrics on the same
seeded sequences: every function, per-point arrays within 1e-6, counts,
splits, aggregates and CSVs exactly (the CSV within the float text)."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.eval import metrics as JM

from humor_torch.eval import metrics as TM

T, J = 12, 22


@pytest.fixture(scope="module")
def seqs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    pred = f(T, J, 3) * 0.3 + [0.0, 0.0, 0.1]
    gt = pred + f(T, J, 3) * 0.05
    obs = gt.copy()
    obs[rng.rand(T, J) < 0.3] = np.inf
    gt_imap = f(T, 16, 3) * 0.3 + [0.0, 0.0, 3.0]
    gt_imap[rng.rand(T, 16) < 0.2] = np.inf
    return dict(pred=pred, gt=gt, obs=obs, gt_imap=gt_imap,
                verts_p=f(T, 43, 3), verts_g=f(T, 43, 3),
                contacts_p=(rng.rand(T, 22) > 0.5).astype(np.float32),
                contacts_g=(rng.rand(T, 9) > 0.5).astype(np.float32),
                occ=(rng.rand(T, 16) > 0.6),
                masks=(rng.rand(T, 54, 96) > 0.5).astype(np.uint8),
                floor=np.asarray([0.1, -0.9, 0.05, -0.4], np.float32),
                valid=rng.rand(T) > 0.3)


def _close(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _dicts_close(a, b):
    assert set(a) == set(b)
    for k in b:
        _close(a[k], b[k])


def test_per_point_functions(seqs):
    p, g = seqs["pred"], seqs["gt"]
    pj, gj = jnp.asarray(p), jnp.asarray(g)
    _close(TM.positional_errors(p, g), JM.positional_errors(pj, gj))
    _close(TM.positional_errors(torch.tensor(p), g),
           JM.positional_errors(pj, gj))
    for sub in ("ee", "legs"):
        _close(TM.subset_joint_err(p, g, sub), JM.subset_joint_err(pj, gj,
                                                                   sub))
    for a, b in zip(TM.visibility_split(p, g, seqs["obs"]),
                    JM.visibility_split(pj, gj, jnp.asarray(seqs["obs"]))):
        _close(a, b)
    _close(TM.joint_accel_mag(p), JM.joint_accel_mag(pj))
    _close(TM.align_to_root(p, 3), JM.align_to_root(pj, 3))
    for src, x in (("smpl", p), ("imap", seqs["gt_imap"])):
        _close(TM.to_comparison_skeleton(x, src),
               JM.to_comparison_skeleton(jnp.asarray(x), src))


@pytest.mark.parametrize("floor", [None, "given"])
def test_toe_floor_penetration(seqs, floor):
    fp = None if floor is None else seqs["floor"]
    ct, nt, dt = TM.toe_floor_penetration(seqs["pred"], fp)
    cj, nj, dj = JM.toe_floor_penetration(
        jnp.asarray(seqs["pred"]), None if fp is None else jnp.asarray(fp))
    assert ct == cj and nt == nj and sum(cj) > 0
    _close(dt, dj)


def test_contacts_occlusion_and_blacklist(seqs):
    assert TM.contact_accuracy(seqs["contacts_p"], seqs["contacts_g"]) == \
        JM.contact_accuracy(seqs["contacts_p"], seqs["contacts_g"])
    cam = (80.0, 80.0, 48.0, 27.0)
    g = seqs["gt_imap"]
    np.testing.assert_array_equal(
        TM.occlusion_from_masks(g, seqs["masks"], cam),
        JM.occlusion_from_masks(g, seqs["masks"], cam))
    names = ["MPH1Library_00145_01_0025", "N0Sofa_03403_01_0013", "x"]
    for bl in ("AMASS_EVAL_BLACKLIST", "RGBD_EVAL_BLACKLIST",
               "RGB_EVAL_BLACKLIST"):
        assert getattr(TM, bl) == getattr(JM, bl)
        assert TM.filter_blacklisted(names, getattr(TM, bl)) == \
            JM.filter_blacklisted(names, getattr(JM, bl))


def test_quant_evals_and_aggregate(seqs, tmp_path):
    p, g = seqs["pred"], seqs["gt"]
    pt = {"joints3d": p, "verts3d": seqs["verts_p"],
          "mesh3d": seqs["verts_p"][:, :20], "contacts": seqs["contacts_p"]}
    gt = {"joints3d": g, "verts3d": seqs["verts_g"],
          "mesh3d": seqs["verts_g"][:, :20], "contacts": seqs["contacts_g"]}
    ob = {"joints3d": seqs["obs"]}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    per_t = [TM.quant_eval_3d(pt, gt, ob)]
    per_j = [JM.quant_eval_3d(j(pt), j(gt), j(ob))]
    _dicts_close(per_t[0], per_j[0])
    kw2 = [dict(gt_joints_imap=seqs["gt_imap"], floor_plane=seqs["floor"],
                occlusions=seqs["occ"]),
           dict(gt_joints_imap=seqs["gt_imap"], vis_masks=seqs["masks"],
                cam_intrins=(80.0, 80.0, 48.0, 27.0)),
           {}]
    for kw in kw2:
        per_t.append(TM.quant_eval_2d(p, **kw))
        per_j.append(JM.quant_eval_2d(jnp.asarray(p), **{
            k: (jnp.asarray(v) if k in ("gt_joints_imap", "floor_plane")
                else v) for k, v in kw.items()}))
        _dicts_close(per_t[-1], per_j[-1])
    per_t.append(TM.quant_eval_prox(p, g, seqs["valid"], seqs["floor"]))
    per_j.append(JM.quant_eval_prox(jnp.asarray(p), jnp.asarray(g),
                                    seqs["valid"], jnp.asarray(
                                        seqs["floor"])))
    _dicts_close(per_t[-1], per_j[-1])
    at, aj = TM.aggregate(per_t), JM.aggregate(per_j)
    assert set(at) == set(aj)
    for k in aj:
        assert set(at[k]) == set(aj[k])
        for s in aj[k]:
            np.testing.assert_allclose(at[k][s], aj[k][s], rtol=0,
                                       atol=1e-6, err_msg=f"{k} {s}")
    TM.write_csv(str(tmp_path / "t.csv"), at)
    JM.write_csv(str(tmp_path / "j.csv"), aj)
    rows = {}
    for k in ("t", "j"):
        with open(tmp_path / f"{k}.csv") as f:
            rows[k] = list(csv.reader(f))
    rows_t, rows_j = rows["t"], rows["j"]
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    assert rows_t[0] == rows_j[0]
    for rt, rj in zip(rows_t[1:], rows_j[1:]):
        np.testing.assert_allclose(
            [float(v) if v else np.nan for v in rt[1:]],
            [float(v) if v else np.nan for v in rj[1:]], rtol=0, atol=1e-6)
