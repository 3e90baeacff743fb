"""The benchmark's generators: pinned outputs for a seed, and the
copies held to the port's originals."""

import json
import os

import numpy as np
import pytest
import torch

from helpers import ROOT
from portbench import fit_traffic as FT
from portbench import train_traffic as TT
from portbench import weights as W
from portbench.reference import gmm as RG
from portbench.reference import humor as RH
from portbench.reference import smpl as RS
from portbench.reference import tto as RT
from portbench.reference import vposer as RV


def traffic(name):
    with open(os.path.join(ROOT, "portbench", "traffic", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def models():
    g = torch.Generator().manual_seed(5)
    hw = W.humor_weights(RH.HumorConfig(), 1024, g, 0.1)
    vw = W.vposer_weights(RV.VPoserConfig(), g)
    return RT.TTOModels(
        body=W.body_model(RS.SmplModel, W.synthetic_body(1234, 300), "cpu"),
        vposer_cfg=RV.VPoserConfig(), vposer=vw,
        humor_cfg=RH.HumorConfig(), humor=hw,
        init_gmm=RG.GmmParams(*W.gmm_arrays(12, 138, "cpu")))


def test_body_is_the_ports_synthetic_body():
    from humor_torch.body_model.smpl import synthetic_smpl_model

    port = synthetic_smpl_model(seed=1234, num_verts=6890, num_joints=22)
    ours = W.synthetic_body(1234, 6890)
    for k in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights"):
        assert np.array_equal(getattr(port, k).numpy(), ours[k]), k
    assert np.array_equal(port.parents, ours["parents"])


def test_weights_have_the_ports_layout_and_are_pinned(models):
    from humor_torch.models import humor as H
    from humor_torch.models import vposer as V

    from portbench.reference.step import tree_leaves

    port_h = H.init_params(H.HumorConfig(), torch.Generator().manual_seed(0))
    port_v = V.init_params(V.VPoserConfig(), torch.Generator().manual_seed(0))
    for ours, port in ((models.humor, port_h), (models.vposer, port_v)):
        assert [tuple(t.shape) for t in tree_leaves(ours)] == \
            [tuple(t.shape) for t in tree_leaves(port)]
    hw = models.humor
    assert float(sum(l["w"].abs().sum() for n in hw for l in hw[n])) == \
        pytest.approx(159655.65625, rel=1e-5)
    # the decoder's output layer at a tenth of the init scale
    bound = 0.1 / 560 ** 0.5
    assert float(hw["decoder"][-1]["w"].abs().max()) <= bound
    assert float(hw["decoder"][-1]["b"].sum()) == pytest.approx(
        0.037679288536310196, rel=1e-4)
    assert float(sum(v["w"].abs().sum() for v in models.vposer.values()
                     if "w" in v)) == pytest.approx(38889.37109375, rel=1e-5)


def test_rgb_observation_pinned(models):
    p = traffic("rgb.json")["observation"]
    o = FT.make_observation("rgb", p, models, 2, 20, 3, "cpu")
    assert o["seq_interval"].tolist() == [[0, 20], [10, 30]]
    assert o["joints2d"].shape == (2, 20, 25, 3)
    assert bool((o["joints2d"][..., 2] == 1).all())
    again = FT.make_observation("rgb", p, models, 2, 20, 3, "cpu")
    assert torch.equal(o["joints2d"], again["joints2d"])
    other = FT.make_observation("rgb", p, models, 2, 20, 4, "cpu")
    assert not torch.equal(o["joints2d"], other["joints2d"])
    assert float(o["joints2d"][..., :2].sum()) == pytest.approx(
        1560901.25, rel=1e-5)


def test_prox_observation_pinned(models):
    p = dict(traffic("proxd.json")["observation"], points=64)
    o = FT.make_observation("prox", p, models, 2, 4, 3, "cpu")
    pts = o["points3d"]
    vis = torch.isfinite(pts[..., 0])
    # the last tenth of each frame's rows missing
    assert int((~vis).sum()) == 2 * 4 * int(0.1 * 64)
    assert bool((~vis[..., 64 - int(0.1 * 64):]).all())
    assert float(pts[vis].sum()) == pytest.approx(1791.71826171875, rel=1e-5)
    assert float(o["joints2d"][..., :2].sum()) == pytest.approx(
        322606.1875, rel=1e-5)


def test_sequences_pinned_and_packed_as_the_port_packs_them():
    from humor_torch.data.dataset import AmassDataset
    from humor_torch.data.device_store import DeviceWindowStore
    from humor_torch.data.windows import window_to_pairs

    bodies = {k: W.body_model(RS.SmplModel, W.synthetic_body(s, 300), "cpu")
              for k, s in (("male", 10), ("female", 20))}
    seqs = TT.make_sequences(3, 30, 4, bodies, "cpu")
    assert [s["gender"] for s in seqs] == ["female", "male", "female"]
    assert float(sum(s["joints"].sum() for s in seqs)) == pytest.approx(
        5405.38671875, rel=1e-5)
    assert float(sum(s["contacts"].sum() for s in seqs)) == 43.0
    store = DeviceWindowStore.from_dataset(AmassDataset.from_processed(seqs),
                                           "cpu")
    ref = TT.ReferenceStore(seqs)
    for seed in (0, 12345, 2 ** 31 - 2):
        world, meta = store.sample_window_chunk([seed], 5, 11)
        din, dout, _ = window_to_pairs(world)
        b = ref.batch(seed, 5, 11, "cpu")
        for k in din:
            assert torch.allclose(din[k][0], b["data_in"][k], atol=1e-6), k
            assert torch.allclose(dout[k][0], b["data_out"][k], atol=1e-6), k
        assert torch.equal(meta["betas"][0], b["betas"])
        assert torch.equal(meta["gender_ids"][0], b["gender_ids"])
