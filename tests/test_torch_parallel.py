"""humor_torch's data-parallel layer on the CPU (humor_torch/parallel,
the counterpart of humor_tpu/parallel/mesh.py): the mesh helpers, the
differentiable gather, and data-parallel training at world 2 over gloo
in 2 processes against world 1 in this one, with the same weights and
the same global draws (single steps, k-step chunks and the trainer over
the device store's chunk source). Mirrors tests/test_train_multi.py's
sharded k-step case. The gather, the four step cases and the trainer run
in one launch of 2 ranks for the module (`world2`).

Limits, each beside the gap measured on the CPU (HuMoR 1024/48, 8
windows of 4 transitions, Adamax at lr 1e-4):
  * the loss of each step: 1e-5 relative (measured 8.7e-8 over single
    steps, 2.7e-7 over a chunk of 3);
  * the first step's gradient: 1e-4 max-scaled, leaf by leaf (measured
    5.2e-7);
  * the params after n steps: 1e-6 abs where the first step's gradient
    is over 1e-3 of its leaf's largest (measured 1.2e-7), 2 n lr anywhere
    (measured 1.3e-5: a weight whose gradient is within its float32
    error of 0 may step the other way, as in
    tests/test_torch_train_step.py);
  * the trainer's params after 8 steps: the norm of their gap within
    2e-4 (measured 3.8e-5), its losses within 1e-5 relative;
  * every rank's params equal, bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from humor_tpu.body_model.smpl import synthetic_smpl_model
from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs
from humor_tpu.models import humor as JH

from humor_torch import convert
from humor_torch.models import humor as TH
from humor_torch.parallel import launch
from humor_torch.parallel import mesh as P
from humor_torch.train.trainer import Trainer, TrainRunConfig
from tests.test_dataset import _make_processed

import torch_parallel_workers as W

torch.set_num_threads(2)

B, T, L = 8, 4, 48
LR = 1e-4
TIMEOUT = 240.0
BODY = synthetic_smpl_model()


def _batch(seed):
    world, meta = synthetic_world_batch(seed, B, T + 1, model=BODY)
    data_in, data_out, _ = window_to_pairs(world)
    t = lambda x: torch.as_tensor(np.array(x))
    return {"data_in": {k: t(v) for k, v in data_in.items()},
            "data_out": {k: t(v) for k, v in data_out.items()},
            "betas": t(meta["betas"]),
            "gender_ids": t(meta["gender_ids"]).long()}


@pytest.fixture(scope="module")
def params():
    return convert.params_tree(jax.tree_util.tree_map(
        np.asarray, JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(0))))


def _draws(phase, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    if phase == "sup":
        return [torch.randn(B * T, L, generator=g) for _ in range(n)]
    out = []
    for _ in range(n):
        use_gt = torch.rand(T, generator=g) < 0.5
        use_gt[0] = True
        out.append((use_gt, torch.randn(T, B, L, generator=g)))
    return out


def _max_scaled(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _check_params(ranks, ref, grads, steps):
    for r in ranks[1:]:
        for a, b in zip(r["params"], ranks[0]["params"]):
            assert torch.equal(a, b)
    for a, b, g in zip(ranks[0]["params"], ref["params"], grads):
        big = g.abs() > 1e-3 * g.abs().max()
        assert (a - b).abs()[big].max() <= 1e-6 if big.any() else True
        assert (a - b).abs().max() <= 2 * steps * LR + 1e-7


def _step_case(phase, k):
    """(batches, draws) of a step case: two single steps, or a chunk of
    3 (other draws)."""
    if k == 1:
        return [_batch(s) for s in range(2)], _draws(phase, 2)
    return [_batch(s) for s in range(3)], _draws(phase, 3, seed=1)


CASES = [(phase, k) for k in (1, 3) for phase in ("sup", "ss")]


@pytest.fixture(scope="module")
def processed():
    return _make_processed()


@pytest.fixture(scope="module")
def world2(params, processed, tmp_path_factory):
    """Every world-2 rank function of this module in one launch: the
    gather, the step cases (CASES; the supervised single steps with the
    SMPL losses) and the trainer (writing under `out`). Returns rank
    0's and rank 1's results by name."""
    out = str(tmp_path_factory.mktemp("dp") / "w2")
    todo = [("gather_grad", (3,))]
    for phase, k in CASES:
        batches, draws = _step_case(phase, k)
        todo.append(("train_steps", (phase, params, batches, draws, LR, k,
                                     phase == "sup" and k == 1)))
    todo.append(("trainer_fit", (processed, out, 2)))
    ranks = launch.spawn(W.jobs, 2, args=(todo,), timeout=TIMEOUT)
    names = ["gather"] + CASES + ["trainer"]
    return {"out": out, **{n: [r[i] for r in ranks]
                           for i, n in enumerate(names)}}


def test_shard_batch_rows_and_padding():
    """A rank's contiguous rows along the batch axis (axis 1 for a
    k-stacked chunk); a batch W does not divide raises."""
    mesh = P.Mesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    tree = {"a": torch.arange(16).reshape(4, 4), "n": 5,
            "c": [torch.arange(8).reshape(2, 4)]}
    s = P.shard_batch(mesh, tree)
    assert torch.equal(s["a"], tree["a"][2:]) and s["n"] == 5
    assert torch.equal(s["c"][0], tree["c"][0][1:])
    s1 = P.shard_batch(mesh, tree, batch_axis_index=1)
    assert torch.equal(s1["c"][0], tree["c"][0][:, 2:])
    assert torch.equal(s1["a"], tree["a"][:, 2:])
    with pytest.raises(ValueError, match="does not split over 2"):
        P.shard_batch(mesh, {"x": torch.zeros(3, 2)})
    assert P.local_rows(mesh, 8) == slice(4, 8)
    assert P.pad_to_multiple(10, 4) == 12 and P.pad_to_multiple(8, 4) == 8


def test_gather_backward_sums_every_ranks_cotangent(world2):
    """all_gather_batch rebuilds the batch on every rank; a term charged
    on rank 0 alone gives each rank the gradient of its own rows, once."""
    res = world2["gather"]
    want = torch.tensor([[0.0], [1.0], [2.0], [10.0], [11.0], [12.0]])
    for r, out in enumerate(res):
        assert torch.equal(out["gathered"], want)
        assert torch.equal(out["grad"], 2.0 * want[3 * r:3 * r + 3])
        assert out["max"] == 1.0


@pytest.mark.parametrize("phase", ["sup", "ss"])
def test_dp_steps_world2_match_world1(params, world2, phase):
    """Two single steps at world 2 (each rank its 4 rows, the global
    draws) against world 1: losses, the first step's averaged gradient,
    the params; the supervised phase with the SMPL losses on synthetic
    gendered bodies."""
    batches, draws = _step_case(phase, 1)
    smpl = phase == "sup"
    ref = W.train_steps(None, phase, params, batches, draws, LR, 1, smpl)
    ranks = world2[(phase, 1)]
    for r in ranks:
        torch.testing.assert_close(r["losses"], ref["losses"], rtol=1e-5,
                                   atol=0)
        worst = max(_max_scaled(a, b) for a, b in zip(r["grads"],
                                                       ref["grads"]))
        assert worst <= 1e-4, worst
    _check_params(ranks, ref, ref["grads"], 2)


@pytest.mark.parametrize("phase", ["sup", "ss"])
def test_dp_multi_steps_world2(params, world2, phase):
    """A chunk of 3 steps at world 2 (shard_batch on the chunk's axis 1)
    against the same chunk at world 1 (tests/test_train_multi.py's
    sharded k-step case, held to values)."""
    batches, draws = _step_case(phase, 3)
    ref = W.train_steps(None, phase, params, batches, draws, LR, 3)
    grads = W.train_steps(None, phase, params, batches[:1], draws[:1], LR,
                          1)["grads"]
    ranks = world2[(phase, 3)]
    assert ranks[0]["losses"].shape == (3,)
    torch.testing.assert_close(ranks[0]["losses"], ref["losses"], rtol=1e-5,
                               atol=0)
    _check_params(ranks, ref, grads, 3)


def test_dp_trainer_world2_matches_world1(tmp_path, processed, world2):
    """The trainer over the store's chunk source at k = 2 (2 epochs of 4
    steps, supervised then scheduled sampling, with validation) at world
    2 against world 1; rank 0 alone writes the stats and checkpoints."""
    ref = W.trainer_fit(None, processed, str(tmp_path / "w1"), 2)
    assert ref["ranks"] == 1 and ref["step"] == 8
    out = world2["out"]
    ranks = world2["trainer"]
    assert [r["ranks"] for r in ranks] == [2, 2]
    for r in ranks[1:]:
        for a, b in zip(r["params"], ranks[0]["params"]):
            assert torch.equal(a, b)
    for a, b in zip(ranks[0]["params"], ref["params"]):
        assert (a - b).abs().max() <= 2 * 8 * 1e-4 + 1e-7
    gap = sum(float(((a - b) ** 2).sum()) for a, b in
              zip(ranks[0]["params"], ref["params"]))
    assert gap ** 0.5 <= 2e-4
    for k in ("min_train_loss", "min_val_loss"):
        assert ranks[0][k] == pytest.approx(ref[k], rel=1e-5), k
    with open(os.path.join(out, "stats.jsonl")) as f:
        assert len(f.readlines()) == 4          # 2 chunks an epoch, once
    for name in ("epoch_0000.npz", "epoch_0001.npz", "final_model.npz"):
        assert os.path.exists(os.path.join(out, name)), name


def test_train_cli_under_torchrun_world2(tmp_path):
    """`torchrun --nproc-per-node 2 -m humor_torch.train.cli` on the CPU
    (gloo): one epoch of 4 steps at k = 2 on the synthetic sequences,
    data-parallel over 2 ranks; rank 0 alone writes the log, the stats
    (one row a chunk) and the checkpoints."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "humor_torch.train.cli",
         "@" + os.path.join(root, "configs", "train_humor.cfg"),
         "--device", "cpu", "--batch-size", "4", "--epochs", "1",
         "--steps-per-epoch", "4", "--steps-per-dispatch", "2",
         "--data-on-device", "1", "--val-every", "1", "--print-every", "1",
         "--out", str(out), "--data-path", str(tmp_path / "no_data"),
         "--smplh-root", str(tmp_path / "no_bodies")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "stats.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [2, 4]
    with open(out / "train.log") as f:
        log = f.read()
    assert log.count("log opened") == 1
    assert "data-parallel over 2 ranks" in log and "val_loss" in log
    for name in ("best_train_model.npz", "best_model.npz",
                 "final_model.npz"):
        assert (out / name).exists(), name


def test_dp_trainer_needs_a_process_group(tmp_path, monkeypatch):
    """A torchrun-style launch (WORLD_SIZE > 1) with no process group
    raises instead of training unrelated copies; an explicit mesh needs
    one too."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    rc = TrainRunConfig(out_dir=str(tmp_path), epochs=1)
    with pytest.raises(RuntimeError, match="init_from_env"):
        Trainer(TH.HumorConfig(), None, rc, train_batches=lambda e: [],
                device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        P.make_mesh()
