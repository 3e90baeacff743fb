"""HuMoR-Qual training (configs/train_humor_qual.cfg): the SMPL joints of
each fed-back frame in the scheduled-sampling rollout.

  * a chunk of k scheduled-sampling steps through make_multi_steps
    against the benchmark's plain reference (portbench/reference/step.py)
    with use_smpl_joint_inputs, from the same seeded random weights,
    batches and draws: the losses, Adamax's first moment and the params;
  * the joints-only feedback against the full gendered forward's joints,
    on a mixed-gender batch, on the CPU and (marked `cuda`) on the card at
    a training step's 200 rows and 6,890 vertices;
  * the span "train.smpl_feedback" and the counter "smpl.feedback_rows",
    once a fed frame;
  * the benchmark's feedback_off fault (portbench/train_qual_cell.py).

CPU, small sizes, no JAX, a few seconds. The card's test, with no
conftest (it sets up JAX):

    python -m pytest --noconftest tests/test_torch_qual_train.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from humor_torch.body_model import gendered as G
from humor_torch.body_model.smpl import SmplModel, synthetic_smpl_model
from humor_torch.data.synthetic import synthetic_world_batch
from humor_torch.data.windows import window_to_pairs
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as H
from humor_torch.ops import transforms
from humor_torch.train import step as TS
from humor_torch.utils import profiling as PR
from portbench import train_qual_cell as Q
from portbench import weights as W
from portbench.reference import humor as RH
from portbench.reference import smpl as RSM
from portbench.reference import step as RS
from portbench.reference.elbo import LossConfig as RLossConfig

B, T, K, VERTS, HIDDEN = 4, 5, 3, 256, 64
EPOCH = 30          # past sched_samp_end: every frame fed back
LR = 1e-3


def _bodies(cls, verts=VERTS, device="cpu"):
    return {g: W.body_model(cls, W.synthetic_body(seed, verts), device)
            for g, seed in (("male", 10), ("female", 20))}


def _batch(seed, bodies):
    world, meta = synthetic_world_batch(seed, B, T + 1, model=bodies["male"])
    data_in, data_out, _ = window_to_pairs(world)
    return {"data_in": data_in, "data_out": data_out,
            "betas": meta["betas"], "gender_ids": meta["gender_ids"]}


@pytest.fixture(scope="module")
def chunk():
    """The program's bodies, weights, k batches and draws (use_gt all
    False, the posterior noise), and the reference's bodies."""
    torch.manual_seed(0)
    bodies = _bodies(SmplModel)
    weights = W.humor_weights(RH.HumorConfig(), HIDDEN,
                              torch.Generator().manual_seed(1))
    batches = [_batch(s, bodies) for s in range(K)]
    g = torch.Generator().manual_seed(2)
    draws = {"use_gt": torch.zeros(K, T, dtype=torch.bool),
             "eps": torch.randn(K, T, B, 48, generator=g)}
    return bodies, weights, batches, draws, _bodies(RSM.SmplModel)


def _program_chunk(chunk, use_smpl_joint_inputs=True):
    bodies, weights, batches, draws, _ = chunk
    opt = TS.make_optimizer(lr=LR, steps_per_epoch=10)
    sup, ss, _ = TS.make_train_steps(
        H.HumorConfig(), LossConfig(), opt, bodies,
        use_smpl_joint_inputs=use_smpl_joint_inputs)
    multi_ss = TS.make_multi_steps(sup, ss, K)[1]
    state, stats = multi_ss(TS.make_train_state(weights, opt),
                            TS.stack_batches(batches), EPOCH, 0.0, **draws)
    return state, stats


def _leaves(tree):
    return [p.detach() for p in TS.tree_leaves(tree)]


def test_chunk_matches_the_reference(chunk):
    """The port's chunk of K HuMoR-Qual steps against the reference's K
    single steps. Equal bit for bit: on the CPU the port runs the
    reference's own float32 ops in the same order (the skinning's plain
    einsums; the joints-only feedback gives the full forward's joints
    bit for bit, test below), and a chunk equals its single steps bit for
    bit (tests/test_torch_multi_step.py). So the tolerance is 0; the
    benchmark's limits (portbench/limits/train_qual_sched_samp.json) hold
    the card to the same reference."""
    _, weights, batches, draws, ref_bodies = chunk
    state, stats = _program_chunk(chunk)
    opt = RS.make_optimizer(lr=LR, steps_per_epoch=10)
    _, ss = RS.make_train_steps(RH.HumorConfig(), RLossConfig(), opt,
                                ref_bodies, use_smpl_joint_inputs=True)
    ref = RS.make_train_state(weights, opt)
    losses = []
    for i, b in enumerate(batches):
        ref, s = ss(ref, b, EPOCH, 0.0, **{k: v[i] for k, v in draws.items()})
        losses.append(s["total_loss"])
    assert torch.equal(stats["total_loss"], torch.stack(losses))
    for a, b in zip(_leaves(state.opt_state["mu"]),
                    _leaves(ref.opt_state["mu"])):
        assert torch.equal(a, b)
    moved = 0
    for a, b, p0 in zip(_leaves(state.params), _leaves(ref.params),
                        _leaves(weights)):
        assert torch.equal(a, b)
        moved += int((a != p0).sum())
    assert moved > 0


def test_feedback_off_fault_changes_the_loss(chunk):
    """The benchmark's feedback_off fault feeds back the decoder's joints,
    as HuMoR does: the same chunk's losses differ from every step on,
    and equal those of steps built without the feedback."""
    _, stats = _program_chunk(chunk)
    with Q.qual_fault("feedback_off"):
        _, off = _program_chunk(chunk)
    _, plain = _program_chunk(chunk, use_smpl_joint_inputs=False)
    assert (stats["total_loss"] != off["total_loss"]).all()
    assert torch.equal(off["total_loss"], plain["total_loss"])


def _joint_inputs(rows, device):
    """A mixed-gender batch (odd rows female) of random poses."""
    g = torch.Generator().manual_seed(3)
    R = transforms.aa_to_rotmat(0.6 * torch.randn(rows, 22, 3, generator=g))
    x = {"gender_ids": torch.arange(rows) % 2,
         "betas": 0.5 * torch.randn(rows, 16, generator=g),
         "trans": torch.randn(rows, 3, generator=g),
         "root": R[:, 0].reshape(rows, 9),
         "pose": R[:, 1:].reshape(rows, -1)}
    return {k: v.to(device) for k, v in x.items()}


def _feedback_against_forward(bodies, rows, device):
    x = _joint_inputs(rows, device)
    gid = x["gender_ids"]
    fed = G.make_rollout_joint_fn(bodies, gid, x["betas"])(
        x["trans"], x["root"], x["pose"])
    root_aa = transforms.rotmat_to_aa(x["root"].reshape(rows, 3, 3))
    pose_aa = transforms.rotmat_to_aa(
        x["pose"].reshape(rows, -1, 3, 3)).reshape(rows, -1)
    full = G.gendered_forward(bodies, gid, root_aa, pose_aa, x["betas"],
                              x["trans"]).Jtr[:, :22].reshape(rows, -1)
    return fed, full


@pytest.mark.parametrize("vertex_joints", [0, 3])
def test_joints_only_feedback_equals_the_full_forward(vertex_joints):
    """Bit for bit, with and without vertex joints appended to Jtr: the
    posed joints come from the kinematic chain over the shaped template,
    whichever vertices are skinned."""
    bodies = {g: dataclasses.replace(
        synthetic_smpl_model(seed, num_verts=VERTS),
        vtx_joint_ids=np.arange(vertex_joints, dtype=np.int32) * 7)
        for g, seed in (("male", 10), ("female", 20))}
    fed, full = _feedback_against_forward(bodies, 16, "cpu")
    assert torch.equal(fed, full)
    # the female rows take the female body
    x = _joint_inputs(16, "cpu")
    male = G.make_rollout_joint_fn(bodies, torch.zeros_like(x["gender_ids"]),
                                   x["betas"])(x["trans"], x["root"],
                                               x["pose"])
    assert torch.equal(male[::2], fed[::2])
    assert (male[1::2] != fed[1::2]).any(dim=1).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the float32 skinning runs through "
                    "the CUDA kernels only there")
    return "cuda"


@pytest.mark.cuda
def test_joints_only_feedback_equals_the_full_forward_on_the_card(card):
    """At a training step's 200 rows on 6,890-vertex bodies, where the
    full forward skins through the CUDA kernels."""
    fed, full = _feedback_against_forward(
        _bodies(SmplModel, verts=6890, device=card), 200, card)
    assert torch.equal(fed, full)


def test_feedback_span_and_counter_once_a_fed_frame(chunk):
    bodies, weights, batches, draws, _ = chunk
    opt = TS.make_optimizer(lr=LR, steps_per_epoch=10)
    _, ss, _ = TS.make_train_steps(H.HumorConfig(), LossConfig(), opt,
                                   bodies, use_smpl_joint_inputs=True)
    with PR.recording() as rec:
        ss(TS.make_train_state(weights, opt), batches[0], EPOCH, 0.0,
           **{k: v[0] for k, v in draws.items()})
    fed = [i for i, s in enumerate(rec.spans)
           if s.name == "train.smpl_feedback"]
    assert len(fed) == T - 1
    assert rec.counters["smpl.feedback_rows"] == B * (T - 1)
    assert all(rec.spans[rec.spans[i].parent].name == "train.forward"
               for i in fed)
    # both gendered bodies under each feedback span; four in the losses
    smpl = [i for i, s in enumerate(rec.spans) if s.name == "smpl"]
    assert sum(rec.under(i, "train.smpl_feedback") for i in smpl) == \
        2 * (T - 1)
    assert len(smpl) == 2 * (T - 1) + 4
    # off: nothing recorded, and the steps without the feedback count none
    _, plain, _ = TS.make_train_steps(H.HumorConfig(), LossConfig(), opt,
                                      bodies)
    with PR.recording() as rec:
        plain(TS.make_train_state(weights, opt), batches[0], EPOCH, 0.0,
              **{k: v[0] for k, v in draws.items()})
    assert "train.smpl_feedback" not in rec.by_name()
    assert "smpl.feedback_rows" not in rec.counters
