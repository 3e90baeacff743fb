"""The HuMoR-Qual training cell (portbench/train_qual_cell.py) on the
CPU: its files load by name, its FLOP count against a hand count, its
readers on records with and without the feedback span, a small run
correct and each fault not correct, and the feedback's readings of a
small chunk."""

import pytest

from helpers import bench, run_small, small_cell
from portbench import counts as K
from portbench import faults as F
from portbench import run as R
from portbench import train_qual_cell as Q

NAME = "train_qual_sched_samp"
READERS = ("train_feedback_device_share", "train_feedback_ms_per_step")


def test_files_load_through_the_cell():
    cell = R.Cell(bench(), NAME)
    assert cell.config["name"] == "humor_qual_train"
    assert cell.config["model_use_smpl_joint_inputs"] is True
    assert cell.traffic["kind"] == "train_qual" and cell.traffic["epoch"] == 30
    assert cell.module().TrainCell.__mro__[1].__module__ == \
        "portbench.train_cell"
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "train_syncs_per_step", "train_mfu", "device_idle_share.train",
        *READERS}
    for m in cell.per_layer:
        assert cell.reader(m["name"]).read({}) is None


def test_step_flops_against_a_hand_count():
    B, T, V = 8, 10, 256
    joints = 2 * V * 3 * 16 + 2 * 22 * V * 3 + 2 * 22 * 45
    assert joints == 60_348
    # two genders' joints for every row of the 9 fed frames
    assert Q.step_flops(B, T, V) == pytest.approx(
        K.train_step_flops(B, T, V) + 2 * 9 * B * joints)


def test_readers_with_and_without_the_span():
    cell = R.Cell(bench(), NAME)
    share, ms = (cell.reader(n) for n in READERS)
    found = {"feedback": {"steps": 8, "host_ms": 240.0, "spans": 72,
                          "device_s": 0.05, "busy_s": 0.4,
                          "syncs_per_step": 18.0, "rows_per_step": 1800.0}}
    assert share.read(found) == pytest.approx(12.5)
    assert ms.read(found) == pytest.approx(30.0)
    # a program without the span (the parent of the cell): nothing read
    none = {"feedback": dict(found["feedback"], host_ms=None, spans=0,
                             device_s=None, syncs_per_step=None)}
    assert share.read(none) is None and ms.read(none) is None
    assert share.read({"feedback": dict(found["feedback"],
                                        busy_s=0.0)}) is None


def test_small_run_is_correct():
    res = run_small(small_cell(NAME))
    assert res["correct"], res["compared"]
    assert all(c["value"] == 0.0 for c in res["compared"].values())


@pytest.mark.parametrize("fault", F.TRAIN_FAULTS + Q.FAULTS)
def test_fault_is_not_correct(fault):
    ctx = Q.qual_fault(fault) if fault in Q.FAULTS else F.train_fault(fault)
    with ctx:
        res = run_small(small_cell(NAME))
    assert not res["correct"], res["compared"]


def test_fault_and_reference_patches_are_undone():
    from humor_torch.train import step as TS
    from portbench.reference import step as RS

    before = (TS.make_rollout_joint_fn, RS.make_train_steps)
    with Q.qual_fault("feedback_off"):
        assert TS.make_rollout_joint_fn(None, None, None) is None
    with Q.qual_reference():
        assert RS.make_train_steps.keywords == {"use_smpl_joint_inputs": True}
    assert before == (TS.make_rollout_joint_fn, RS.make_train_steps)


def test_feedback_regions_on_a_small_chunk():
    cell = small_cell(NAME)
    tc = Q.TrainCell(cell, 5, "cpu")
    state = tc.TS.make_train_state(tc.weights, tc.opt)
    record, breakdown = {}, {}
    Q.feedback_regions(tc, state, record, breakdown, "cpu")
    fb = record["feedback"]
    T = cell.config["sample_num_frames"]
    assert fb["spans"] == tc.k * (T - 1)
    assert fb["rows_per_step"] == tc.B * (T - 1)
    assert breakdown["counters"]["smpl.feedback_rows"] == tc.k * tc.B * (T - 1)
    assert fb["host_ms"] > 0 and fb["syncs_per_step"] == 0
    assert cell.reader("train_feedback_ms_per_step").read(record) == \
        pytest.approx(fb["host_ms"] / tc.k)
