"""A whole run of each small cell on the CPU with the timed path broken
underneath (portbench/faults.py), past the harness's look for a chip:
`correct` comes out false for each fault the cell can have."""

import pytest

from helpers import run_small, small_cell
from portbench import faults as F

FITS = ["tto_rgb"]
TRAINS = ["train_sched_samp", "train_supervised"]


@pytest.mark.parametrize("fault", F.FIT_FAULTS)
@pytest.mark.parametrize("name", FITS)
def test_fit_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    with F.fit_fault(fault, cell.config["batch_windows"]):
        res = run_small(cell)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", F.TRAIN_FAULTS)
@pytest.mark.parametrize("name", TRAINS)
def test_train_fault_is_not_correct(name, fault):
    with F.train_fault(fault):
        res = run_small(small_cell(name))
    assert not res["correct"], res["compared"]


def test_faults_are_undone():
    from humor_torch.fitting import optimizer as O
    from humor_torch.ops import rollout_kernel as RK
    from humor_torch.train import step as TS

    before = (O.run_lbfgs, O.make_runner, RK.rollout_backward, TS.elbo_loss,
              TS.make_train_steps, TS._Optimizer.update)
    for fault in F.FIT_FAULTS:
        with F.fit_fault(fault, 2):
            pass
    for fault in F.TRAIN_FAULTS:
        with F.train_fault(fault):
            pass
    assert before == (O.run_lbfgs, O.make_runner, RK.rollout_backward,
                      TS.elbo_loss, TS.make_train_steps,
                      TS._Optimizer.update)
