"""Tests on the card, at each cell's own size (they skip without one):

    python -m pytest portbench/tests/test_pb_card.py -q

The control (the plain reference in TF32 put in the program's place)
must come out not correct; a short run of each cell must come out
correct."""

import time
import types

import pytest

from helpers import bench
from portbench import control as CT
from portbench import run as R

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    cell = R.Cell(bench(), name)
    read = CT.control_reading(cell, 4_000_000_000, device=card)
    assert any(v > cell.limits[k] for k, v in read.items()), read


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, card):
    cell = R.Cell(bench(), name)
    args = types.SimpleNamespace(seed=4_000_000_001, seconds=1.0, trace=0)
    res = R.run_cell(cell, args, time.perf_counter(), device=card)
    assert res["correct"], res["compared"]
