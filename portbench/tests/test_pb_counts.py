"""The work counts against hand sums at one shape."""

import pytest

from portbench import counts as K

# prior 339-1024-1024-1024-1024-96, decoder 387-1024-(1024+48)-(512+48)-216
PRIOR = 339 * 1024 + 1024 * 1024 * 3 + 1024 * 96        # 3,591,168
DECODER = 387 * 1024 + 1072 * 1024 + 1072 * 512 + 560 * 216  # 2,163,840


def test_rollout_flops_and_bounds():
    assert K.PRIOR_MACS == 3_591_168 and K.DECODER_MACS == 2_163_840
    flops = K.rollout_flops(16, 59)
    assert flops == 2 * 16 * 59 * 5_755_008 == 10_865_455_104
    # operation-bound at the fit's M = 16, T = 59: 0.162 / 0.324 ms
    assert K.fwd_bound(16, 59) == pytest.approx(flops / 67e12)
    assert K.fwd_bound(16, 59) * 1e3 == pytest.approx(0.16217, rel=1e-4)
    assert K.bwd_bound(16, 59) * 1e3 == pytest.approx(0.32434, rel=1e-4)
    # weights: 3,586,048 + 4,192 prior, 2,163,840 + 2,776 decoder, 4 bytes
    assert K.ROLLOUT_WEIGHT_BYTES == 4 * (3_591_168 + 4_192 + 2_163_840
                                          + 2_776)


def test_nn_bound():
    assert K.nn_flops(960, 4096, 6890) == 162_555_494_400
    # 2.43 ms of operations against 0.047 ms of bytes
    assert K.nn_bound(960, 4096, 6890) * 1e3 == pytest.approx(2.42620,
                                                               rel=1e-4)


def test_smpl_flops():
    per = (2 * 6890 * 3 * 16 + 2 * 22 * 6890 * 3 + 2 * 22 * 45
           + 2 * 9 * 21 * 3 * 43 + 2 * 43 * 22 * 12 + 2 * 43 * 12)
    assert per == 1_645_398
    assert K.smpl_flops(10, 43, 6890) == 10 * per


def test_fit_evaluations():
    ev = K.fit_evaluations((30, 80, 70), (30, 55), 15, 2, 60, 8, False)
    # one start at K = 1 for each stage and stage-3 phase, then one
    # K-candidate batch an iteration
    assert len(ev) == 5 + 180
    assert sum(e.rows == 2 for e in ev) == 5
    assert sum(e.rows == 16 for e in ev) == 180
    assert [e.frames for e in ev if e.stage == "stage3"].count(15) == 31
    w = K.fit_work(ev, 2, 60, 6890, 6890, 4096)
    # one search an evaluation over every frame of every row
    assert w["nn_bound_s"] == pytest.approx(
        K.nn_bound(120, 4096, 6890) * 2 + K.nn_bound(960, 4096, 6890) * 110
        + K.nn_bound(30, 4096, 6890) + K.nn_bound(240, 4096, 6890) * 30
        + K.nn_bound(120, 4096, 6890) * 2 + K.nn_bound(960, 4096, 6890) * 40)
    assert w["rollout_fwd_bound_s"] == pytest.approx(
        K.fwd_bound(2, 14) + 30 * K.fwd_bound(16, 14)
        + 2 * K.fwd_bound(2, 59) + 40 * K.fwd_bound(16, 59)
        + K.fwd_bound(2, 59))


def test_train_step_flops():
    rows = 200 * 10
    enc = 678 * 1024 + 3 * 1024 * 1024 + 1024 * 96
    mlp = 2 * rows * (enc + PRIOR + DECODER)
    skin = 2 * rows * (2 * 6890 * 3 * 16 + 2 * 22 * 6890 * 3 + 2 * 22 * 45
                       + 2 * 9 * 21 * 3 * 6890 + 2 * 6890 * 22 * 12
                       + 2 * 6890 * 12)
    assert K.train_step_flops(200, 10, 6890) == pytest.approx(
        3 * mlp + 4 * skin)
