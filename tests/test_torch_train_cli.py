"""The port's training CLI on the CPU at a tiny size (batch 4, 2 steps an
epoch) on the synthetic sequences and bodies: configs/train_humor.cfg
through the supervised and scheduled-sampling phases,
configs/train_humor_qual.cfg with its SMPL-joint feedback, a resume from
the final checkpoint, and the flags the port refuses."""

import json
import os

import numpy as np
import pytest
import torch

from humor_torch import convert
from humor_torch.train import cli as TC
from humor_torch.utils.config import TrainCLIConfig, parse_into

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "train_humor.cfg")
QUAL = os.path.join(ROOT, "configs", "train_humor_qual.cfg")


def _argv(cfg, out, *extra):
    return ["@" + cfg, "--device", "cpu", "--batch-size", "4",
            "--steps-per-epoch", "2", "--out", str(out),
            "--data-path", str(out / "no_data"),
            "--smplh-root", str(out / "no_bodies"), "--val-every", "1",
            "--print-every", "1", *extra]


def _stats(out):
    with open(out / "stats.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_cli_writes_log_stats_and_checkpoints(tmp_path):
    out = tmp_path / "run"
    res = TC.main(_argv(CFG, out, "--epochs", "3", "--sched-samp-start",
                        "0", "--sched-samp-end", "2"))
    assert np.isfinite(res["min_train_loss"])
    for name in ("train.log", "stats.jsonl", "best_train_model.npz",
                 "best_model.npz", "final_model.npz"):
        assert (out / name).exists(), name
    rows = _stats(out)
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["total_loss"]) for r in rows)
    with open(out / "train.log") as f:
        log = f.read()
    # epoch 0 teacher-forced, 1 mixed, 2 fully scheduled sampling
    for p in ("gt_p=1.00", "gt_p=0.50", "gt_p=0.00"):
        assert p in log, p
    ck = convert.load_checkpoint(str(out / "final_model.npz"))
    assert ck["epoch"] == 2
    assert ck["params"]["decoder"][0]["w"].shape == (387, 1024)

    # resume: continues at epoch 3 from the saved optimizer state
    TC.main(_argv(CFG, out, "--epochs", "4", "--ckpt",
                  str(out / "final_model.npz")))
    with open(out / "train.log") as f:
        assert "at epoch 3" in f.read()
    assert [r["step"] for r in _stats(out)][-2:] == [1, 2]


def test_qual_config_runs_smpl_joint_feedback(tmp_path):
    out = tmp_path / "qual"
    TC.main(_argv(QUAL, out, "--epochs", "2", "--sched-samp-start", "0",
                  "--sched-samp-end", "1"))
    rows = _stats(out)
    assert len(rows) == 4 and all(np.isfinite(r["total_loss"])
                                  for r in rows)
    with open(out / "train.log") as f:
        assert "gt_p=0.00" in f.read()


def test_train_cli_needs_a_gpu_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    argv = _argv(CFG, tmp_path)
    argv = argv[:1] + argv[3:]          # no --device cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.main(argv)


@pytest.mark.parametrize("flags", [["--model-compute-dtype", "float16"],
                                   ["--model-compute-dtype", "bfloat16"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_into(TrainCLIConfig, ["@" + CFG, *flags])


def test_steps_in_flag_parses():
    """--model-steps-in is ported: the config takes it."""
    cfg = parse_into(TrainCLIConfig, ["@" + CFG, "--model-steps-in", "2"])
    assert cfg.model_steps_in == 2


def test_k_step_dispatch_raises(tmp_path):
    """k steps a chunk is ported: --steps-per-dispatch 2 trains in chunks
    of 2 (one stats row a chunk, at its last step) and a 1-step
    remainder; only a negative k raises."""
    out = tmp_path / "k2"
    TC.main(_argv(CFG, out, "--epochs", "1", "--steps-per-epoch", "3",
                  "--steps-per-dispatch", "2"))
    rows = _stats(out)
    assert [r["step"] for r in rows] == [2, 3]
    assert all(np.isfinite(r["total_loss"]) for r in rows)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        TC.main(_argv(CFG, tmp_path / "neg", "--steps-per-dispatch", "-1"))
