"""Small cells for the CPU tests: the benchmark's own cells with fewer
iterations, frames, windows and vertices, driven on the CPU."""

import copy
import json
import os
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


# the PROX RGB-D fit has a traffic file but no cell yet (PERF.md, section
# 7): its small cell is tto_rgb's with the proxd traffic and these limits
PROXD_LIMITS = {"stage1_iters": 3, "stage2_iters": 1, "stage3_iters": 3,
                "stage1_gap": 9e-5,
                "stage2_gap": 2e-5}


def small_cell(name: str, frames: int = 12):
    from portbench import run as R

    if name == "tto_proxd":
        cell = R.Cell(bench(), "tto_rgb")
        with open(os.path.join(ROOT, "portbench", "traffic",
                               "proxd.json")) as f:
            cell.traffic = json.load(f)
        cell.limits = dict(PROXD_LIMITS)
    else:
        cell = R.Cell(bench(), name)
    if cell.traffic["kind"] == "fit":
        tr = copy.deepcopy(cell.traffic)
        tr["num_iters"], tr["stage3_freeze"] = [3, 3, 4], [1, 2]
        tr["observation"]["distinct"] = 2
        if tr["observation"]["kind"] == "prox":
            tr["observation"]["points"] = 128
        cell.traffic = tr
        cell.config = dict(cell.config, seq_len=frames)
    else:
        cell.config = dict(cell.config, batch_size=8, train_sequences=6,
                           sequence_frames=40, num_verts=256,
                           steps_per_dispatch=2)
    return cell


def run_small(cell, seed: int = 2 ** 31 + 11, trace: int = 0):
    from portbench import run as R

    args = types.SimpleNamespace(seed=seed, seconds=0.5, trace=trace)
    return R.run_cell(cell, args, time.perf_counter(), device="cpu")
