"""Fitting-results evaluation CLI (port of humor_tpu/eval/fitting_cli.py):
quantitative per-stage metrics over a fit output directory, one
<stage>_mean.csv each and compare_mean.csv across stages.

    python -m humor_torch.eval.fitting_cli --results ./out/fit \
        --out ./out/fit_eval [--mode 3d|2d|prox] [--device cpu]

Modes: '3d' against saved GT joints, '2d' plausibility only (joint
acceleration, ground penetration against the fitted floor), 'prox'
against PROXD/MoSh pseudo-GT SMPL fits. The body is skinned on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


@dataclass
class FitEvalConfig:
    results: str = "./out/humor_fit"
    out: str = ""
    stages: str = "final"   # comma-separated stage names to evaluate
    smplh_root: str = "./body_models/smplh"
    mode: str = "3d"        # '3d' (vs GT joints) | '2d' (plausibility)
    #                         | 'prox' (vs PROXD/MoSh pseudo-GT fits)
    qual: bool = False      # side-by-side stage-vs-GT comparison gifs
    qual_fps: float = 30.0
    qual_max_seqs: int = 4  # cap rendered sequences (rendering is slow)
    device: str = "cuda"


def _load_seq_dirs(results_dir: str) -> List[str]:
    return sorted(
        d for d in glob.glob(os.path.join(results_dir, "*"))
        if os.path.isdir(d)
        and os.path.exists(os.path.join(d, "observations.npz")))


def _skin(body, res: Dict[str, np.ndarray], device) -> Dict:
    """One saved sequence's SMPL skinned on `device` ((1, T, ...))."""
    from humor_torch.fitting.optimizer import smpl_results

    t = lambda k: torch.as_tensor(np.asarray(res[k], np.float32),
                                  device=device)[None]
    with torch.no_grad():
        return smpl_results(body, t("trans"), t("root_orient"),
                            t("pose_body"), t("betas"))


def evaluate_stage(stage: str, seq_dirs: List[str], body,
                   mode: str = "3d", device="cuda"
                   ) -> Dict[str, Dict[str, float]]:
    from humor_torch.device import resolve_device
    from humor_torch.eval import metrics as M

    dev = resolve_device(device)
    body = body.to(dev)

    per_seq = []
    for d in seq_dirs:
        res_path = os.path.join(d, f"{stage}_results.npz")
        if not os.path.exists(res_path):
            continue
        res = dict(np.load(res_path))
        obs = dict(np.load(os.path.join(d, "observations.npz")))
        gt_path = os.path.join(d, "gt_results.npz")
        gt = dict(np.load(gt_path)) if os.path.exists(gt_path) else {}

        pred_j = _skin(body, res, dev)["joints3d"][0].cpu()

        if mode == "3d" and "joints3d" in gt:
            pd = {"joints3d": pred_j}
            if "contacts" in res and "contacts" in gt:
                pd["contacts"] = res["contacts"]
            gd = {"joints3d": gt["joints3d"]}
            if "contacts" in pd:
                gd["contacts"] = gt["contacts"]
            od = {"joints3d": obs["joints3d"]} \
                if "joints3d" in obs else {}
            per_seq.append(M.quant_eval_3d(pd, gd, od))
        elif mode == "prox" and "pose_body" in gt and "valid" in gt:
            # PROXD/MoSh pseudo-GT SMPL fits (10 betas, per frame) ->
            # joints via our body model, dummy frames masked out
            gt_j = _pseudo_gt_joints(body, gt, dev)
            per_seq.append(M.quant_eval_prox(
                pred_j, gt_j, np.asarray(gt["valid"], bool),
                floor_plane=res.get("floor_plane")))
        else:
            floor = res.get("floor_plane")
            per_seq.append(M.quant_eval_2d(
                pred_j, floor_plane=floor))
    return M.aggregate(per_seq) if per_seq else {}


def _pseudo_gt_joints(body, gt: Dict[str, np.ndarray], device
                      ) -> torch.Tensor:
    """SMPL joints (T, 22, 3) from a PROX pseudo-GT fit dict with
    per-frame 10-d betas (zero-padded to the model's beta count)."""
    from humor_torch.body_model import constants as C
    from humor_torch.body_model import smpl as smpl_lib

    trans = np.asarray(gt["trans"], np.float32)
    T = trans.shape[0]
    betas = np.asarray(gt["betas"], np.float32).reshape(T, -1)
    nb = body.num_betas
    padded = np.zeros((T, nb), np.float32)
    k = min(nb, betas.shape[1])
    padded[:, :k] = betas[:, :k]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    with torch.no_grad():
        out = smpl_lib.forward(body, t(gt["root_orient"]), t(gt["pose_body"]),
                               t(padded), t(trans),
                               vert_ids=np.zeros((0,), np.int64))
    return out.Jtr[:, : C.NUM_SMPL_JOINTS].cpu()


def render_qual(stages: List[str], seq_dirs: List[str], body,
                out_dir: str, fps: float = 30.0, device="cuda") -> List[str]:
    """Side-by-side skeleton comparison gifs, one per sequence: each
    requested stage next to GT (stage2 is the VPoser-t baseline,
    stage3/final the HuMoR result)."""
    from humor_torch.device import resolve_device
    from humor_torch.viz.utils import create_gif, render_comparison_seq

    dev = resolve_device(device)
    body = body.to(dev)

    written = []
    for d in seq_dirs:
        seqs, labels = [], []
        for stage in stages:
            p = os.path.join(d, f"{stage}_results.npz")
            if not os.path.exists(p):
                continue
            res = dict(np.load(p))
            seqs.append(_skin(body, res, dev)["joints3d"][0].cpu().numpy())
            labels.append(stage)
        gt_path = os.path.join(d, "gt_results.npz")
        if os.path.exists(gt_path):
            gt = dict(np.load(gt_path))
            if "joints3d" in gt:
                seqs.append(np.asarray(gt["joints3d"]))
                labels.append("GT")
        if not seqs:
            continue
        name = os.path.basename(d.rstrip("/"))
        frame_dir = os.path.join(out_dir, "qual", name)
        frames = render_comparison_seq(seqs, labels, frame_dir,
                                       prefix=name)
        gif = create_gif(frames, os.path.join(out_dir, "qual",
                                              f"{name}.gif"), fps=fps)
        written.append(gif)
        print(f"[fit-eval] qual: {gif}")
    return written


def main(argv=None) -> Dict:
    from humor_torch.device import resolve_device
    from humor_torch.eval import metrics as M
    from humor_torch.fitting.cli import load_body
    from humor_torch.utils.config import parse_into

    cfg = parse_into(FitEvalConfig, argv, prog="humor-torch-eval-fitting")
    resolve_device(cfg.device)
    out_dir = cfg.out or (cfg.results.rstrip("/") + "_eval")
    os.makedirs(out_dir, exist_ok=True)
    body = load_body(cfg.smplh_root)
    seq_dirs = _load_seq_dirs(cfg.results)
    print(f"[fit-eval] {len(seq_dirs)} sequences under {cfg.results}")

    tables = {}
    for stage in cfg.stages.split(","):
        table = evaluate_stage(stage.strip(), seq_dirs, body, cfg.mode,
                               cfg.device)
        if not table:
            continue
        tables[stage] = table
        path = os.path.join(out_dir, f"{stage}_mean.csv")
        M.write_csv(path, table)
        print(f"[fit-eval] wrote {path}")
        if "joints3d_all" in table:
            print(f"  {stage}: MPJPE "
                  f"{table['joints3d_all']['mean']*1000:.1f}mm")

    if cfg.qual:
        render_qual([s.strip() for s in cfg.stages.split(",")],
                    seq_dirs[: cfg.qual_max_seqs], body, out_dir,
                    fps=cfg.qual_fps, device=cfg.device)

    # cross-stage comparison table
    if len(tables) > 1:
        import csv

        metrics = sorted({m for t in tables.values() for m in t})
        with open(os.path.join(out_dir, "compare_mean.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["metric"] + list(tables))
            for m in metrics:
                w.writerow([m] + [
                    tables[s].get(m, {}).get(
                        "mean", tables[s].get(m, {}).get("frac", ""))
                    for s in tables])
        print(f"[fit-eval] wrote compare_mean.csv")
    return tables


if __name__ == "__main__":
    main()
