"""The benchmark's yardstick of work: the model's arithmetic and the
kernels' bounds, counted from the configuration's shapes and from the
evaluations the fit's search makes, never from counters of the program,
so that a PR that fuses or replaces a kernel leaves the count as it is.

The peaks are one NVIDIA H100 SXM's (the data sheet, dense): 67 TFLOP/s
in float32 outside the tensor cores, the precision both configurations
state, and 3.35 TB/s of HBM. A bound is the larger of FLOP / peak and
bytes / bandwidth. `rollout_flops`, `fwd_bound`, `bwd_bound` and
`nn_bound` are chip_smoke.py's, with the kernels' carry and output
widths written out.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

F32_PEAK = 67e12          # FLOP/s, f32 outside the tensor cores
HBM_RATE = 3.35e12        # bytes/s

# the rollout kernels' layout (humor_torch/ops/rollout_kernel.py at the
# default HuMoR configuration): the carry row, the per-step output row
CARRY_W = 351
OUT_W = 444
LATENT = 48
PRIOR_MACS = 339 * 1024 + 3 * 1024 * 1024 + 1024 * 96
DECODER_MACS = 387 * 1024 + 1072 * 1024 + 1072 * 512 + 560 * 216
ENCODER_MACS = 678 * 1024 + 3 * 1024 * 1024 + 1024 * 96   # the posterior
# the prior's and decoder's weights and biases, float32
ROLLOUT_WEIGHT_BYTES = 4.0 * (
    (339 * 1024 + 3 * 1024 * 1024 + 1024 * 96) + (4 * 1024 + 96)
    + DECODER_MACS + (1024 + 1024 + 512 + 216))
VPOSER_DEC_MACS = 32 * 512 + 512 * 512 + 512 * 126
VPOSER_ENC_MACS = 63 * 512 + 512 * 512 + 512 * 64


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / F32_PEAK, nbytes / HBM_RATE)


def rollout_flops(M: int, steps: int) -> float:
    """2 * M * (multiply-adds of the prior and decoder) per step."""
    return 2.0 * M * steps * (PRIOR_MACS + DECODER_MACS)


def fwd_bound(M: int, steps: int) -> float:
    """The forward's FLOP; the weights, carry0 and z read and out and the
    saved carries written once."""
    io = 4.0 * M * (CARRY_W + steps * (LATENT + OUT_W + CARRY_W))
    return bound_s(rollout_flops(M, steps), ROLLOUT_WEIGHT_BYTES + io)


def bwd_bound(M: int, steps: int) -> float:
    """Twice the forward's FLOP (recompute and transposed products); the
    weights read twice, saved, z and dout read and the cotangents written
    once."""
    io = 4.0 * M * (steps * (CARRY_W + LATENT + OUT_W + LATENT) + CARRY_W)
    return bound_s(2 * rollout_flops(M, steps),
                   2 * ROLLOUT_WEIGHT_BYTES + io)


def nn_flops(clouds: int, nq: int, nm: int) -> float:
    """6 FLOP a pair (3 products, 3 sums)."""
    return 6.0 * clouds * nq * nm


def nn_bound(clouds: int, nq: int, nm: int) -> float:
    """Inputs read once, dist and idx written once."""
    return bound_s(nn_flops(clouds, nq, nm),
                   4.0 * 3 * clouds * (nq + nm) + 8.0 * clouds * nq)


def smpl_flops(rows: int, verts: int, all_verts: int, joints: int = 22,
               betas: int = 16) -> float:
    """One SMPL forward a row: the shape blend and the joint regression
    over the whole template, the kinematic chain, then the pose blend and
    the skinning of the `verts` vertices the term reads."""
    per = (2 * all_verts * 3 * betas + 2 * joints * all_verts * 3
           + 2 * joints * 45
           + 2 * 9 * (joints - 1) * 3 * verts
           + 2 * verts * joints * 12 + 2 * verts * 12)
    return float(rows) * per


class Evaluation(NamedTuple):
    """One value-and-gradient evaluation of a fit objective."""
    stage: str          # "stage1", "stage2", "stage3"
    rows: int           # windows evaluated: K * B, or B at the start
    frames: int         # frames each window spans
    pose_prior: bool    # stage 3 re-encodes the rolled-out poses


def stage3_phases(iters: int, n_init: int, frames: int, freeze):
    """(frames, iterations) of stage 3's three phases: tune the initial
    state on the first n_init frames, freeze it, refine everything."""
    f0, f1 = min(freeze[0], iters), min(freeze[1], iters)
    return ((min(n_init, frames), f0), (frames, f1 - f0), (frames, iters - f1))


def fit_evaluations(num_iters, freeze, n_init, batch: int, frames: int,
                    candidates: int, pose_prior3: bool) -> List[Evaluation]:
    """Every evaluation of a fit with the parallel line search: each
    stage and stage-3 phase evaluates its start once at K = 1, then one
    K-candidate batch an iteration."""
    out = []
    runs = [("stage1", frames, num_iters[0]), ("stage2", frames, num_iters[1])]
    runs += [("stage3", n, it) for n, it in
             stage3_phases(num_iters[2], n_init, frames, freeze)]
    for stage, n, it in runs:
        if it == 0:
            continue
        pp = stage == "stage3" and pose_prior3
        out.append(Evaluation(stage, batch, n, pp))
        out += [Evaluation(stage, candidates * batch, n, pp)] * it
    return out


def fit_work(evals: List[Evaluation], batch: int, frames: int,
             verts: int, all_verts: int, points: int) -> Dict[str, float]:
    """The fit's model FLOP and the bounds (s) of its rollout and
    nearest-neighbour kernels. `verts`: the vertices a term skins (the
    whole mesh for a point cloud, the 43 keypoint vertices for the RGB
    overlap terms); `points`: the cloud's size, 0 without one. A
    value-and-gradient evaluation counts three times its forward (the
    backward as twice the forward); the nearest neighbour counts its
    forward only, its backward being a gather and a scatter."""
    flops = fwd = bwd = nn = 0.0
    for e in evals:
        R = e.rows
        if e.stage == "stage1":
            # the root transform of every skinned point of every frame
            f = 2.0 * 9 * R * e.frames * (22 + verts)
        elif e.stage == "stage2":
            f = (2.0 * R * e.frames * VPOSER_DEC_MACS
                 + smpl_flops(R * e.frames, verts, all_verts))
        else:
            f = (2.0 * R * VPOSER_DEC_MACS * 2      # pose0, cam2prior's
                 + smpl_flops(R, 0, all_verts)       # cam2prior's joints
                 + rollout_flops(R, e.frames - 1)
                 + smpl_flops(R * e.frames, verts, all_verts))
            if e.pose_prior:
                f += 2.0 * R * e.frames * VPOSER_ENC_MACS
            fwd += fwd_bound(R, e.frames - 1)
            bwd += bwd_bound(R, e.frames - 1)
        flops += 3.0 * f
        if points:
            flops += nn_flops(R * e.frames, points, all_verts)
            nn += nn_bound(R * e.frames, points, all_verts)
    # once a fit: stage 1's skinning, stage 3's posterior inference and
    # the final rollout
    flops += smpl_flops(batch * frames, verts, all_verts)
    flops += (2.0 * batch * (frames - 1) * ENCODER_MACS
              + smpl_flops(batch * frames, 0, all_verts))
    flops += rollout_flops(batch, frames - 1)
    fwd += fwd_bound(batch, frames - 1)
    return {"flops": flops, "rollout_fwd_bound_s": fwd,
            "rollout_bwd_bound_s": bwd, "nn_bound_s": nn}


def train_step_flops(batch: int, steps: int, verts: int,
                     genders: int = 2) -> float:
    """One training step's model FLOP over batch x steps transitions: the
    posterior, prior and decoder products, and the SMPL losses' skinnings
    of the predicted and the ground-truth states for each gender on every
    row. The products and the predicted skinnings count three times
    their forward (the backward as twice the forward); the ground truth's
    skinnings, which no gradient reaches, once."""
    rows = batch * steps
    mlp = 2.0 * rows * (ENCODER_MACS + PRIOR_MACS + DECODER_MACS)
    skin = genders * smpl_flops(rows, verts, verts)
    return 3.0 * mlp + 3.0 * skin + skin
