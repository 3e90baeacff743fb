#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (humor_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:
  1. build the CUDA kernels from humor_torch/csrc with nvcc (sm_90a), in
     parallel, and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card:
     the rollout kernels at full width, M=16 rows (the stage-3
     line-search batch): the whole chain at T=6 with tight bounds, the
     whole chain at T=59 (the stage-3 rollout), and every one of the 59
     steps on its own; time kernel and plain version at T=59. The seeded
     random-weight model is chaotic over 59 steps (its own float32 and
     float64 plain runs part by tens of metres), so the T=59 whole-chain
     check scales the decoder's output layer by 0.1, which makes the
     chain well-conditioned (plain float32 vs float64: 3e-4 m, backward
     1e-5 max-scaled, measured on the CPU); the step-by-step check uses
     the unscaled weights. Both rollout kernels also at every M in EDGE_M
     x T in EDGE_T and at the CLI's zoom probes' M=2, T=59 (damped), each
     within 1e-4, twice on the same T=59 inputs (bit-identical),
     and timed at M=128 with their grids and barriers a step. The
     nearest-neighbour kernel at one
     line-search candidate's slice of the PROX fit (120 clouds x 4096
     queries x 6890 points, 10% of the queries at 1e6 as the energy puts
     missing points), in the reverse direction (6890 mesh queries into
     the 4096-point cloud), on duplicated points (first index), at prime
     sizes and at the edges of its chunks, tiles and blocks
     (nn_edge_sizes()); timed at the fit's full (960, 4096, 6890), with its
     plain version, and at stage 3's (240, 4096, 6890);
  3. run the joints3d 3-stage test-time fit (B=2 windows x 60 frames,
     L-BFGS iterations 30/70/70, the bench_tto joints3d weights) on
     seeded random weights and a seeded synthetic body with 6890
     vertices; check that every loss is finite, that the fit lowered
     stages 1 and 2, and that both rollout kernels were launched by it;
  4. hold the PROX stage objectives (values and gradients) on the card
     against the same on the CPU at a small input; then run the PROX
     RGB-D fit (B=2 x 60, configs/fit_proxd.cfg's weights, bisquare
     weighting, the floor plane optimized, 30/80/70) on a seeded
     4096-point cloud per frame, 2D keypoints and a floor; check the
     same as for phase 3, the floor plane's shape, that all three
     kernels were launched by it and the nearest neighbour once per
     evaluation, and that the mean distance from the visible points to
     the stage-1 and stage-2 meshes is within C2M_LIMITS;
  5. run the PROX fit at reduced iterations once plainly and once under
     torch.profiler, print the device-busy share of the wall time and
     the kernels with the most device time, and check that each forward
     and each backward call enqueued exactly one device kernel (the
     trace's rollout_fwd and rollout_bwd kernels against the launch
     counters);
  6. hold the RGB stage objectives (the overlap terms on, 3 line-search
     candidates folded into the rows) on the card against the same on
     the CPU at a small input; then run bench.py's RGB video fit (B=2
     windows x 60 frames sharing 10, bench_tto.py's RGB weights with the
     overlap consistency at 200, the floor optimized, the depth init
     from bone lengths, 30/70/70) on seeded 2D keypoints; check the same
     as for phase 3, the floor plane's shape, that both rollout kernels
     were launched by it and the nearest neighbour not, the depth within
     RGB_DEPTH_M, the reprojection error after stages 1-2 within
     RGB_REPROJ_LIMITS and the windows' gap over their shared frames
     after stage 2 within RGB_GAP_LIMITS (both two-sided around the JAX
     package's values), the 110 stitched frames finite and their prior
     frame on the card against the CPU; then run stage 3 alone
     (RGB_STAGE3_CMP_ITERS iterations, half the fit's, its three phases
     kept) with the decoder head damped x0.1 on the card, on the CPU and
     on the card with the keypoints nudged, hold the card's first
     RGB_STAGE3_ITERS loss values to the CPU's within RGB_STAGE3_RTOL
     and its final translations' gap to the CPU within
     RGB_STAGE3_NUDGE_RATIO of its gap to the nudged run;
  7. drive the command-line entry points on synthetic layouts written to
     a temporary directory: the fit CLI (humor_torch.fitting.cli) on a
     110-frame RGB video of OpenPose JSONs (phase 6's bodies) with the
     6890-vertex body as an SMPL+H npz, 2 windows x 60 frames, the hybrid
     line search (a zoom polish of each stage and stage-3 phase),
     CLI_ITERS; check the same as for phase 3, that both rollout kernels
     were launched and the nearest neighbour not, and the 110 stitched
     frames finite; then the fit-eval CLI (--mode 2d) on its output
     (finite compare_mean.csv); stage 2 alone with the zoom search on the
     card and on the CPU (the first RGB_STAGE3_ITERS history values within
     RGB_STAGE3_RTOL); and the fit CLI with configs/fit_proxd.cfg on a
     small PROX recording (16-bit depth and body-index PNGs, 2 windows x
     20 frames at 3/3/3), which must launch the nearest neighbour;
  8. training (configs/train_humor.cfg's HuMoR 1024/48 with the SMPL
     losses, 6890-vertex synthetic male and female bodies): one
     supervised and one scheduled-sampling loss and gradient on the card
     against the CPU at 16 windows x 10 transitions with the same weights
     and draws (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL); both steps timed at the
     config's 200 x 10 with their peak device memory; the train CLI at
     200 x 10 on the synthetic sequences with the bodies as SMPL+H npz
     files, 3 epochs of 8 steps (teacher-forced, mixed, fully scheduled
     sampling): every logged stat finite, each phase run, its
     checkpoints written; configs/train_humor_qual.cfg for 2 epochs of 2
     steps (its SMPL-joint feedback in the second); then the fit CLI with its final_model.npz on
     phase 7's RGB layout, which must launch both rollout kernels and
     give finite losses and outputs. Training itself launches none of
     the three kernels (JAX trains through plain XLA too);
  9. the dataset-level entry points on a temporary directory (two
     processed synthetic sequences, 159 frames each, the 6890-vertex
     bodies as SMPL+H npz files): the AMASS fit observations (noisy
     joints and surface points) built on the card against the CPU
     within AMASS_OBS_TOL; k-means++ (the same seeds) and 5 EM sweeps at
     N=2,000 on the card against the CPU (GMM_TOL), 100 sweeps timed at
     the GMM CLI's 200,000 x 138 with K=12 and their peak memory; the
     GMM CLI on the sequences (its npz read back); the AMASS fit CLI with
     configs/fit_amass_joints.cfg at its own 30/70/70 and the GMM's npz
     as --init-motion-prior-ckpt, fit_amass_keypts.cfg at
     AMASS_KEYPTS_ITERS and a surface-points variant at
     AMASS_POINTS_ITERS: no failed batch, the checks of phase 3, a
     finite eval_mean.csv, both rollout kernels launched, the nearest
     neighbour only by the points run and once per evaluation; the
     evaluation CLI's test_humor, test_humor_sampling (300 steps at B=8,
     4 samples), test_humor_qual_sampling (gendered bodies) and
     test_humor_recon configs: every output finite, the +5 m recon
     probe within the JAX package's bound; the preprocessing CLI on a
     raw tree of four sequences on the card and on the CPU (within
     PROCESS_TOL), then the cleanup CLI, which must move the treadmill
     sequence alone. The GMM, evaluation and preprocessing paths launch
     no kernel;
 10. the trained fixture (humor_torch.testing, the JAX package's
     humor_tpu/testing.py): mini HuMoR trained on the card for 300
     supervised and 150 scheduled-sampling steps at 48 x 10 with the SMPL
     losses on the 256-vertex synthetic body, mini VPoser for 800 Adam
     steps (its round-trip error on GT poses printed); then both fits
     of tests/test_tto_accuracy.py with the zoom line search at that
     test's shapes, budgets and seeds: joints3d
     (B=2 x 10 at 15/25/40, 2 cm noise, the middle third occluded) and
     RGB (two windows of 10 sharing 4, 2 px noise, the floor optimized,
     60/100/120), held to that test's bounds (testing.JOINTS3D_BOUNDS,
     RGB_BOUNDS: visible and occluded MPJPE, betas, the init rollout's
     +5 m equivariance, the floor), except the RGB fit's absolute-depth
     bounds (testing.RGB_DEPTH_BOUNDS: visible and occluded MPJPE, the
     floor's offset), which are printed beside their values: the JAX
     package's own fit on its own fixture misses each of them when its
     observation moves by under 2.5e-4 px; both rollout kernels launched
     by each fit; the zoom search's probes an iteration of stage 3
     printed;
 11. the HuMoR configurations other than the default: a supervised and
     a scheduled-sampling loss and gradient at steps_in = 2 and at 6d
     inputs with 9d outputs on the card against the CPU (phase 8's size
     and tolerances); the train CLI for one epoch at --model-steps-in 2;
     a 3/3/3 joints3d fit of an unconditional-prior, absolute-output
     model (decoder head damped x0.1) on the card against the CPU
     (histories within CONFIG_FIT_RTOL, the final pose within
     CONFIG_FIT_ATOL, the same weights read as deltas farther from the
     CPU than that, a 1e-6 m nudge's gap printed). These roll out
     through the typed rollout and launch no kernel, by design;
 12. the k-step dispatch and the multi-device layer: multi_sup and
     multi_ss over a chunk of PAR_K batches against PAR_K single steps
     with the same draws (phase 8's size; params, moments and stats
     equal); the supervised step at 200 x 10 in chunks of k = 1, 4 and 8
     (ms a step, host synchronisations a step); the joints3d fit with
     the overlap consistency (tests/test_tto_sharded.py's configuration:
     zoom, no stage-3 init tuning) at full width on the 6890-vertex body,
     4 windows x 60 frames sharing 10 at 10/10/10, decoder head damped
     x0.1, plainly, with its joints nudged by +-1e-6 m, sharded at world
     1 over NCCL and at world 2 (two processes on this card over gloo, so
     the overlap pair (1, 2) crosses ranks): the first history values of
     stages 1-2 within SHARD_HIST_RTOL, the final pose within
     SHARD_NUDGE_RATIO of the nudges' gap, every rank equal and
     launching both rollout kernels; the trainer at world 1 over NCCL
     equal to the plain trainer; the data-parallel steps at world 2
     against world 1 (phase 8's tolerances, params equal across ranks);
     and the train CLI under torchrun at world 2 for one epoch at k = 4
     (rank 0 alone writes the log, the stats and the checkpoints). The
     kernels are built once, here, before any rank starts;
 13. the bf16 precision policy and the PROX fit's determinism: the
     prior, posterior and decoder with compute_dtype="bfloat16" at full
     width at 16 and 2,000 rows on the card against the CPU's plain bf16
     (the norm of the gap at most BF16_HEAD_RATIO of the bf16-vs-f32
     gap's), one product within BF16_PRODUCT_RTOL of the CPU's, f32 out,
     in under half the f32 product's time (tensor cores); lbs in bf16
     at 2,000 x 6,890: joints equal to the f32 call's, vertices within
     BF16_SMPL_ULPS bf16 steps of f32 and of the CPU; the supervised
     loss and gradient at 16 x 10 in four modes (f32, MLPs bf16, loss
     bodies bf16, both) and the scheduled-sampling one with both, card
     against the CPU (f32 to phase 8's limits, bf16 to BF16_LOSS_RTOL
     and BF16_GRAD_GAP); the supervised step at 200 x 10 in the four
     modes in turns, and scheduled sampling with both, ms a step and
     peak memory; the train CLI and the AMASS joints fit CLI
     (B=2 x 60, 30/70/70) with --model-compute-dtype bfloat16: the
     checks of phase 3 and no kernel launched (a bf16 model rolls out
     through the typed rollout); then the PROX fit at 5/10/10 twice, bit
     for bit, once more under torch's deterministic mode (the ops it
     names printed), twice with the atomic index_add_ the backward's
     scatter replaced (printed), and that scatter timed beside it at
     (960, 4096, 6890).

Prints the kernels' JSON line, then the card's name and power limit,
then the result line {"ok": true, "device": {...}} last. Imports nothing
of JAX or of the JAX package.

    python3 chip_smoke.py --phases 10 11
    python3 chip_smoke.py --phases 12
    python3 chip_smoke.py --phases 13

builds the kernels and runs only the named phases of 3-13, each path's
launches counted from zero, then prints each path's launches, the
card's name and power limit and the seconds a phase; it skips phase 2
and prints neither the kernels' line nor the result line.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

B, T = 2, 60
NUM_ITERS = (30, 70, 70)
PROX_ITERS = (30, 80, 70)      # configs/fit_proxd.cfg
PROFILE_ITERS = (5, 10, 10)
RGB_ITERS = (30, 70, 70)       # bench_tto.py's RGB cell at scale 1
# mean reprojection error (px) of the keypoints the fit sees after stages 1
# and 2, and the mean keypoint-vertex gap (m) over the frames the windows
# share after stage 2: what the JAX package gives on the CPU at the same
# seeded observation and budget (scripts/rgb_reproj_reference.py), held
# two-sided within a relative band (RGB_REPROJ_LIMITS, RGB_GAP_LIMITS) of
# about 3x the largest spread measured among the card, the port on the CPU
# and the JAX package (reprojection 1.0%, gap 6%)
RGB_REPROJ_JAX = (55.6072, 57.2930)
RGB_REPROJ_RTOL = 0.03
RGB_GAP_JAX = 0.015124
RGB_GAP_RTOL = 0.2
RGB_DEPTH_M = (0.5, 8.0)       # tests/test_tto_rgb.py's bounds on the depth
# damped RGB stage 3 alone, card against CPU: the loss history's first
# iterations, before float32 rounding parts the L-BFGS paths (under 1e-5
# on an H100; over 1e-4 from the third on), and the final translations'
# gap against the card's own gap under a 1e-4 px nudge (1.02x measured)
RGB_STAGE3_ITERS = 2
RGB_STAGE3_RTOL = 1e-4
RGB_STAGE3_NUDGE_RATIO = 3.0
# half the RGB fit's stage 3 (70, freeze 30/55), its three phases kept:
# the CPU run of the comparison is most of phase 6's time
RGB_STAGE3_CMP_ITERS, RGB_STAGE3_CMP_FREEZE = 35, (15, 28)
# one nearest-neighbour launch per evaluation: the initial one and one per
# iteration of stages 1 and 2 and of stage 3's three phases (30 + 25 + 15
# iterations at the freeze points 30 and 55)
PROX_NN_LAUNCHES = sum(PROX_ITERS) + 5
C2M_LIMITS = (0.16, 0.08)      # cloud to mesh (m) after stages 1 and 2
K_CAND = 8                     # line-search candidates
M_STAGE3 = K_CAND * B
T_ROLL = T - 1
V_VERTS = 6890
N_POINTS = 4096                # PROX's cloud size
EDGE_M = (1, 3, 17, 64, 128)   # rollout kernels: rows off and on their tiles
EDGE_T = (1, 2, 6)
M_MAX = 128            # bench_tto.py --batch 16's candidate batch
PV = 396               # out[..., PV:]: the prior variance, exp of a head
RELU_TIE = 1e-5        # a ReLU input this close to zero is a float32 tie
NN_TOL = 1e-5          # kernel vs plain: distance abs, and tie width
F32_PEAK = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12     # H100 SXM device-memory bytes/s


def band(ref, rtol):
    """(low, high): ref within a relative tolerance."""
    return (ref * (1.0 - rtol), ref * (1.0 + rtol))


RGB_REPROJ_LIMITS = tuple(band(r, RGB_REPROJ_RTOL) for r in RGB_REPROJ_JAX)
RGB_GAP_LIMITS = band(RGB_GAP_JAX, RGB_GAP_RTOL)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rollout_inputs(M, steps, seed, device="cuda"):
    """A seeded canonical start carry, latents and output cotangents."""
    import numpy as np
    import torch

    from humor_torch.ops import rollout_kernel as RK
    from humor_torch.ops import transforms as TT

    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    x = torch.cat([
        f(0.1 * rng.randn(M, 3)), f(0.3 * rng.randn(M, 3)),
        TT.aa_to_rotmat(f(0.3 * rng.randn(M, 3))).reshape(M, 9),
        f(0.3 * rng.randn(M, 3)),
        TT.aa_to_rotmat(f(0.3 * rng.randn(M, 21, 3))).reshape(M, 189),
        f(0.4 * rng.randn(M, 66)), f(0.3 * rng.randn(M, 66)),
        TT.aa_to_rotmat(f(rng.randn(M, 3))).reshape(M, 9),
        f(rng.randn(M, 3) * [1, 1, 0])], dim=-1)
    z = f(0.5 * rng.randn(steps, M, 48))
    t2j = f(0.05 * rng.randn(M, 3) * [1, 1, 0])
    dout = f(rng.randn(steps, M, RK.OUT_W) * 0.1)
    return [t.to(device).contiguous() for t in (x, z, t2j, dout)]


def rollout_flops(M, steps):
    """2 * M * (multiply-adds of the prior and decoder) per step."""
    prior = 339 * 1024 + 3 * 1024 * 1024 + 1024 * 96
    dec = 387 * 1024 + 1072 * 1024 + 1072 * 512 + 560 * 216
    return 2.0 * M * steps * (prior + dec)


def check_steps(weights, M, steps, tol_world):
    """Each step of one kernel run against the plain step from the same
    entry carry (all steps batched into one plain call)."""
    import torch

    from humor_torch.ops import rollout_kernel as RK

    carry0, z, t2j, _ = rollout_inputs(M, steps, seed=steps + 1)
    out_k, saved_k = RK.rollout_forward(weights, carry0, z, t2j)
    out_p, next_p = RK.step_forward(
        weights, saved_k.reshape(steps * M, RK.CW),
        z.reshape(steps * M, -1), t2j.repeat(steps, 1))
    out_k = out_k.reshape(steps * M, RK.OUT_W)
    err_world = (out_k[:, :348] - out_p[:, :348]).abs().max().item()
    err_pm = (out_k[:, 348:396] - out_p[:, 348:396]).abs().max().item()
    err_pv = ((out_k[:, 396:] - out_p[:, 396:]).abs()
              / out_p[:, 396:].abs()).max().item()
    err_carry = (saved_k[1:].reshape(-1, RK.CW)
                 - next_p[:-M]).abs().max().item()
    res = {"err_world": err_world, "err_pm": err_pm, "err_pv_rel": err_pv,
           "err_next_carry": err_carry}
    print(f"[compare per step T={steps} M={M}] " + json.dumps(res))
    if not (max(err_world, err_carry) <= tol_world and err_pm <= 1e-3
            and err_pv <= 1e-3):
        fail(f"forward kernel step disagrees: {res}")


def damped(params, scale):
    """The same weights with the decoder's output layer scaled."""
    last = dict(params["decoder"][-1], w=params["decoder"][-1]["w"] * scale,
                b=params["decoder"][-1]["b"] * scale)
    return dict(params, decoder=params["decoder"][:-1] + [last])


def check_kernels(weights, M, steps, tol_world, tol_bwd, timed):
    """Kernel vs plain version on the same inputs; returns the errors and
    (when timed) the times."""
    import torch

    from humor_torch.ops import rollout_kernel as RK

    carry0, z, t2j, dout = rollout_inputs(M, steps, seed=steps)
    out_k, saved_k = RK.rollout_forward(weights, carry0, z, t2j)
    out_p, saved_p = RK.rollout_forward_plain(weights, carry0, z, t2j)
    torch.cuda.synchronize()
    err_world = (out_k[..., :348] - out_p[..., :348]).abs().max().item()
    err_pm = (out_k[..., 348:396] - out_p[..., 348:396]).abs().max().item()
    pv_k, pv_p = out_k[..., 396:], out_p[..., 396:]
    err_pv = ((pv_k - pv_p).abs() / pv_p.abs()).max().item()
    fwd_err = (out_k - out_p).abs().max().item()
    if not (err_world <= tol_world and err_pm <= 1e-3 and err_pv <= 1e-3):
        fail(f"forward kernel disagrees at T={steps} M={M}: world "
             f"{err_world:.3e} (tol {tol_world}), prior mean {err_pm:.3e} "
             f"(tol 1e-3), prior var rel {err_pv:.3e} (tol 1e-3)")
    bwd_err, bwd_scaled = check_bwd(weights, saved_p, z, t2j, dout, tol_bwd)
    res = {"fwd_err": fwd_err, "err_world": err_world, "err_pm": err_pm,
           "err_pv_rel": err_pv, "bwd_err": bwd_err,
           "bwd_scaled": bwd_scaled}
    if timed:
        # two runs on the same inputs: fixed summation order, no atomics
        f1 = RK.rollout_forward(weights, carry0, z, t2j)
        f2 = RK.rollout_forward(weights, carry0, z, t2j)
        res["fwd_bit_identical"] = all(bool(torch.equal(a, b))
                                       for a, b in zip(f1, f2))
        if not res["fwd_bit_identical"]:
            fail(f"forward kernel: two runs differ at T={steps} M={M}")
        g1 = RK.rollout_backward(weights, saved_p, z, t2j, dout)
        g2 = RK.rollout_backward(weights, saved_p, z, t2j, dout)
        res["bwd_bit_identical"] = all(bool(torch.equal(a, b))
                                       for a, b in zip(g1, g2))
        if not res["bwd_bit_identical"]:
            fail(f"backward kernel: two runs differ at T={steps} M={M}")
    print(f"[compare T={steps} M={M}] " + json.dumps(res))
    if timed:
        res["fwd_ms"] = cuda_ms(
            lambda: RK.rollout_forward(weights, carry0, z, t2j), 10)
        res["fwd_plain_ms"] = cuda_ms(
            lambda: RK.rollout_forward_plain(weights, carry0, z, t2j), 3)
        res["bwd_ms"] = cuda_ms(
            lambda: RK.rollout_backward(weights, saved_p, z, t2j, dout), 10)
        res["bwd_plain_ms"] = cuda_ms(
            lambda: RK.rollout_backward_plain(weights, saved_p, z, t2j,
                                              dout), 3)
        print(f"[timing T={steps} M={M}] " + json.dumps(
            {k: res[k] for k in ("fwd_ms", "fwd_plain_ms", "bwd_ms",
                                 "bwd_plain_ms")}))
    return res


def check_bwd(weights, saved, z, t2j, dout, tol):
    """Backward kernel against the plain VJP on the same saved carries:
    finite outputs, the largest error of dcarry0, dz and dt2j over that
    output's largest magnitude at most `tol`. Returns (max abs error,
    max-scaled error)."""
    import torch

    from humor_torch.ops import rollout_kernel as RK

    g_k = RK.rollout_backward(weights, saved, z, t2j, dout)
    g_p = RK.rollout_backward_plain(weights, saved, z, t2j, dout)
    torch.cuda.synchronize()
    steps, M = z.shape[:2]
    err, scaled = 0.0, 0.0
    for name, a, b in zip(("dcarry0", "dz", "dt2j"), g_k, g_p):
        if not bool(torch.isfinite(a).all()):
            fail(f"backward kernel: non-finite {name} at T={steps} M={M}")
        diff = (a - b).abs().max().item()
        err = max(err, diff)
        scaled = max(scaled, diff / (b.abs().max().item() + 1e-6))
    if scaled > tol:
        fail(f"backward kernel disagrees at T={steps} M={M}: max-scaled "
             f"{scaled:.3e} (tol {tol})")
    return err, scaled


def row_errors(g_k, g_p):
    """Per row, the largest error of dcarry0, dz and dt2j over that
    output's largest magnitude (rows are independent rollouts)."""
    import torch

    errs = []
    for a, b in zip(g_k, g_p):
        d = (a - b).abs() / (b.abs().max() + 1e-6)
        errs.append(d.transpose(0, 1).reshape(d.shape[1], -1).max(1).values
                    if d.dim() == 3 else d.max(1).values)
    return torch.stack(errs).max(0).values


def edge_shapes(weights, weights64, damped_weights, damped64):
    """(M, T, weights, float64 weights) at which phase 2 holds both
    rollout kernels to their edge tolerances: rows off and on the 16-row
    tiles and past 2 x 64 (M in EDGE_M) at T in EDGE_T steps, and the
    zoom search's probes on the CLI path (M = B rows, T_ROLL steps), with
    the decoder damped as every T_ROLL-step comparison here."""
    return [(M, steps, weights, weights64) for M in EDGE_M
            for steps in EDGE_T] + [(B, T_ROLL, damped_weights, damped64)]


def check_bwd_edges(shapes):
    """The backward kernel at each of `shapes` (edge_shapes) against the
    plain VJP: every row within 1e-4 max-scaled (the T=6 bound), but
    for rows at a float32 ReLU tie: a ReLU input of the float64
    recompute within RELU_TIE of zero (relative to its layer's mean
    magnitude), where two float32 evaluations may take different branches
    (measured: one such row at M=128, T=6 matched the float64 VJP with
    that unit's mask flipped to 1.4e-7). Those rows are reported. Returns
    the largest max-scaled error of the other rows."""
    import torch

    from humor_torch.ops import rollout_kernel as RK

    found, ties = {}, {}
    for M, steps, weights, weights64 in shapes:
        carry0, z, t2j, dout = rollout_inputs(M, steps, seed=100 + M + steps)
        _, saved = RK.rollout_forward_plain(weights, carry0, z, t2j)
        g_k = RK.rollout_backward(weights, saved, z, t2j, dout)
        g_p = RK.rollout_backward_plain(weights, saved, z, t2j, dout)
        if not all(bool(torch.isfinite(a).all()) for a in g_k):
            fail(f"backward kernel: non-finite output at T={steps} M={M}")
        err = row_errors(g_k, g_p)
        off = (err > 1e-4).nonzero().flatten()
        key = f"M={M},T={steps}"
        if len(off):
            margin = RK.relu_margins(weights64, saved.double(),
                                     z.double())[off]
            ties[key] = {int(r): [float(e), float(m)] for r, e, m in
                         zip(off, err[off], margin)}
            if bool((margin >= RELU_TIE).any()):
                fail(f"backward kernel disagrees at T={steps} M={M} in "
                     f"rows that are no ReLU tie: {ties[key]}")
            err[off] = 0.0
        found[key] = float(err.max())
    print("[bwd edges] " + json.dumps({"max_scaled": found,
                                       "tie_rows_err_margin": ties}))
    return max(found.values())


def check_fwd_edges(shapes):
    """The forward kernel at each of `shapes` (edge_shapes) against the
    plain forward: out and the saved carries within 1e-4 + 1e-4 |plain|
    (the T=6 bound of tests/test_torch_cuda_kernels.py). Returns the
    largest abs error of out without the prior variance (exp of a head
    output, compared relatively) and of saved."""
    import torch

    from humor_torch.ops import rollout_kernel as RK

    found = {}
    for M, steps, weights, _ in shapes:
        carry0, z, t2j, _ = rollout_inputs(M, steps, seed=200 + M + steps)
        out_k, saved_k = RK.rollout_forward(weights, carry0, z, t2j)
        out_p, saved_p = RK.rollout_forward_plain(weights, carry0, z, t2j)
        if not (bool(torch.isfinite(out_k).all())
                and bool(torch.isfinite(saved_k).all())):
            fail(f"forward kernel: non-finite output at T={steps} M={M}")
        over = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                   for a, b in ((out_k, out_p), (saved_k, saved_p)))
        err = max((out_k[..., :PV] - out_p[..., :PV]).abs().max().item(),
                  (saved_k - saved_p).abs().max().item())
        pv = ((out_k[..., PV:] - out_p[..., PV:]).abs()
              / out_p[..., PV:].abs()).max().item()
        found[f"M={M},T={steps}"] = [err, pv, over]
        if over > 1e-4:
            fail(f"forward kernel disagrees at T={steps} M={M}: abs "
                 f"{err:.3e}, prior var rel {pv:.3e} (tol 1e-4 + 1e-4 "
                 "|plain|)")
    print("[fwd edges] " + json.dumps({"max_abs_err_pv_rel_over": found}))
    return max(e for e, _, _ in found.values())


def time_fwd(weights, M, steps):
    """The forward kernel's time at (M, steps)."""
    from humor_torch.ops import rollout_kernel as RK

    carry0, z, t2j, _ = rollout_inputs(M, steps, seed=M)
    return cuda_ms(lambda: RK.rollout_forward(weights, carry0, z, t2j), 5)


def weight_bytes(weights):
    return 4.0 * sum(t.numel() for part in (weights.prior, weights.decoder)
                     for t in part[0] + part[1])


def fwd_bound(weights, M, steps):
    """The forward's FLOP; the weights, carry0 and z read and out and the
    saved carries written once."""
    from humor_torch.ops import rollout_kernel as RK

    io = 4.0 * M * (RK.CW + steps * (48 + RK.OUT_W + RK.CW))
    return bound(rollout_flops(M, steps), weight_bytes(weights) + io)


def time_bwd(weights, M, steps):
    """The backward kernel's time at (M, steps), saved carries from the
    forward kernel."""
    from humor_torch.ops import rollout_kernel as RK

    carry0, z, t2j, dout = rollout_inputs(M, steps, seed=M)
    _, saved = RK.rollout_forward(weights, carry0, z, t2j)
    return cuda_ms(lambda: RK.rollout_backward(weights, saved, z, t2j, dout),
                   5)


def bwd_bound(weights, M, steps):
    """Twice the forward's FLOP (recompute + transposed products); the
    weights read twice, saved, z, dout read and the cotangents written
    once."""
    from humor_torch.ops import rollout_kernel as RK

    io = 4.0 * M * (steps * (RK.CW + 48 + RK.OUT_W + 48) + RK.CW)
    return bound(2 * rollout_flops(M, steps), 2 * weight_bytes(weights) + io)


def nn_inputs(clouds, n, m, seed, hidden=0.1):
    """Seeded body-sized clouds 2.5 m in front of the camera: xyz2 (the
    mesh) and xyz1 (its points with 1 cm noise), the last `hidden` share
    of the queries at 1e6 as the point-cloud energy puts missing ones."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    y = rng.randn(clouds, m, 3) * [0.25, 0.5, 0.15] + [0.0, 0.3, 2.5]
    pick = rng.randint(0, m, size=(clouds, n))
    x = np.take_along_axis(y, pick[..., None], 1) + rng.randn(clouds, n, 3) \
        * 0.01
    n_vis = n - int(round(hidden * n))
    x[:, n_vis:] = 1e6
    dev = torch.device("cuda")
    return (torch.tensor(x, dtype=torch.float32, device=dev),
            torch.tensor(y, dtype=torch.float32, device=dev), n_vis)


def compare_nn(name, x, y, n_vis, first_index=None):
    """Kernel against plain version on visible queries: distances within
    NN_TOL; an index may differ only at a near-tie, where the two chosen
    points' float64 distances lie within NN_TOL. With `first_index`, the
    queries of those columns must get exactly the plain (first) index."""
    import torch

    from humor_torch.ops import chamfer as CH

    d_k, i_k = CH.nn_forward(x, y)
    d_p, i_p = CH.nn_distance_plain(x, y)
    torch.cuda.synchronize()
    dk, dp = d_k[:, :n_vis], d_p[:, :n_vis]
    ik, ip = i_k[:, :n_vis].long(), i_p[:, :n_vis].long()
    err = (dk - dp).abs().max().item()
    differ = ik != ip
    xv = x[:, :n_vis].double()
    y64 = y.double()

    def d64(idx):
        nn = torch.gather(y64, 1, idx[..., None].expand(-1, -1, 3))
        return ((xv - nn) ** 2).sum(-1)

    tie_gap = ((d64(ik) - d64(ip)).abs()[differ].max().item()
               if bool(differ.any()) else 0.0)
    hidden_ok = bool(((i_k[:, n_vis:] >= 0)
                      & (i_k[:, n_vis:] < y.shape[1])).all()) and bool(
        torch.isfinite(d_k).all())
    res = {"shape": list(x.shape[:2]) + [y.shape[1]], "max_abs_err": err,
           "index_agreement": 1.0 - differ.double().mean().item(),
           "index_mismatches": int(differ.sum()), "max_tie_gap": tie_gap}
    if first_index is not None:
        res["first_index_ok"] = bool((ik[:, first_index] ==
                                      ip[:, first_index]).all())
    print(f"[nn {name}] " + json.dumps(res))
    if not (err <= NN_TOL and tie_gap <= NN_TOL and hidden_ok
            and res.get("first_index_ok", True)):
        fail(f"nn_distance kernel disagrees ({name}): {res}")
    return res


def nn_design():
    """The nearest-neighbour kernel's sizes as csrc/nn_distance.cu sets
    them: Q (queries a thread), BLOCK (threads a block), C (points a
    chunk), TILE (points a staged tile), MIN_BLOCKS (blocks an SM)."""
    import re

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "humor_torch", "csrc", "nn_distance.cu")
    with open(src) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def nn_edge_sizes():
    """(clouds, N, M) at the edges of the kernel's design: M = 1, C - 1,
    C, C + 1, one tile - 1, + 0, + 1, two tiles - 1, + 0, + 1 (the PROX
    mesh's 6890 sits among them at the current sizes) and an M whose
    fourth tile ends inside a chunk; N is no multiple of a block's
    queries."""
    d = nn_design()
    c, tile = d["C"], d["TILE"]
    n = 2 * d["BLOCK"] * d["Q"] - 24
    return ((1, n, 1), (2, n, c - 1), (2, n, c), (2, n, c + 1),
            (1, n, tile - 1), (1, n, tile), (1, n, tile + 1),
            (1, n, 2 * tile - 1), (1, n, 2 * tile), (1, n, 2 * tile + 1),
            (2, n, 4 * tile - c - 11))


def check_nn():
    """The comparisons of phase 2, then the times at the fit's full shape
    and at stage 3's 240-cloud shape. Returns (max abs err at the fit's
    slice, the [timing nn] record)."""
    import torch

    from humor_torch.ops import chamfer as CH

    clouds = B * T
    x, y, n_vis = nn_inputs(clouds, N_POINTS, V_VERTS, seed=0)
    res = compare_nn("fit slice", x, y, n_vis)
    # the reverse direction: mesh vertices as queries into the cloud
    compare_nn("reverse", y, x, V_VERTS)
    del x, y
    # duplicated points: the last 890 points repeat the first 890, and
    # every 8th query sits 1 mm from one of those
    x2, y2, n2 = nn_inputs(8, 1024, V_VERTS, seed=1, hidden=0.0)
    y2[:, -890:] = y2[:, :890]
    q = torch.arange(0, 1024, 8, device=x2.device)
    x2[:, q] = y2[:, q % 890] + 1e-3
    compare_nn("duplicates", x2, y2, n2, first_index=q)
    x3, y3, n3 = nn_inputs(7, 1031, 2053, seed=2)
    compare_nn("prime sizes", x3, y3, n3)
    for k, (c, n, m) in enumerate(nn_edge_sizes()):
        # point 0 repeated in its own chunk and as the last point; the
        # first 8 queries sit 1 mm from it
        xe, ye, ne = nn_inputs(c, n, m, seed=10 + k)
        dup = sorted({j for j in (1, m - 1) if 0 < j < m})
        if dup:
            ye[:, dup] = ye[:, :1].clone()
        xe[:, :8] = ye[:, :1] + 1e-3 * torch.arange(
            1, 9, device=xe.device, dtype=xe.dtype)[:, None]
        compare_nn(f"edge {c}x{n}x{m}", xe, ye, ne,
                   first_index=torch.arange(8, device=xe.device))
    rec = {}
    for key, c in (("", K_CAND * clouds), ("_240", K_CAND * 2 * 15)):
        shape = (c, N_POINTS, V_VERTS)
        xf, yf, _ = nn_inputs(*shape, seed=3)
        rec["shape" + key] = shape
        rec["ms" + key] = cuda_ms(lambda: CH.nn_forward(xf, yf), 10)
        if not key:
            rec["plain_ms"] = cuda_ms(lambda: CH.nn_distance_plain(xf, yf), 2)
        rec["bound_ms" + key] = nn_bound(shape)[0]
        del xf, yf
    print("[timing nn] " + json.dumps(rec))
    return res["max_abs_err"], rec


def nn_bound(shape):
    """6 FLOP a pair (3 products, 3 sums: the JAX cost model's count);
    inputs read once, dist and idx written once."""
    nc, nq, nm = shape
    return bound(6.0 * nc * nq * nm, 4.0 * 3 * nc * (nq + nm) + 8.0 * nc * nq)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def make_models():
    import torch

    from humor_torch.body_model.smpl import synthetic_smpl_model
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import gmm, humor as H, vposer as vp

    g = torch.Generator().manual_seed(0)
    vcfg, hcfg = vp.VPoserConfig(), H.HumorConfig()
    return O.TTOModels(
        body=synthetic_smpl_model(seed=1234, num_verts=V_VERTS,
                                  num_joints=22),
        vposer_cfg=vcfg, vposer=vp.init_params(vcfg, g),
        humor_cfg=hcfg, humor=H.init_params(hcfg, g),
        init_gmm=gmm.GmmParams(torch.ones(12) / 12, torch.zeros(12, 138),
                               torch.eye(138).expand(12, 138, 138).clone()))


def make_observations(models, seed):
    """Joints of a seeded VPoser pose sequence with a random root, as
    benchmarks/bench_tto.py makes them."""
    import numpy as np
    import torch

    from humor_torch.fitting import optimizer as O
    from humor_torch.models import vposer as vp

    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    z = f(rng.randn(B, T, models.vposer_cfg.latent_dim) * 0.3)
    pose = vp.latent2pose(models.vposer_cfg, models.vposer, z)
    trans = f(rng.randn(B, T, 3) * 0.1)
    ro = f(np.tile(rng.randn(B, 1, 3) * 0.2, (1, T, 1)))
    with torch.no_grad():
        gt = O.smpl_results(models.body, trans, ro, pose, torch.zeros(B, 16))
    return {"joints3d": gt["joints3d"]}


SMPL2OP = tuple(i % 22 for i in range(25))    # bench_tto.py's map for
CAM_F, CAM_C = (1060.5, 1060.4), (951.3, 536.8)  # the 22-joint body
FLOOR = (0.0, 1.0, 0.0, 1.5)


def prox_models(models):
    """The models with the synthetic body's template moved so that its
    rest root joint sits at the origin, as SMPL's pelvis nearly does. The
    PROX init puts each frame's translation at its cloud's centroid, and
    the bisquare weights (|distance| over a MAD scale) give no gradient
    when every point is far: with the synthetic root 0.9 m up, the fit
    would start outside the point term's reach (measured on the CPU:
    0.7 m from the cloud after stage 2, against 0.08 m root-centred)."""
    import dataclasses

    body = models.body
    j0 = body.j_regressor[0] @ body.v_template
    return models._replace(body=dataclasses.replace(
        body, v_template=body.v_template - j0))


def make_prox_observations(models, seed, frames=T, points=N_POINTS):
    """A PROX RGB-D observation of a seeded VPoser pose sequence ~2.5 m in
    front of the camera (-y up), as benchmarks/bench_tto.py makes its RGB
    ones but turned near the fit's initial root orientation (pi about x,
    as PROX bodies face the camera): its OpenPose joints projected with
    2 px noise (confidence 1), and per frame `points` of its mesh
    vertices with 1 cm noise, 2% of them pushed 0.5 m off (outliers for
    the bisquare cut) and the last 10% of the rows inf (a short cloud's
    padding)."""
    import numpy as np
    import torch

    from humor_torch.fitting import geometry as geo
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import vposer as vp

    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    z = f(rng.randn(B, frames, models.vposer_cfg.latent_dim) * 0.3)
    trans = f(rng.randn(B, frames, 3) * 0.1 + [0.0, 0.3, 2.5])
    ro = f(np.tile(rng.randn(B, 1, 3) * 0.2 + [np.pi, 0.0, 0.0],
                   (1, frames, 1)))
    cam_f, cam_c = f(np.tile(CAM_F, (B, 1))), f(np.tile(CAM_C, (B, 1)))
    with torch.no_grad():
        pose = vp.latent2pose(models.vposer_cfg, models.vposer, z)
        gt = O.smpl_results(models.body, trans, ro, pose, torch.zeros(B, 16),
                            verts="full")
        full = torch.cat([gt["joints3d"], gt["joints3d_extra"]], dim=2)
        op3d = full[:, :, list(SMPL2OP)].reshape(B * frames, 25, 3)
        uv = geo.perspective_projection(
            op3d, torch.eye(3).expand(B * frames, 3, 3),
            torch.zeros(B * frames, 3), cam_f.repeat_interleave(frames, 0),
            cam_c.repeat_interleave(frames, 0))
    uv = uv.reshape(B, frames, 25, 2).numpy() \
        + rng.randn(B, frames, 25, 2) * 2.0
    verts = gt["points3d"].numpy()
    pick = rng.rand(*verts.shape[:3]).argsort(axis=-1)[..., :points]
    pts = np.take_along_axis(verts, pick[..., None], 2) \
        + rng.randn(B, frames, points, 3) * 0.01
    n_out = int(0.02 * points)
    off = rng.randn(B, frames, n_out, 3)
    pts[:, :, :n_out] += 0.5 * off / np.linalg.norm(off, axis=-1,
                                                    keepdims=True)
    pts[:, :, points - points // 10:] = np.inf
    return {"points3d": f(pts),
            "joints2d": f(np.concatenate([uv, np.ones((B, frames, 25, 1))],
                                         -1)),
            "cam_f": cam_f, "cam_center": cam_c,
            "floor_plane": f(np.tile(FLOOR, (B, 1)))}


def prox_config(num_iters, frames=T):
    """configs/fit_proxd.cfg: its stage weights, bisquare at 4.6851, the
    floor plane optimized."""
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O

    w12 = E.StageWeights(points3d=1.0, joints2d=0.001, pose_prior=0.1,
                         shape_prior=0.034, joints3d_smooth=100.0)
    w3 = E.StageWeights(points3d=1.0, joints2d=0.001, shape_prior=0.034,
                        motion_prior=0.075, init_motion_prior=0.075,
                        joint_consistency=100.0, bone_length=2000.0,
                        contact_vel=100.0, contact_height=10.0, floor_reg=1.0)
    return O.TTOConfig(
        seq_len=frames, stage_weights=(w12, w12, w3),
        energy=E.EnergyConfig(robust_loss="bisquare",
                              robust_tuning_const=4.6851,
                              smpl2op_map=SMPL2OP),
        num_iters=num_iters, optim_floor=True,
        stage3_tune_init_num_frames=min(15, frames),
        stage3_freeze_start=min(30, num_iters[2]),
        stage3_freeze_end=min(55, num_iters[2]))


def check_prox_objectives(models, frames=8, points=256):
    """The PROX stage objectives on the card (nearest neighbours in the
    kernel) against the same on the CPU (the plain version, which the CPU
    tests hold against the JAX package), at a small input: B=2 windows x
    8 frames x 256 points on the full 6890-vertex body. Values rtol 1e-4,
    gradients 1e-3 of their max (the CPU tests' tolerances)."""
    import torch

    from humor_torch.fitting import optimizer as O

    cfg = prox_config((1, 1, 1), frames)
    obs = make_prox_observations(models, 1, frames, points)
    errs = {}
    with torch.no_grad():
        fm_cpu = O.prepare_models(models, "cpu")
        v12 = O.init_variables(cfg, fm_cpu.models, B, obs, "cpu")
        v12["latent_pose"] = v12["latent_pose"] + 0.1
        v3 = O.stage3_setup(cfg, fm_cpu, v12)
    w3 = cfg.stage_weights[2]
    cases = (
        ("stage1", lambda fm, v: O.stage1_objective(cfg, fm, v, "full"), v12,
         ("trans", "root_orient")),
        ("stage2", lambda fm, v: O.stage2_objective(cfg, fm), v12,
         ("trans", "root_orient", "latent_pose", "betas")),
        ("stage3", lambda fm, v: O.stage3_objective(
            fm, w3, frames, 1.0, cfg.energy, optim_floor=True), v3, tuple(v3)))
    for name, make, v, keys in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            fm = O.prepare_models(models, dev)
            leaves = {k: t.to(dev).clone().requires_grad_(k in keys)
                      for k, t in v.items()}
            ob = {k: t.to(dev) for k, t in obs.items()}
            val = make(fm, leaves)(leaves, ob).sum()
            grads = torch.autograd.grad(val, [leaves[k] for k in keys])
            out[dev] = (float(val.detach()), [g.cpu() for g in grads])
        (vc, gc), (vg, gg) = out["cpu"], out["cuda"]
        g_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                    for a, b in zip(gg, gc))
        errs[name] = {"value_rel": abs(vg - vc) / abs(vc), "grad_scaled": g_err}
    print("[prox objectives card vs cpu] " + json.dumps(errs))
    for name, e in errs.items():
        if not (e["value_rel"] <= 1e-4 and e["grad_scaled"] <= 1e-3):
            fail(f"PROX {name} objective on the card disagrees with the CPU:"
                 f" {e}")


def reset_launches():
    from humor_torch.ops import chamfer as CH
    from humor_torch.ops import rollout_kernel as RK

    for counts in (RK.launches, CH.launches):
        for k in counts:
            counts[k] = 0


def read_launches():
    from humor_torch.ops import chamfer as CH
    from humor_torch.ops import rollout_kernel as RK

    return {**RK.launches, **CH.launches}


def check_result(res, num_iters, shapes):
    """Finite losses of the right length, stages 1-2 lowered, finite
    outputs of the expected shapes."""
    import torch

    losses = {k: v.cpu() for k, v in res.losses.items()}
    for k, n in zip(("stage1", "stage2", "stage3"), num_iters):
        if losses[k].numel() != n:
            fail(f"{k}: {losses[k].numel()} loss entries, want {n}")
        if not bool(torch.isfinite(losses[k]).all()):
            fail(f"{k} losses not finite: {losses[k].tolist()}")
    for k in ("stage1", "stage2"):
        if not losses[k][-1] < losses[k][0]:
            fail(f"{k} did not lower its loss: {losses[k].tolist()}")
    for k, shp in shapes.items():
        v = res.final[k]
        if tuple(v.shape) != shp or not bool(torch.isfinite(v).all()):
            fail(f"final {k}: shape {tuple(v.shape)} (want {shp}) or "
                 "non-finite values")
    return losses


FINAL_SHAPES = {"trans": (B, T, 3), "root_orient": (B, T, 3),
                "pose_body": (B, T, 63), "betas": (B, 16),
                "latent_motion": (B, T - 1, 48),
                "joints3d_rollout": (B, T, 22, 3), "contacts": (B, T, 22)}


def cloud_to_mesh_m(models, obs, stage):
    """Mean distance (m) from the visible observed points to the mesh of
    a stage's exported fit (plain nearest neighbours)."""
    import torch

    from humor_torch.fitting import optimizer as O
    from humor_torch.ops import chamfer as CH

    dev = stage["trans"].device
    body = models.body.to(dev)
    with torch.no_grad():
        mesh = O.smpl_results(body, stage["trans"], stage["root_orient"],
                              stage["pose_body"], stage["betas"],
                              verts="full")["points3d"]
        pts = obs["points3d"].to(dev)
        vis = torch.isfinite(pts[..., 0])
        q = torch.where(torch.isfinite(pts), pts, torch.full_like(pts, 1e6))
        d, _ = CH.nn_distance_plain(q.reshape(B * T, N_POINTS, 3),
                                    mesh.reshape(B * T, -1, 3))
        return float(d.reshape(B, T, N_POINTS).sqrt()[vis].mean())


def run_prox_fit(models):
    """Phase 4: the stage objectives on the card against the CPU, then
    the PROX RGB-D fit, counted from zero."""
    import torch

    from humor_torch.fitting import optimizer as O

    models = prox_models(models)
    check_prox_objectives(models)
    runner = O.make_runner(prox_config(PROX_ITERS), models, device="cuda")
    obs = make_prox_observations(models, seed=0)
    reset_launches()
    timings = {}
    t0 = time.perf_counter()
    res = runner(obs, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = check_result(res, PROX_ITERS, dict(
        FINAL_SHAPES, floor_plane=(B, 4), prior_trans=(B, T, 3)))
    for k, n in launches.items():
        if n <= 0:
            fail(f"the PROX fit never launched {k}")
    if launches["nn_distance"] != PROX_NN_LAUNCHES:
        fail(f"the PROX fit launched nn_distance {launches['nn_distance']} "
             f"times, want one per evaluation ({PROX_NN_LAUNCHES})")
    c2m = [cloud_to_mesh_m(models, obs, res.per_stage[k])
           for k in ("stage1", "stage2")]
    print("[prox fit] " + json.dumps({
        "seconds": wall, "stage_seconds": timings,
        "final_losses": {k: float(v[-1]) for k, v in losses.items()},
        "first_losses": {k: float(v[0]) for k, v in losses.items()},
        "stage1_cloud_to_mesh_m": c2m[0], "stage2_cloud_to_mesh_m": c2m[1],
        "floor_plane": res.final["floor_plane"].cpu().tolist(),
        "launches": launches}))
    if not (c2m[0] <= C2M_LIMITS[0] and c2m[1] <= C2M_LIMITS[1]):
        fail(f"the PROX fit ends {c2m} m from the cloud after stages 1-2 "
             f"(limits {C2M_LIMITS})")
    profiled = O.make_runner(prox_config(PROFILE_ITERS), models,
                             device="cuda")
    profile_fit(profiled, obs)
    return launches


def profile_fit(runner, obs):
    """The fit once unprofiled, then under torch.profiler: the device-busy
    share of the profiled wall time and of the unprofiled one (the
    profiler slows the host several-fold, not the device), and the
    kernels with the most device time (only device kernel events are
    summed: host-side ranges that enclose them would count their time
    twice)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from humor_torch.ops import rollout_kernel as RK

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(obs)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    names = ("rollout_fwd", "rollout_bwd")
    calls = {k: RK.launches[k] for k in names}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner(obs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = {k: RK.launches[k] - calls[k] for k in names}
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]
    kernels = {k: sum(n for name, (n, _) in per_name.items()
                      if k + "_kernel" in name) for k in names}
    print("[profile] " + json.dumps({
        **{k + "_calls": calls[k] for k in names},
        **{k + "_device_kernels": kernels[k] for k in names},
        "wall_s": wall, "unprofiled_wall_s": plain_wall,
        "device_busy_s": busy_ms / 1e3,
        "device_busy_share": busy_ms / 1e3 / wall,
        "device_busy_share_unprofiled": busy_ms / 1e3 / plain_wall,
        "kernel_launches": sum(n for n, _ in per_name.values()),
        "top": [{"name": k[:80], "count": n, "device_ms": ms}
                for k, (n, ms) in top]}))
    for k in names:
        if calls[k] <= 0 or kernels[k] != calls[k]:
            fail(f"{calls[k]} {k} calls enqueued {kernels[k]} {k} device "
                 "kernels, want exactly one a call")


def make_rgb_observations(models, seed, frames=T, device="cpu"):
    """benchmarks/bench_tto.py's RGB observation, made with the port:
    per window a seeded VPoser pose sequence with its root ~(0, 0.3, 2.5)
    m from the camera (-y up), its 25 OpenPose joints (SMPL2OP) projected
    with CAM_F / CAM_C plus 2 px noise, confidence 1; the floor FLOOR;
    windows [b (frames - 10), b (frames - 10) + frames): 10 frames shared
    by consecutive windows."""
    import numpy as np
    import torch

    from humor_torch.fitting import geometry as geo
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import vposer as vp

    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    z = f(rng.randn(B, frames, models.vposer_cfg.latent_dim) * 0.3)
    trans = f(rng.randn(B, frames, 3) * 0.1 + [0.0, 0.3, 2.5])
    ro = f(np.tile(rng.randn(B, 1, 3) * 0.2, (1, frames, 1)))
    cam_f, cam_c = f(np.tile(CAM_F, (B, 1))), f(np.tile(CAM_C, (B, 1)))
    with torch.no_grad():
        pose = vp.latent2pose(models.vposer_cfg, models.vposer, z)
        gt = O.smpl_results(models.body, trans, ro, pose, torch.zeros(B, 16))
        full = torch.cat([gt["joints3d"], gt["joints3d_extra"]], dim=2)
        op3d = full[:, :, list(SMPL2OP)].reshape(B * frames, 25, 3)
        uv = geo.perspective_projection(
            op3d, torch.eye(3).expand(B * frames, 3, 3),
            torch.zeros(B * frames, 3), cam_f.repeat_interleave(frames, 0),
            cam_c.repeat_interleave(frames, 0))
    uv = uv.reshape(B, frames, 25, 2).numpy() \
        + rng.randn(B, frames, 25, 2) * 2.0
    start = np.arange(B) * (frames - 10)
    obs = {"joints2d": f(np.concatenate([uv, np.ones((B, frames, 25, 1))],
                                        -1)),
           "cam_f": cam_f, "cam_center": cam_c,
           "floor_plane": f(np.tile(FLOOR, (B, 1))),
           "seq_interval": torch.tensor(np.stack([start, start + frames], 1),
                                        dtype=torch.int32)}
    return {k: v.to(device) for k, v in obs.items()}


def rgb_config(num_iters, frames=T, freeze=(30, 55)):
    """bench_tto.py's RGB stage weights (the overlap consistency at 200 in
    every stage), the floor plane optimized, the stage-3 freeze at 30 and
    55 iterations (`freeze`)."""
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O

    w1 = E.StageWeights(joints2d=0.001, joints3d_smooth=100.0,
                        rgb_overlap_consist=200.0)
    w2 = E.StageWeights(joints2d=0.001, pose_prior=2e-4, shape_prior=1.67e-4,
                        joints3d_smooth=100.0, rgb_overlap_consist=200.0)
    w3 = E.StageWeights(joints2d=0.001, pose_prior=2e-4, shape_prior=1.67e-4,
                        motion_prior=1e-3, init_motion_prior=1e-3,
                        joint_consistency=1.0, bone_length=10.0,
                        contact_vel=1.0, contact_height=1.0, floor_reg=0.167,
                        rgb_overlap_consist=200.0)
    return O.TTOConfig(
        seq_len=frames, stage_weights=(w1, w2, w3),
        energy=E.EnergyConfig(smpl2op_map=SMPL2OP), num_iters=num_iters,
        optim_floor=True, stage3_tune_init_num_frames=min(15, frames),
        stage3_freeze_start=min(freeze[0], num_iters[2]),
        stage3_freeze_end=min(freeze[1], num_iters[2]))


def check_rgb_objectives(models, frames=8, K=3, device="cuda"):
    """The RGB stage objectives (the overlap terms on, K=3 distinct
    candidates folded into K*B rows against the untiled seq_interval) on
    the card against the same on the CPU, which the CPU tests hold
    against the JAX package, at B=2 windows x 8 frames on the full
    6890-vertex body. Values rtol 1e-4, gradients 1e-3 of their max."""
    import torch

    from humor_torch.fitting import optimizer as O

    cfg = rgb_config((1, 1, 1), frames)
    obs = make_rgb_observations(models, 1, frames)
    gen = torch.Generator().manual_seed(7)
    jitter = lambda t: t.repeat(K, *([1] * (t.dim() - 1))) + 0.02 * torch.randn(
        (K * t.shape[0],) + tuple(t.shape[1:]), generator=gen)
    with torch.no_grad():
        fm_cpu = O.prepare_models(models, "cpu")
        v12 = O.init_variables(cfg, fm_cpu.models, B, obs, "cpu")
        v12["latent_pose"] = v12["latent_pose"] + 0.1
        v3 = O.stage3_setup(cfg, fm_cpu, v12)
    # stage 1 varies only the root over the candidates; its closure skins
    # the B windows once
    v1 = {k: jitter(t) if k in ("trans", "root_orient") else t
          for k, t in v12.items()}
    cases = (
        ("stage1", lambda fm, v: O.stage1_objective(
            cfg, fm, {k: t.to(v["trans"].device) for k, t in v12.items()},
            "keypt"), v1, ("trans", "root_orient")),
        ("stage2", lambda fm, v: O.stage2_objective(cfg, fm),
         {k: jitter(t) for k, t in v12.items()},
         ("trans", "root_orient", "latent_pose", "betas")),
        ("stage3", lambda fm, v: O.stage3_objective(
            fm, cfg.stage_weights[2], frames, 1.0, cfg.energy,
            optim_floor=True), {k: jitter(t) for k, t in v3.items()},
         tuple(v3)))
    errs = {}
    for name, make, v, keys in cases:
        out = {}
        for dev in ("cpu", device):
            fm = O.prepare_models(models, dev)
            leaves = {k: t.to(dev).clone().requires_grad_(k in keys)
                      for k, t in v.items()}
            ob = O.tile_observations({k: t.to(dev) for k, t in obs.items()},
                                     K)
            rows = make(fm, leaves)(leaves, ob)
            if tuple(rows.shape) != (K * B,):
                fail(f"RGB {name} objective: {tuple(rows.shape)} rows, want "
                     f"{K * B}")
            val = rows.sum()
            grads = torch.autograd.grad(val, [leaves[k] for k in keys])
            out[dev] = (float(val.detach()), [g.cpu() for g in grads])
        (vc, gc), (vg, gg) = out["cpu"], out[device]
        g_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                    for a, b in zip(gg, gc))
        errs[name] = {"value_rel": abs(vg - vc) / abs(vc), "grad_scaled": g_err}
    print("[rgb objectives card vs cpu] " + json.dumps(errs))
    for name, e in errs.items():
        if not (e["value_rel"] <= 1e-4 and e["grad_scaled"] <= 1e-3):
            fail(f"RGB {name} objective on the card disagrees with the CPU: "
                 f"{e}")


def reprojection_px(models, obs, stage, smpl2op=SMPL2OP):
    """Mean distance (px) between the observed 2D keypoints that the fit
    sees (confidence > 0, not ignored) and a stage's exported fit
    projected with the observation's camera."""
    import torch

    from humor_torch.body_model import constants as BC
    from humor_torch.fitting import geometry as geo
    from humor_torch.fitting import optimizer as O

    st = {k: v.detach().cpu() for k, v in stage.items()}
    nb, nt = st["trans"].shape[:2]
    with torch.no_grad():
        pred = O.smpl_results(models.body, st["trans"], st["root_orient"],
                              st["pose_body"], st["betas"])
        full = torch.cat([pred["joints3d"], pred["joints3d_extra"]], dim=2)
        op3d = full[:, :, list(smpl2op)].reshape(nb * nt, 25, 3)
        cam_f, cam_c = obs["cam_f"].cpu(), obs["cam_center"].cpu()
        uv = geo.perspective_projection(
            op3d, torch.eye(3).expand(nb * nt, 3, 3), torch.zeros(nb * nt, 3),
            cam_f.repeat_interleave(nt, 0), cam_c.repeat_interleave(nt, 0)
        ).reshape(nb, nt, 25, 2)
        j2d = obs["joints2d"].cpu()
        seen = j2d[..., 2] > 0
        seen[..., list(BC.OP_IGNORE_JOINTS)] = False
        err = (uv - j2d[..., :2]).norm(dim=-1)
    return float(err[seen].mean())


def overlap_gap_m(models, obs, stage):
    """Mean distance (m) between the keypoint vertices of consecutive
    windows over the frames they share."""
    import torch

    from humor_torch.fitting import optimizer as O

    st = {k: v.detach().cpu() for k, v in stage.items()}
    iv = obs["seq_interval"].cpu().long()
    with torch.no_grad():
        v = O.smpl_results(models.body, st["trans"], st["root_orient"],
                           st["pose_body"], st["betas"],
                           verts="keypt")["verts3d"]
    gaps = []
    for b in range(iv.shape[0] - 1):
        o = int(iv[b, 1] - iv[b + 1, 0])
        gaps.append((v[b, -o:] - v[b + 1, :o]).norm(dim=-1).reshape(-1))
    return float(torch.cat(gaps).mean())


def run_rgb_fit(models, device="cuda", iters=RGB_ITERS):
    """Phase 6: the RGB objectives on the card against the CPU, then the
    RGB video fit of bench.py (B=2 windows x 60 frames sharing 10, 2D
    keypoints, the floor, the overlap consistency, the depth init from
    bone lengths), counted from zero; then the stitched video."""
    import numpy as np
    import torch

    from humor_torch.fitting import optimizer as O
    from humor_torch.fitting import results as RS

    check_rgb_objectives(models, device=device)
    cfg = rgb_config(iters)
    runner = O.make_runner(cfg, models, device=device)
    obs = make_rgb_observations(models, seed=0, device=device)
    with torch.no_grad():
        init = O.init_variables(cfg, O.models_to(models, device), B, obs,
                                device)
    init_depth = float(init["trans"][..., 2].mean())
    reset_launches()
    timings = {}
    t0 = time.perf_counter()
    res = runner(obs, timings=timings)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = check_result(res, iters, dict(
        FINAL_SHAPES, floor_plane=(B, 4), prior_trans=(B, T, 3)))
    for k in ("rollout_fwd", "rollout_bwd"):
        if launches[k] <= 0:
            fail(f"the RGB fit never launched {k}")
    if launches["nn_distance"] != 0:
        fail(f"the RGB fit launched nn_distance {launches['nn_distance']} "
             "times: it has no point cloud")
    depth = float(res.final["trans"][..., 2].mean())
    reproj = [reprojection_px(models, obs, res.per_stage[k])
              for k in ("stage1", "stage2")]
    gaps = {k: overlap_gap_m(models, obs, res.per_stage[k])
            for k in ("stage2", "stage3")}
    stitched = RS.stitch_windows(
        {k: res.final[k] for k in ("trans", "root_orient", "pose_body",
                                   "betas", "contacts", "floor_plane")},
        obs["seq_interval"].cpu().numpy())
    frames = int(obs["seq_interval"][-1, 1] - obs["seq_interval"][0, 0])
    print("[rgb fit] " + json.dumps({
        "seconds": wall, "stage_seconds": timings,
        "final_losses": {k: float(v[-1]) for k, v in losses.items()},
        "first_losses": {k: float(v[0]) for k, v in losses.items()},
        "init_depth_m": init_depth, "final_depth_m": depth,
        "stage1_reproj_px": reproj[0], "stage2_reproj_px": reproj[1],
        "overlap_gap_m": gaps,
        "floor_plane": res.final["floor_plane"].cpu().tolist(),
        "stitched_frames": int(stitched["trans"].shape[0]),
        "launches": launches}))
    if not RGB_DEPTH_M[0] < depth < RGB_DEPTH_M[1]:
        fail(f"the RGB fit's depth {depth} m is outside {RGB_DEPTH_M}")
    if not all(lo <= r <= hi for r, (lo, hi) in zip(reproj,
                                                    RGB_REPROJ_LIMITS)):
        fail(f"the RGB fit reprojects {reproj} px after stages 1-2 (limits "
             f"{RGB_REPROJ_LIMITS})")
    if not RGB_GAP_LIMITS[0] <= gaps["stage2"] <= RGB_GAP_LIMITS[1]:
        fail(f"the RGB fit's windows part by {gaps['stage2']} m over their "
             f"shared frames after stage 2 (limits {RGB_GAP_LIMITS})")
    if stitched["trans"].shape != (frames, 3) or not all(
            np.isfinite(v).all() for v in stitched.values()):
        fail(f"the stitched video has {stitched['trans'].shape} translations"
             f" (want ({frames}, 3)) or non-finite values")
    prior = {dev: RS.to_prior_frame(stitched, models.body, device=dev)
             for dev in (device, "cpu")}
    prior_err = max(float(np.abs(prior[device][k] - prior["cpu"][k]).max())
                    for k in ("trans", "root_orient"))
    print("[rgb prior frame card vs cpu] " + json.dumps(
        {"frames": int(prior[device]["trans"].shape[0]),
         "max_abs_err": prior_err}))
    if not prior_err <= 1e-4:
        fail(f"the stitched video's prior frame on the card parts from the "
             f"CPU's by {prior_err}")
    return launches


def compare_rgb_stage3(models, device="cuda",
                       iters=(0, 0, RGB_STAGE3_CMP_ITERS),
                       freeze=RGB_STAGE3_CMP_FREEZE):
    """Stage 3 of the RGB fit alone (from the depth init: stages 1-2 at 0
    iterations; its three phases with the freeze at `freeze`, both
    rollout kernels, the floor and the overlap terms), with the decoder
    head
    damped x0.1, three times: on the card, on the CPU, and on the card
    with the 2D keypoints nudged by 1e-4 px. The L-BFGS path is chaotic
    even damped (a nudge parts it after ~14 iterations), so the histories
    are held only over their first RGB_STAGE3_ITERS iterations (rtol
    RGB_STAGE3_RTOL), and the card's final translations may part from the
    CPU's at most RGB_STAGE3_NUDGE_RATIO times as far as from its own
    nudged run."""
    import torch

    from humor_torch.fitting import optimizer as O

    cfg = rgb_config(iters, freeze=freeze)
    obs = make_rgb_observations(models, seed=0)
    nudged = dict(obs, joints2d=obs["joints2d"] + torch.tensor(
        [1e-4, 1e-4, 0.0]))
    dm = models._replace(humor=damped(models.humor, 0.1))
    runs = {}
    for name, dev, ob in (("card", device, obs), ("cpu", "cpu", obs),
                          ("card_nudged", device, nudged)):
        t0 = time.perf_counter()
        r = O.make_runner(cfg, dm, device=dev)(ob)
        runs[name] = ({k: v.detach().cpu() for k, v in r.final.items()},
                      r.losses["stage3"].detach().cpu(),
                      time.perf_counter() - t0)
        if not all(torch.isfinite(v).all()
                   for v in (*runs[name][0].values(), runs[name][1])):
            fail(f"damped RGB stage 3 ({name}) is not finite")

    def gaps(a, b):
        (fa, ha, _), (fb, hb, _) = runs[a], runs[b]
        rel = ((ha - hb).abs() / hb.abs()).tolist()
        return {"loss_rel_head": rel[:4],
                "loss_rel_first": max(rel[:RGB_STAGE3_ITERS]),
                "loss_rel_all": max(rel),
                "first_iter_over": {f"{t:g}": next(
                    (i for i, r in enumerate(rel) if r > t), None)
                    for t in (1e-5, 1e-4, 1e-3, 1e-2)},
                "trans_abs": float((fa["trans"] - fb["trans"]).abs().max()),
                "pose_abs": float((fa["pose_body"]
                                   - fb["pose_body"]).abs().max())}

    report = {"seconds": {k: r[2] for k, r in runs.items()},
              "depth_m": {k: float(r[0]["trans"][..., 2].mean())
                          for k, r in runs.items()},
              "gap_m": {k: overlap_gap_m(models, obs, r[0])
                        for k, r in runs.items()},
              "final_loss": {k: float(r[1][-1]) for k, r in runs.items()},
              "card_vs_cpu": gaps("card", "cpu"),
              "card_vs_nudged": gaps("card", "card_nudged")}
    print("[rgb stage 3 damped] " + json.dumps(report))
    err = report["card_vs_cpu"]["loss_rel_first"]
    if not err <= RGB_STAGE3_RTOL:
        fail(f"damped RGB stage 3 on the card parts from the CPU by {err} "
             f"over its first {RGB_STAGE3_ITERS} iterations")
    cpu, nudge = (report[k]["trans_abs"] for k in ("card_vs_cpu",
                                                   "card_vs_nudged"))
    if not cpu <= RGB_STAGE3_NUDGE_RATIO * nudge:
        fail(f"damped RGB stage 3 on the card ends {cpu} m from the CPU, "
             f"over {RGB_STAGE3_NUDGE_RATIO}x its {nudge} m from a nudge")



# ---------------------------------------------------------------------------
# Phase 7: the CLIs on synthetic video layouts
# ---------------------------------------------------------------------------

# the RGB CLI's budget: stage 3's phases 5/5/5 (freeze at 5 and 10), so
# the hybrid search polishes each stage and each stage-3 phase with 2 zoom
# iterations (their probes roll out at M = B rows)
CLI_ITERS = (10, 10, 15)
CLI_FREEZE = (5, 10)
CLI_ZOOM_ITERS = 3             # stage 2 alone, zoom, card against CPU
PROX_FRAMES, PROX_SEQ = 30, 20  # the PROX-RGBD CLI's recording: 2 windows
PROX_IMG = (64, 48)            # its depth and body-index images (W, H)
PROX_FLOOR_M = 0.6             # its floor: 0.6 m below the depth camera


def write_keypoints(dirpath, joints2d, names=None):
    """One OpenPose JSON a frame, <name>_keypoints.json, one person with
    joints2d[t] (25, 3) as its pose_keypoints_2d."""
    os.makedirs(dirpath, exist_ok=True)
    for t, kp in enumerate(joints2d):
        name = names[t] if names is not None else f"frame_{t:06d}"
        with open(os.path.join(dirpath, f"{name}_keypoints.json"), "w") as f:
            json.dump({"people": [{"pose_keypoints_2d": [
                float(v) for v in kp.reshape(-1)]}]}, f)
    return dirpath


def write_intrinsics(path, cam_f=CAM_F, cam_c=CAM_C):
    with open(path, "w") as f:
        json.dump([[cam_f[0], 0.0, cam_c[0]], [0.0, cam_f[1], cam_c[1]],
                   [0.0, 0.0, 1.0]], f)
    return path


def write_body_npz(root, body, gender="neutral"):
    """`body` as <root>/<gender>/model.npz, the AMASS SMPL+H layout that
    body_model.smpl.load_smpl_npz (and so the CLIs' --smplh-root) reads."""
    import numpy as np

    d = os.path.join(root, gender)
    os.makedirs(d, exist_ok=True)
    V = body.num_verts
    parents = np.asarray(body.parents, np.int64)
    np.savez(os.path.join(d, "model.npz"),
             v_template=body.v_template.cpu().numpy(),
             shapedirs=body.shapedirs.cpu().numpy(),
             posedirs=body.posedirs.cpu().numpy().T.reshape(V, 3, -1),
             J_regressor=body.j_regressor.cpu().numpy(),
             weights=body.lbs_weights.cpu().numpy(),
             kintree_table=np.stack([parents, np.arange(parents.size)]),
             f=np.asarray(body.faces))
    return root


def rgb_video_joints2d(models):
    """110 frames of OpenPose joints: make_rgb_observations' window 0,
    then window 1's last 50 frames."""
    import numpy as np

    j = make_rgb_observations(models, seed=0)["joints2d"].numpy()
    return np.concatenate([j[0], j[1, 10:]], axis=0)


def write_prox_recording(root, frames=PROX_FRAMES, seed=0,
                         size=PROX_IMG):
    """A PROX recording in the public layout: <root>/calibration/
    {IR,Color}.json (distortion on both cameras) and <root>/recordings/
    <rec>/{keypoints,Depth,BodyIndex}: per frame OpenPose joints near the
    colour image's centre, a 16-bit depth PNG (depth x 8000: a wall at
    3.5 m, a floor PROX_FLOOR_M below the depth camera in front of it, a
    person's 16 x 32-pixel box at ~2.5 m) and an 8-bit body-index PNG (0
    on the person, 255 elsewhere). Returns the recording's directory."""
    import numpy as np
    from PIL import Image

    from humor_torch.data.prox import undistort_points

    rng = np.random.RandomState(seed)
    W, H = size
    calib = os.path.join(root, "calibration")
    rec = os.path.join(root, "recordings", "N0Sofa_00034_01")
    for d in (calib, *(os.path.join(rec, s) for s in
                       ("keypoints", "Depth", "BodyIndex"))):
        os.makedirs(d, exist_ok=True)
    cams = {
        "IR": {"camera_mtx": [[50.0, 0.0, W / 2], [0.0, 50.0, H / 2],
                              [0.0, 0.0, 1.0]],
               "k": [0.05, -0.08, 0.001, -0.002, 0.01],
               "view_mtx": [[0.999, -0.02, 0.03, 0.05],
                            [0.02, 0.999, 0.01, -0.02],
                            [-0.03, -0.01, 0.999, 0.01]]},
        "Color": {"camera_mtx": [[CAM_F[0], 0.0, CAM_C[0]],
                                 [0.0, CAM_F[1], CAM_C[1]],
                                 [0.0, 0.0, 1.0]],
                  "k": [0.02, -0.03, 0.0005, 0.0005, 0.0],
                  "view_mtx": [[1.0, 0.0, 0.0, -0.05], [0.0, 1.0, 0.0, 0.0],
                               [0.0, 0.0, 1.0, 0.0]],
                  "R": [0.01, -0.02, 0.005], "T": [0.05, 0.0, 0.0]}}
    for name, cam in cams.items():
        with open(os.path.join(calib, f"{name}.json"), "w") as f:
            json.dump(cam, f)
    # the depth at which each pixel's ray (undistorted, as the loader
    # reads it) meets the plane y = PROX_FLOOR_M of the depth camera
    uv = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    ray_y = undistort_points(uv, np.asarray(cams["IR"]["camera_mtx"]),
                             np.asarray(cams["IR"]["k"]))[:, 1].reshape(H, W)
    floor_z = np.where(ray_y > 0, PROX_FLOOR_M / np.maximum(ray_y, 1e-9),
                       np.inf)
    base = rng.randn(25, 2) * [60.0, 150.0] + [960.0, 540.0]
    names = [f"s001_frame_{t:05d}" for t in range(frames)]
    kps = []
    for t, name in enumerate(names):
        kps.append(np.concatenate([base + rng.randn(25, 2) * 2.0 + [t, 0.0],
                                   np.full((25, 1), 0.9)], axis=-1))
        depth = np.minimum(3.5, floor_z) + rng.randn(H, W) * 0.005
        mask = np.full((H, W), 255, np.uint8)
        x0, y0 = W // 2 - 8 + t % 5, H // 2 - 16
        depth[y0:y0 + 32, x0:x0 + 16] = 2.5 + rng.randn(32, 16) * 0.01
        mask[y0:y0 + 32, x0:x0 + 16] = 0
        Image.fromarray((depth * 8000.0).astype(np.uint16)).save(
            os.path.join(rec, "Depth", name + ".png"))
        Image.fromarray(mask).save(os.path.join(rec, "BodyIndex",
                                                name + ".png"))
    write_keypoints(os.path.join(rec, "keypoints"), np.stack(kps), names)
    return rec


def _cli_fit(argv, device):
    """One fit CLI run counted from zero: (result, seconds, launches)."""
    import torch

    from humor_torch.fitting import cli as FC

    reset_launches()
    t0 = time.perf_counter()
    res = FC.main(argv + ["--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_launches()


def compare_zoom(models, device="cuda"):
    """Stage 2 of the RGB fit alone with the zoom search (each probe one
    evaluation at M = B rows), on the card and on the CPU: the first
    RGB_STAGE3_ITERS history values within RGB_STAGE3_RTOL (the rule the
    chaotic stage-3 path settled on)."""
    import dataclasses

    import torch

    from humor_torch.fitting import optimizer as O

    cfg = dataclasses.replace(rgb_config((0, CLI_ZOOM_ITERS, 0)),
                              lbfgs_linesearch="zoom")
    obs = make_rgb_observations(models, seed=0)
    hist = {d: O.make_runner(cfg, models, device=d)(obs).losses[
        "stage2"].cpu() for d in (device, "cpu")}
    rel = ((hist[device] - hist["cpu"]).abs() / hist["cpu"].abs()).tolist()
    print("[cli zoom card vs cpu] " + json.dumps(
        {"stage2_card": hist[device].tolist(),
         "stage2_cpu": hist["cpu"].tolist(), "rel": rel}))
    if not (torch.isfinite(hist[device]).all()
            and max(rel[:RGB_STAGE3_ITERS]) <= RGB_STAGE3_RTOL):
        fail(f"the zoom search's stage 2 on the card parts from the CPU by "
             f"{rel} (first {RGB_STAGE3_ITERS} within {RGB_STAGE3_RTOL})")


def run_clis(models, device="cuda", iters=CLI_ITERS):
    """Phase 7: the RGB fit CLI at full width on a 110-frame video (2
    windows x 60 frames, the hybrid search), the fit-eval CLI on its
    output, the zoom search card against CPU, and the PROX-RGBD fit CLI
    on a small recording. Returns the launches of the RGB and the PROX
    CLI runs."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from humor_torch.eval import fitting_cli as FE

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        smplh = write_body_npz(os.path.join(tmp, "smplh"), models.body)
        video = write_keypoints(os.path.join(tmp, "video"),
                                rgb_video_joints2d(models))
        intr = write_intrinsics(os.path.join(tmp, "intrinsics.json"))
        out = os.path.join(tmp, "fit_rgb")
        res, wall, launches["rgb_cli"] = _cli_fit(
            ["--data-path", video, "--data-type", "RGB", "--seq-len", "60",
             "--overlap-len", "10", "--rgb-intrinsics", intr,
             "--lbfgs-linesearch", "hybrid", "--smplh-root", smplh,
             "--num-iters", *map(str, iters), "--num-iters-scale", "1",
             "--stage3-freeze-start", str(CLI_FREEZE[0]),
             "--stage3-freeze-end", str(CLI_FREEZE[1]),
             "--out", out, "--save-stages-results"], device)
        losses = check_result(res, iters, dict(
            FINAL_SHAPES, floor_plane=(B, 4), prior_trans=(B, T, 3)))
        stitched = dict(np.load(os.path.join(out, "final_results",
                                             "stage3_results.npz")))
        t0 = time.perf_counter()
        FE.main(["--results", out, "--out", os.path.join(tmp, "eval"),
                 "--stages", "final,stage2", "--mode", "2d",
                 "--smplh-root", smplh, "--device", device])
        eval_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "eval", "compare_mean.csv")) as f:
            rows = list(csv.reader(f))
        print("[cli rgb] " + json.dumps({
            "seconds": wall, "eval_seconds": eval_s,
            "final_losses": {k: float(v[-1]) for k, v in losses.items()},
            "first_losses": {k: float(v[0]) for k, v in losses.items()},
            "stitched_frames": int(stitched["trans"].shape[0]),
            "csv_rows": len(rows) - 1, "launches": launches["rgb_cli"]}))
        for k in ("rollout_fwd", "rollout_bwd"):
            if launches["rgb_cli"][k] <= 0:
                fail(f"the RGB CLI never launched {k}")
        if launches["rgb_cli"]["nn_distance"] != 0:
            fail("the RGB CLI launched nn_distance: it has no point cloud")
        if stitched["trans"].shape != (110, 3) or not all(
                np.isfinite(v).all() for v in stitched.values()):
            fail(f"the RGB CLI stitched {stitched['trans'].shape} "
                 "translations (want (110, 3)) or non-finite values")
        vals = [float(v) for r in rows[1:] for v in r[1:] if v != ""]
        if len(rows) < 2 or not vals or not np.isfinite(vals).all():
            fail(f"the fit-eval CLI's compare_mean.csv is empty or not "
                 f"finite: {rows}")

        compare_zoom(models, device)

        rec = write_prox_recording(os.path.join(tmp, "prox"))
        res, wall, launches["prox_cli"] = _cli_fit(
            ["@" + os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "fit_proxd.cfg"),
             "--data-path", rec, "--seq-len", str(PROX_SEQ),
             "--smplh-root", smplh, "--num-iters", "3", "3", "3",
             "--num-iters-scale", "1", "--stage3-tune-init-num-frames", "5",
             "--stage3-freeze-start", "1", "--stage3-freeze-end", "2",
             "--out", os.path.join(tmp, "fit_prox")], device)
        print("[cli prox] " + json.dumps({
            "seconds": wall, "windows": int(res.final["trans"].shape[0]),
            "final_losses": {k: float(v[-1]) for k, v in res.losses.items()},
            "launches": launches["prox_cli"]}))
        if launches["prox_cli"]["nn_distance"] <= 0:
            fail("the PROX-RGBD CLI never launched nn_distance")
        if not all(bool(torch.isfinite(v).all())
                   for v in (*res.losses.values(), res.final["trans"])):
            fail("the PROX-RGBD CLI's losses or translations are not finite")
    return launches


# phase 8: training. Card against CPU at TRAIN_CMP_B windows x
# TRAIN_T transitions with injected draws: loss and grad_norm within
# TRAIN_LOSS_RTOL, every gradient leaf within TRAIN_GRAD_TOL max-scaled
# (the tier-1 tolerances against JAX); then steps timed at the config's
# B=200, the train CLI at B=200 on the synthetic sequences through the
# three curriculum phases, and the fit CLI on its checkpoint.
TRAIN_T = 10                   # configs/train_humor.cfg --sample-num-frames
TRAIN_B = 200                  # configs/train_humor.cfg --batch-size
TRAIN_CMP_B = 16
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_TIMED = 5                # timed steps of each kind at B=200
TRAIN_EPOCHS, TRAIN_STEPS = 3, 8   # supervised, mixed, full sched. sampling
SS_USE_GT = (True, False, False, True, False, False, False, True, False,
             False)            # the card-vs-CPU scheduled-sampling draw


def train_bodies(num_verts=V_VERTS):
    """Seeded synthetic male and female bodies (the train CLI's
    stand-in seeds) at the full vertex count."""
    from humor_torch.body_model.smpl import synthetic_smpl_model

    return {"male": synthetic_smpl_model(seed=10, num_verts=num_verts),
            "female": synthetic_smpl_model(seed=20, num_verts=num_verts)}


def train_batch(bodies, batch, seed, device):
    """A batch of synthetic windows as the train CLI builds them."""
    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.data.windows import window_to_pairs

    world, meta = synthetic_world_batch(seed, batch, TRAIN_T + 1,
                                        model=bodies["male"], device=device)
    din, dout, _ = window_to_pairs(world)
    return {"data_in": din, "data_out": dout, "betas": meta["betas"],
            "gender_ids": meta["gender_ids"].long() % 2}


def train_grads(params, bodies, batch, device, sched, eps, cfg=None,
                loss_cfg=None):
    """(loss, grad_norm, grads) of one step's loss on `device` (the
    default HuMoR configuration and loss unless `cfg` / `loss_cfg` are
    given)."""
    import torch

    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS

    cfg = cfg or H.HumorConfig()
    loss_cfg = loss_cfg or LossConfig()
    to = lambda x: x.to(device)
    models = {k: v.to(device) for k, v in bodies.items()}
    params = TS.tree_map(lambda p: to(p).detach().requires_grad_(True),
                         params)
    batch = {k: ({n: to(v) for n, v in b.items()} if isinstance(b, dict)
                 else to(b)) for k, b in batch.items()}
    if sched:
        fn = TS.sched_samp_loss_fn(cfg, loss_cfg, models)
        loss, _ = fn(params, batch, 10, 0.5, use_gt=SS_USE_GT,
                     eps=to(eps))
    else:
        fn = TS.supervised_loss_fn(cfg, loss_cfg, models)
        loss, _ = fn(params, batch, 10, eps=to(eps))
    grads = torch.autograd.grad(loss, TS.tree_leaves(params))
    return (float(loss.detach()), float(TS.global_norm(grads)),
            [g.detach().cpu() for g in grads])


def compare_train_steps(device="cuda", batch=TRAIN_CMP_B):
    """Phase 8a: the supervised and scheduled-sampling losses and
    gradients on the card against the CPU, same weights, batch and
    draws."""
    import torch

    from humor_torch.models import humor as H

    bodies = train_bodies()
    params = H.init_params(H.HumorConfig(), torch.Generator().manual_seed(3))
    data = train_batch(bodies, batch, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    eps = {False: torch.randn(batch * TRAIN_T, 48, generator=g),
           True: torch.randn(TRAIN_T, batch, 48, generator=g)}
    rec = {}
    for sched in (False, True):
        card = train_grads(params, bodies, data, device, sched, eps[sched])
        cpu = train_grads(params, bodies, data, "cpu", sched, eps[sched])
        scaled = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(card[2], cpu[2]))
        name = "sched_samp" if sched else "supervised"
        rec[name] = {"loss_card": card[0], "loss_cpu": cpu[0],
                     "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
                     "grad_norm_rel": abs(card[1] - cpu[1]) / abs(cpu[1]),
                     "grad_max_scaled": scaled}
    print("[train card vs cpu] " + json.dumps(rec))
    for name, r in rec.items():
        if not (r["loss_rel"] <= TRAIN_LOSS_RTOL
                and r["grad_norm_rel"] <= TRAIN_LOSS_RTOL
                and r["grad_max_scaled"] <= TRAIN_GRAD_TOL):
            fail(f"{name} step on the card parts from the CPU: {r}")
    return rec


def time_train_steps(device="cuda", batch=TRAIN_B, reps=TRAIN_TIMED):
    """ms a supervised and a scheduled-sampling (use_gt_p 0.5) step at
    the config's batch, with the peak device memory of each."""
    import torch

    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS

    bodies = {k: v.to(device) for k, v in train_bodies().items()}
    cfg = H.HumorConfig()
    opt = TS.make_optimizer()
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                device)
    sup, ss, _ = TS.make_train_steps(cfg, LossConfig(), opt, bodies)
    data = train_batch(bodies, batch, seed=1, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    rec = {}
    for name, step in (("supervised", lambda s: sup(s, data, 10,
                                                    generator=gen)),
                       ("sched_samp", lambda s: ss(s, data, 10, 0.5,
                                                   generator=gen))):
        state, stats = step(state)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for _ in range(reps):
            state, stats = step(state)
            losses.append(float(stats["total_loss"]))
        torch.cuda.synchronize()
        rec[name] = {"ms": 1e3 * (time.perf_counter() - t0) / reps,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "losses": losses}
    print("[train steps B=%d] " % batch + json.dumps(rec))
    if not all(all(map(math.isfinite, r["losses"])) for r in rec.values()):
        fail(f"timed train steps gave non-finite losses: {rec}")
    return rec


def run_training(models, device="cuda", batch=TRAIN_B, steps=TRAIN_STEPS,
                 iters=CLI_ITERS):
    """Phase 8b-c: the train CLI (configs/train_humor.cfg at `batch`)
    on the synthetic sequences with 6890-vertex male and female bodies
    as SMPL+H npz files, TRAIN_EPOCHS epochs of `steps` steps covering
    the supervised, mixed and fully scheduled-sampling phases; then the
    fit CLI with its final checkpoint on phase 7's RGB layout. Returns
    the launches of each."""
    import tempfile

    import numpy as np
    import torch

    from humor_torch.train import cli as TC
    from humor_torch.train.trainer import _AUTO_STEPS_PER_DISPATCH

    root = os.path.dirname(os.path.abspath(__file__))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        smplh = os.path.join(tmp, "smplh")
        for gender, body in train_bodies().items():
            write_body_npz(smplh, body, gender)
        write_body_npz(smplh, models.body)
        out = os.path.join(tmp, "train")
        reset_launches()
        t0 = time.perf_counter()
        TC.main(["@" + os.path.join(root, "configs", "train_humor.cfg"),
                 "--device", device, "--batch-size", str(batch),
                 "--epochs", str(TRAIN_EPOCHS), "--steps-per-epoch",
                 str(steps), "--sched-samp-start", "0",
                 "--sched-samp-end", "2", "--val-every", "1",
                 "--print-every", str(steps), "--out", out,
                 "--data-path", os.path.join(tmp, "no_amass"),
                 "--smplh-root", smplh])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["train_cli"] = read_launches()
        with open(os.path.join(out, "stats.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "train.log")) as f:
            log = f.read()
        losses = [r["total_loss"] for r in rows]
        # one stats row a chunk of the trainer's auto k, then one a step
        # of an epoch's remainder
        k = _AUTO_STEPS_PER_DISPATCH
        want_rows = TRAIN_EPOCHS * (steps // k + steps % k)
        phases = {p: f"gt_p={p}" in log for p in ("1.00", "0.50", "0.00")}
        ckpts = {n: os.path.exists(os.path.join(out, n)) for n in (
            "best_train_model.npz", "best_model.npz", "final_model.npz")}
        print("[train cli] " + json.dumps({
            "seconds": wall, "steps": rows[-1]["step"] if rows else 0,
            "stat_rows": len(rows), "k": k, "batch": batch,
            "ms_per_step_incl_data_val_ckpt": 1e3 * wall / (TRAIN_EPOCHS
                                                          * steps),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "phases": phases, "checkpoints": ckpts,
            "launches": launches["train_cli"]}))
        if (len(rows) != want_rows
                or rows[-1]["step"] != TRAIN_EPOCHS * steps
                or not np.isfinite([v for r in rows
                                    for v in r.values()]).all()):
            fail(f"the train CLI logged {len(rows)} rows to step "
                 f"{rows[-1]['step'] if rows else 0} (want {want_rows} to "
                 f"{TRAIN_EPOCHS * steps}) or non-finite stats")
        if not all(phases.values()) or not all(ckpts.values()):
            fail(f"the train CLI missed a curriculum phase {phases} or a "
                 f"checkpoint {ckpts}")

        # HuMoR-Qual: an epoch teacher-forced, then one fully scheduled
        # with the SMPL joints fed back
        qual = os.path.join(tmp, "train_qual")
        reset_launches()
        t0 = time.perf_counter()
        TC.main(["@" + os.path.join(root, "configs", "train_humor_qual.cfg"),
                 "--device", device, "--batch-size", str(batch),
                 "--epochs", "2", "--steps-per-epoch", "2",
                 "--sched-samp-start", "0", "--sched-samp-end", "1",
                 "--out", qual, "--data-path", os.path.join(tmp, "no_amass"),
                 "--smplh-root", smplh])
        launches["train_qual_cli"] = read_launches()
        with open(os.path.join(qual, "stats.jsonl")) as f:
            qrows = [json.loads(line) for line in f]
        with open(os.path.join(qual, "train.log")) as f:
            qlog = f.read()
        print("[train qual cli] " + json.dumps({
            "seconds": time.perf_counter() - t0, "steps": len(qrows),
            "losses": [r["total_loss"] for r in qrows],
            "launches": launches["train_qual_cli"]}))
        if len(qrows) != 4 or "gt_p=0.00" not in qlog or not np.isfinite(
                [v for r in qrows for v in r.values()]).all():
            fail("the HuMoR-Qual train CLI missed its scheduled-sampling "
                 "epoch or logged non-finite stats")

        video = write_keypoints(os.path.join(tmp, "video"),
                                rgb_video_joints2d(models))
        intr = write_intrinsics(os.path.join(tmp, "intrinsics.json"))
        res, fit_wall, launches["trained_fit_cli"] = _cli_fit(
            ["--data-path", video, "--data-type", "RGB", "--seq-len", "60",
             "--overlap-len", "10", "--rgb-intrinsics", intr,
             "--smplh-root", smplh, "--humor-ckpt",
             os.path.join(out, "final_model.npz"),
             "--num-iters", *map(str, iters), "--num-iters-scale", "1",
             "--stage3-freeze-start", str(CLI_FREEZE[0]),
             "--stage3-freeze-end", str(CLI_FREEZE[1]),
             "--out", os.path.join(tmp, "fit_trained")], device)
        finite = all(bool(torch.isfinite(v).all()) for v in (
            *res.losses.values(), res.final["trans"],
            res.final["pose_body"]))
        print("[trained fit cli] " + json.dumps({
            "seconds": fit_wall, "finite": finite,
            "final_losses": {k: float(v[-1]) for k, v in res.losses.items()},
            "launches": launches["trained_fit_cli"]}))
        for k in ("rollout_fwd", "rollout_bwd"):
            if launches["trained_fit_cli"][k] <= 0:
                fail(f"the fit CLI on the trained checkpoint never launched "
                     f"{k}")
        if not finite:
            fail("the fit CLI on the trained checkpoint gave non-finite "
                 "losses or outputs")
    return launches


# phase 9: the dataset-level entry points on synthetic AMASS trees. The
# AMASS fit CLI with configs/fit_amass_joints.cfg at its own 30/70/70,
# fit_amass_keypts.cfg at AMASS_KEYPTS_ITERS and a surface-points variant
# at AMASS_POINTS_ITERS; the GMM's k-means++ and EM card against CPU, EM
# timed at the GMM CLI's real size, the GMM CLI; the evaluation CLI's four
# configs; the preprocessing CLI card against CPU and the cleanup CLI.
AMASS_SEQ_FRAMES = 400         # raw frames at 60 fps: 159 processed
AMASS_KEYPTS_ITERS = (10, 10, 15)
AMASS_POINTS_ITERS = (3, 3, 3)
AMASS_FREEZE = (5, 10)         # stage-3 freeze points of the short runs
AMASS_OBS_TOL = 1e-5           # observations, card against CPU
AMASS_FLIP_SHARE = 1e-3        # surface points on another face, at most
GMM_CMP_N, GMM_CMP_ITERS = 2000, 5
GMM_N, GMM_D, GMM_K, GMM_ITERS = 200000, 138, 12, 100
# card against CPU, the CPU tests' bounds against JAX: weights abs,
# means and covariances max-scaled, mean log-likelihood relative
GMM_TOL = {"weights": 2e-5, "means": 1e-4, "covs": 1e-4, "ll": 1e-5}
PROCESS_TOL = 1e-4             # processed arrays, card against CPU, scaled
SAMPLING_SECONDS = 10.0        # configs/test_humor_sampling.cfg


def write_raw_sequence(path, seed, frames=AMASS_SEQ_FRAMES, gender="male"):
    """A raw AMASS-style npz: 60 fps, a slow random walk, seeded poses."""
    import numpy as np

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, fps=60.0, gender=gender,
             trans=np.cumsum(rng.randn(frames, 3) * 0.01, axis=0),
             root_orient=rng.randn(frames, 3) * 0.2,
             pose_body=rng.randn(frames, 63) * 0.1,
             pose_hand=rng.randn(frames, 90) * 0.05,
             betas=rng.randn(16) * 0.3)
    return path


def write_processed_tree(root, body, device, n=B):
    """n processed sequences under <root>/CMU/01 (data/amass.process_file
    with `body` on `device`); returns root."""
    import torch

    from humor_torch.data import amass as A

    body = body.to(device)
    for i in range(n):
        raw = write_raw_sequence(os.path.join(root, "_raw", f"s{i}_poses.npz"),
                                 seed=100 + i)
        if A.process_file(body, raw, os.path.join(root, "CMU", "01"),
                          discard_terrain=False) is None:
            fail(f"synthetic sequence {i} was discarded")
    if device == "cuda":
        torch.cuda.synchronize()
    return root


def _max_scaled(a, b):
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def compare_amass_observations(data, body, device="cuda", seq_len=T):
    """The fit observations (joints with noise, surface points) built on
    the card and on the CPU: the joints, the ground truth and the mesh
    the points are sampled from within AMASS_OBS_TOL. The sampled points
    themselves are held only in share: the host's inverse-CDF face choice
    flips for a sample that falls within float32 rounding of a face
    boundary, and moves it to another face; at most AMASS_FLIP_SHARE of
    them may move."""
    import numpy as np
    import torch

    from humor_torch.body_model import smpl as S
    from humor_torch.data.dataset import AmassDataset, find_processed_files
    from humor_torch.data.fit_dataset import (FitObsConfig,
                                              amass_fit_batches,
                                              gt_axis_angle)

    ds = AmassDataset.from_npz_files(find_processed_files(data))
    cfg = FitObsConfig(seq_len=seq_len, use_joints=True, use_points=True,
                       noise_std=0.04)
    out = {d: list(amass_fit_batches(ds, cfg, B, seed=0, body=body,
                                     device=d)) for d in (device, "cpu")}
    err, moved, mesh = {}, 0.0, 0.0
    for (oc, gc, meta), (oh, gh, _) in zip(out[device], out["cpu"]):
        for k in ("trans", "root_orient", "pose_body", "joints3d"):
            err["gt_" + k] = float(np.abs(gc[k] - gh[k]).max())
        err["joints3d"] = float(np.abs(oc["joints3d"] - oh["joints3d"]).max())
        far = np.abs(oc["points3d"] - oh["points3d"]).max(-1) > AMASS_OBS_TOL
        moved = max(moved, float(far.mean()))
        verts = {}
        for d, g in ((device, gc), ("cpu", gh)):
            root, pose = gt_axis_angle(g, d)
            n = root.shape[0] * root.shape[1]
            with torch.no_grad():
                verts[d] = S.forward(
                    body.to(d), root.reshape(n, 3), pose.reshape(n, -1),
                    torch.as_tensor(meta["betas"], device=d)
                    .repeat_interleave(root.shape[1], dim=0),
                    torch.as_tensor(g["trans"], device=d).reshape(n, 3)
                ).v.cpu()
        mesh = max(mesh, float((verts[device] - verts["cpu"]).abs().max()))
    err["mesh"] = mesh
    print("[amass obs card vs cpu] " + json.dumps(
        {"max_abs": err, "points_moved_share": moved,
         "points": list(out["cpu"][0][0]["points3d"].shape)}))
    if max(err.values()) > AMASS_OBS_TOL or moved > AMASS_FLIP_SHARE:
        fail(f"the AMASS observations on the card part from the CPU: {err}, "
             f"{moved} of the surface points moved")


def _eval_mean(out):
    """eval_mean.csv as {metric: {stat: value}}; fails unless finite."""
    import csv

    with open(os.path.join(out, "eval_mean.csv")) as f:
        rows = list(csv.reader(f))
    table = {r[0]: {s: float(v) for s, v in zip(rows[0][1:], r[1:]) if v}
             for r in rows[1:]}
    vals = [v for r in table.values() for v in r.values()]
    if not vals or not all(map(math.isfinite, vals)):
        fail(f"{out}/eval_mean.csv is empty or not finite: {rows}")
    return table


def run_amass_fit(name, argv, iters, device, shapes=None):
    """One AMASS fit CLI run, counted from zero: the per-batch losses
    (check_result), no failed batch, a finite eval_mean.csv; returns
    (launches, record)."""
    res, wall, launches = _cli_fit(argv, device)
    if res["failed_batches"] or not res["results"]:
        fail(f"the {name} fit CLI failed {res['failed_batches']} batches")
    losses = [check_result(r, iters, shapes or FINAL_SHAPES)
              for r in res["results"]]
    out = argv[argv.index("--out") + 1]
    table = _eval_mean(out)
    rec = {"seconds": wall, "batches": len(res["results"]),
           "stage_seconds": res["stage_seconds"],
           "final_losses": {k: float(v[-1]) for k, v in losses[0].items()},
           "first_losses": {k: float(v[0]) for k, v in losses[0].items()},
           "mpjpe_mm": 1e3 * table["joints3d_all"]["mean"],
           "launches": launches}
    print(f"[{name}] " + json.dumps(rec))
    return launches, rec


def run_amass_fits(models, data, smplh, tmp, device="cuda", gmm=None,
                   seq_len=T, iters=NUM_ITERS, keypts_iters=AMASS_KEYPTS_ITERS,
                   points_iters=AMASS_POINTS_ITERS):
    """Phase 9a: the AMASS fit CLI on the processed tree `data`: the joints
    config at its own budget (with the GMM npz as its initial-state prior
    when given), the keypts config and a surface-points variant; each
    must launch both rollout kernels, the points one also the nearest
    neighbour, once per evaluation."""
    root = os.path.dirname(os.path.abspath(__file__))
    cfgs = os.path.join(root, "configs")
    common = ["--data-path", data, "--smplh-root", smplh, "--seq-len",
              str(seq_len), "--num-iters-scale", "1",
              "--humor-ckpt", "", "--vposer-ckpt", ""]
    shapes = {k: (B, seq_len) + v[2:] if k != "betas" else v
              for k, v in FINAL_SHAPES.items()}
    shapes["latent_motion"] = (B, seq_len - 1, 48)
    launches = {}
    launches["amass_joints_cli"], _ = run_amass_fit(
        "amass joints cli",
        ["@" + os.path.join(cfgs, "fit_amass_joints.cfg"), *common,
         "--num-iters", *map(str, iters),
         "--init-motion-prior-ckpt", gmm or "",
         "--out", os.path.join(tmp, "fit_amass_joints")], iters, device,
        shapes)
    short = ["--stage3-freeze-start", str(AMASS_FREEZE[0]),
             "--stage3-freeze-end", str(AMASS_FREEZE[1])]
    launches["amass_keypts_cli"], _ = run_amass_fit(
        "amass keypts cli",
        ["@" + os.path.join(cfgs, "fit_amass_keypts.cfg"), *common, *short,
         "--num-iters", *map(str, keypts_iters), "--init-motion-prior-ckpt",
         "", "--out", os.path.join(tmp, "fit_amass_keypts")],
        keypts_iters, device, shapes)
    launches["amass_points_cli"], _ = run_amass_fit(
        "amass points cli",
        ["@" + os.path.join(cfgs, "fit_amass_joints.cfg"), *common,
         "--stage3-freeze-start", "1", "--stage3-freeze-end", "2",
         "--amass-use-points", "--point3d-weight", "1", "1", "1",
         "--num-iters", *map(str, points_iters), "--init-motion-prior-ckpt",
         "", "--out", os.path.join(tmp, "fit_amass_points")],
        points_iters, device, shapes)
    for path, counts in launches.items():
        for k in ("rollout_fwd", "rollout_bwd"):
            if counts[k] <= 0:
                fail(f"the {path} run never launched {k}")
    for path in ("amass_joints_cli", "amass_keypts_cli"):
        if launches[path]["nn_distance"] != 0:
            fail(f"the {path} run launched nn_distance: no point cloud")
    # the initial evaluation of each of the 5 phases, one per iteration
    want = sum(points_iters) + 5
    if launches["amass_points_cli"]["nn_distance"] != want:
        fail(f"the AMASS points fit launched nn_distance "
             f"{launches['amass_points_cli']['nn_distance']} times, want one "
             f"per evaluation ({want})")
    return launches


def gmm_states(seed, n, d=GMM_D, k=GMM_K):
    """Seeded clustered (n, d) float32 states with per-dimension scales
    from 1e-2 to 10 (tests/test_torch_gmm_fit.py's)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 2.0
    labels = rng.randint(0, k, size=n)
    scales = np.exp(rng.uniform(np.log(1e-2), np.log(10.0), size=d))
    x = (centers[labels] + rng.randn(n, d) * rng.uniform(0.3, 1.0, (k, 1))[
        labels]) * scales
    return x.astype(np.float32)


def compare_gmm(device="cuda", n=GMM_CMP_N, iters=GMM_CMP_ITERS):
    """Phase 9b: k-means++ (the same seeds) and EM from the same seeds on
    the card against the CPU."""
    import torch

    from humor_torch.models import gmm as G

    data = torch.as_tensor(gmm_states(0, n))
    g = torch.Generator().manual_seed(7)
    first = int(torch.randint(n, (), generator=g))
    gum = G.gumbel((GMM_K - 1, n), g)
    seeds = {d: G.kmeanspp_init(data.to(d), GMM_K, first, gum).cpu()
             for d in (device, "cpu")}
    fits = {d: G.fit(data.to(d), GMM_K, iters, first=first, gumbels=gum)
            for d in (device, "cpu")}
    ll = {d: G.mean_log_prob(fits[d], data.to(d)) for d in fits}
    rec = {"seeds_equal": bool(torch.equal(seeds[device], seeds["cpu"])),
           "weights": float((fits[device].weights.cpu()
                             - fits["cpu"].weights).abs().max()),
           "means": _max_scaled(fits[device].means, fits["cpu"].means),
           "covs": _max_scaled(fits[device].covs, fits["cpu"].covs),
           "ll": abs(ll[device] - ll["cpu"]) / abs(ll["cpu"])}
    print(f"[gmm card vs cpu N={n} iters={iters}] " + json.dumps(rec))
    if not rec["seeds_equal"] or any(rec[k] > GMM_TOL[k] for k in GMM_TOL):
        fail(f"the GMM on the card parts from the CPU: {rec}")
    return rec


def time_gmm(device="cuda", n=GMM_N, iters=GMM_ITERS):
    """EM at the GMM CLI's size (max_states x 138, 12 components): seconds
    for `iters` sweeps and the peak device memory."""
    import torch

    from humor_torch.models import gmm as G

    data = torch.as_tensor(gmm_states(1, n), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    lls = []
    t0 = time.perf_counter()
    gmm = G.fit(data, GMM_K, iters, generator=gen, log_likelihoods=lls)
    if device == "cuda":
        torch.cuda.synchronize()
    rec = {"n": n, "d": GMM_D, "k": GMM_K, "iters": iters,
           "seconds": time.perf_counter() - t0,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if device == "cuda" else None),
           "peak_over_data_gb": ((torch.cuda.max_memory_allocated() - base)
                                 / 1e9 if device == "cuda" else None),
           "data_gb": data.numel() * 4 / 1e9,
           "first_ll": float(lls[0]), "last_ll": float(lls[-1])}
    print("[gmm em timed] " + json.dumps(rec))
    if not (all(bool(torch.isfinite(x).all()) for x in gmm)
            and math.isfinite(rec["last_ll"])
            and rec["last_ll"] >= rec["first_ll"]):
        fail(f"EM at N={n} gave non-finite values or lowered its "
             f"likelihood: {rec}")
    return rec


def run_gmm_cli(data, out, device="cuda"):
    """The GMM CLI on the processed tree; its npz read back through
    import_torch.load_gmm_checkpoint. Returns (launches, npz path)."""
    import torch

    from humor_torch.train import gmm_cli
    from humor_torch.utils import import_torch as IT

    path = os.path.join(out, "init_state_prior_gmm.npz")
    reset_launches()
    t0 = time.perf_counter()
    res = gmm_cli.main(["--data-path", data, "--out", path,
                        "--device", device])
    launches = read_launches()
    gmm = IT.load_gmm_checkpoint(path)
    print("[gmm cli] " + json.dumps({
        "seconds": time.perf_counter() - t0, **res,
        "components": gmm.num_components, "dim": gmm.dim,
        "launches": launches}))
    if not (gmm.weights.shape == (GMM_K,) and gmm.means.shape == (GMM_K, 138)
            and all(bool(torch.isfinite(x).all()) for x in gmm)
            and math.isfinite(res["mean_log_prob"])):
        fail(f"the GMM CLI's npz is not a finite 12 x 138 mixture: {res}")
    return launches, path


def run_eval_cli(data, smplh, tmp, device="cuda", sampling_seconds=
                 SAMPLING_SECONDS, batch=None):
    """Phase 9c: the evaluation CLI's four configs at full width with a
    checkpoint of seeded weights, the decoder head damped x0.1 (the
    undamped random-weight chain is chaotic over 59 steps, and the +5 m
    probe measures that): every output finite, the probe within the JAX
    package's bound; returns the launches of all four."""
    import numpy as np
    import torch

    from humor_torch.eval import cli as EC
    from humor_torch.models import humor as H
    from humor_torch.utils.checkpoint import save_state

    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(tmp, "humor_damped.npz")
    save_state(ckpt, damped(H.init_params(
        H.HumorConfig(), torch.Generator().manual_seed(0)), 0.1))
    reset_launches()
    recs = {}
    for cfg in ("test_humor", "test_humor_sampling",
                "test_humor_qual_sampling", "test_humor_recon"):
        out = os.path.join(tmp, cfg)
        argv = ["@" + os.path.join(root, "configs", cfg + ".cfg"),
                "--data-path", data, "--smplh-root", smplh, "--ckpt", ckpt,
                "--eval-sampling-len", str(sampling_seconds), "--out", out,
                "--device", device]
        if batch:
            argv += ["--batch-size", str(batch)]
        t0 = time.perf_counter()
        res = EC.main(argv)
        recs[cfg] = {"wall_seconds": time.perf_counter() - t0, **{
            k: v for r in res.values() for k, v in r.items()
            if k in ("seconds", "steps", "samples", "total_loss")}}
        if "recon" in res:
            e0, e5 = res["recon"]["base"], res["recon"]["translated_5m"]
            recs[cfg].update(base=e0, translated_5m=e5)
            for k in e0:
                if not (math.isfinite(e0[k]) and abs(e0[k] - e5[k])
                        < max(3e-3, 0.02 * abs(e0[k]))):
                    fail(f"the +5 m recon probe moved {k}: {e0} -> {e5}")
        if "test" in res and not all(map(math.isfinite,
                                         res["test"].values())):
            fail(f"non-finite test losses: {res['test']}")
        for f in os.listdir(out):
            if f.endswith(".npz"):
                with np.load(os.path.join(out, f)) as z:
                    if not all(np.isfinite(z[k]).all() for k in z.files):
                        fail(f"{cfg}: {f} is not finite")
        if "sampling" in res:
            n = len([f for f in os.listdir(out) if f.startswith("sample_")])
            recs[cfg]["files"] = n
            if n != res["sampling"]["samples"]:
                fail(f"{cfg} wrote {n} samples, want "
                     f"{res['sampling']['samples']}")
    launches = read_launches()
    print("[eval cli] " + json.dumps({**recs, "launches": launches}))
    return launches


def run_preprocessing(smplh, tmp, device="cuda"):
    """Phase 9d: a raw tree of four sequences (one a treadmill walk)
    processed on the card and on the CPU, held within PROCESS_TOL
    (max-scaled, array by array); then the cleanup CLI on the card's
    tree, which must move the treadmill sequence and nothing else.
    Returns the launches of the card's run."""
    import numpy as np

    from humor_torch.data import cleanup_amass, process_amass

    raw = os.path.join(tmp, "raw")
    for i, (rel, gender) in enumerate((
            ("CMU/01/a_poses.npz", "male"), ("CMU/01/b_poses.npz", "female"),
            ("KIT/3/c_poses.npz", "neutral"),
            ("BioMotionLab_NTroje/rub001/treadmill_fast_poses.npz",
             "male"))):
        write_raw_sequence(os.path.join(raw, rel), seed=200 + i,
                           frames=300, gender=gender)
    outs, secs = {}, {}
    for d in (device, "cpu"):
        outs[d] = os.path.join(tmp, f"processed_{d}")
        reset_launches()
        t0 = time.perf_counter()
        n = process_amass.main(["--amass-root", raw, "--out", outs[d],
                                "--smplh-root", smplh, "--device", d])
        secs[d] = time.perf_counter() - t0
        if d == device:
            launches = read_launches()
        if n != 4:
            fail(f"process_amass on {d} wrote {n} of 4 sequences")
    files = sorted(os.path.relpath(os.path.join(r, f), outs["cpu"])
                   for r, _, fs in os.walk(outs["cpu"]) for f in fs)
    err = 0.0
    for f in files:
        with np.load(os.path.join(outs[device], f)) as a, \
                np.load(os.path.join(outs["cpu"], f)) as b:
            for k in b.files:
                if b[k].dtype.kind not in "US":
                    err = max(err, _max_scaled(a[k], b[k]))
    moved = cleanup_amass.main(["--data-path", outs[device]])
    rec = {"seconds": secs, "files": len(files), "max_scaled": err,
           "moved": [os.path.relpath(m, outs[device]) for m in moved],
           "launches": launches}
    print("[preprocess] " + json.dumps(rec))
    if err > PROCESS_TOL:
        fail(f"process_amass on the card parts from the CPU by {err}")
    if len(moved) != 1 or "treadmill_fast" not in moved[0]:
        fail(f"cleanup_amass moved {moved}, want the treadmill sequence")
    return launches


def run_dataset_clis(models, device="cuda"):
    """Phase 9 on a temporary directory; returns each path's launches
    (the evaluation, GMM and preprocessing paths must launch none)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        smplh = write_body_npz(os.path.join(tmp, "smplh"), models.body)
        for gender, body in train_bodies().items():
            write_body_npz(smplh, body, gender)
        data = write_processed_tree(os.path.join(tmp, "amass"), models.body,
                                    device)
        compare_amass_observations(data, models.body, device)
        compare_gmm(device)
        time_gmm(device)
        launches = {}
        launches["gmm_cli"], gmm = run_gmm_cli(data, tmp, device)
        launches.update(run_amass_fits(models, data, smplh, tmp, device,
                                       gmm=gmm))
        launches["eval_cli"] = run_eval_cli(data, smplh, tmp, device)
        launches["preprocess_cli"] = run_preprocessing(smplh, tmp, device)
    for path in ("gmm_cli", "eval_cli", "preprocess_cli"):
        if any(launches[path].values()):
            fail(f"the {path} path launched a kernel: {launches[path]}")
    print("[phase 9] " + json.dumps(
        {"seconds": time.perf_counter() - t0}))
    return launches


# phase 10: the trained mini-HuMoR/VPoser fixture (humor_torch.testing) at
# the JAX fixture's full budget on the card, then both accuracy fits of
# tests/test_tto_accuracy.py (zoom search, the JAX test's shapes, budgets,
# seeds) held to that test's bounds (testing.JOINTS3D_BOUNDS, RGB_BOUNDS),
# the RGB fit's absolute-depth bounds (testing.RGB_DEPTH_BOUNDS) printed
# beside their values, not held: the JAX package's own fit misses each of
# them when its observation moves by under 2.5e-4 px (the readings are
# beside RGB_DEPTH_BOUNDS).
def _counting_motion_fit():
    """Wrap energies.motion_fit (the stage-3 objective's energy) to count
    its evaluations; returns (counter, restore)."""
    from humor_torch.fitting import energies as E

    real, calls = E.motion_fit, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    E.motion_fit = counted
    return calls, lambda: setattr(E, "motion_fit", real)


def _accuracy_fit(name, fn, case, models, bounds, device, reported=()):
    """One accuracy fit from zero launches: its metrics against `bounds`
    (those named in `reported` printed, not held), both rollout kernels
    launched, no nearest neighbour; the zoom search's probes an
    iteration of stage 3 (evaluations less each phase's start point,
    over the iterations)."""
    from humor_torch import testing as TST
    from humor_torch.fitting import optimizer as O

    cfg = case(models)[0]
    phases = [p for p in O.stage3_phases(cfg) if p[3] > 0]
    calls, restore = _counting_motion_fit()
    reset_launches()
    try:
        metrics, timings = fn(models, device)
    finally:
        restore()
    launches = read_launches()
    probes = (calls[0] - len(phases)) / sum(p[3] for p in phases)
    missed = TST.misses(metrics, bounds)
    failed = TST.misses(metrics, {k: b for k, b in bounds.items()
                                  if k not in reported})
    print(f"[accuracy {name}] " + json.dumps({
        "metrics": metrics, "bounds": bounds, "missed": missed,
        "reported_not_held": list(reported),
        "stage_seconds": timings, "stage3_evaluations": calls[0],
        "stage3_zoom_probes_per_iteration": probes,
        "launches": launches}))
    for k in ("rollout_fwd", "rollout_bwd"):
        if launches[k] <= 0:
            fail(f"the {name} accuracy fit never launched {k}")
    if launches["nn_distance"]:
        fail(f"the {name} accuracy fit launched the nearest neighbour")
    if failed:
        fail(f"the {name} accuracy fit missed the JAX test's bounds: "
             f"{failed}")
    return launches


def run_accuracy(device="cuda"):
    """Phase 10: train the fixture on the card (300 supervised and 150
    scheduled-sampling steps at 48 x 10, 800 VPoser steps), print the
    VPoser round trip on GT poses, then the joints3d and RGB accuracy
    fits. Returns each fit's launches."""
    import torch

    from humor_torch import testing as TST
    from humor_torch.body_model.smpl import synthetic_smpl_model
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS

    body = synthetic_smpl_model(device=device)
    cfg = H.HumorConfig()
    t0 = time.perf_counter()
    humor = TST.train_mini_humor(body, cfg, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vcfg, vparams = TST.train_mini_vposer(body, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mae = TST.vposer_roundtrip_mae(vcfg, vparams,
                                   TST.vposer_training_poses(body.to("cpu")))
    finite = all(bool(torch.isfinite(p).all()) for tree in (humor, vparams)
                 for p in TS.tree_leaves(tree))
    print("[fixture] " + json.dumps({
        "humor_train_seconds": t1 - t0, "vposer_train_seconds": t2 - t1,
        "vposer_roundtrip_mae_rad": mae, "finite": finite}))
    if not finite or not math.isfinite(mae):
        fail("the trained fixture has non-finite weights or round trip")
    models = O.TTOModels(body=body, vposer_cfg=vcfg, vposer=vparams,
                         humor_cfg=cfg, humor=humor, init_gmm=None)
    return {
        "accuracy_joints3d": _accuracy_fit(
            "joints3d", TST.joints3d_accuracy, TST.joints3d_case, models,
            TST.JOINTS3D_BOUNDS, device),
        "accuracy_rgb": _accuracy_fit(
            "rgb", TST.rgb_accuracy, TST.rgb_case, models, TST.RGB_BOUNDS,
            device, reported=TST.RGB_DEPTH_BOUNDS),
    }


# phase 11: the HuMoR configurations other than the default. Train steps
# card against CPU at phase 8's size and tolerances, the train CLI at
# --model-steps-in 2, and a short fit of an unconditional-prior,
# absolute-output model card against CPU. The rollout kernels' layout is
# the default configuration's (as JAX's Pallas kernel's), so these paths
# launch none of the three kernels by design.
CONFIG_TRAIN = {"steps_in2": dict(steps_in=2),
                "in6d_out9d": dict(in_rot_rep="6d", out_rot_rep="9d")}
CONFIG_FIT = dict(conditional_prior=False, output_delta=False)
CONFIG_FIT_ITERS = (3, 3, 3)
CONFIG_FIT_RTOL = 1e-4          # loss histories, card against CPU
# final pose (rad), card against CPU: ~3x the gap measured on an NVIDIA
# H100 80GB HBM3 (4.06e-5); the same fit with the deltas switched on
# (CONFIG_FIT_CONTROL) must part from the CPU's by more, or the limit
# would not tell a wrong configuration from the right one
CONFIG_FIT_ATOL = 1.2e-4
CONFIG_FIT_CONTROL = dict(conditional_prior=False, output_delta=True)


def compare_config_steps(device="cuda", batch=TRAIN_CMP_B):
    """Phase 11a: supervised and scheduled-sampling losses and gradients
    of each CONFIG_TRAIN model on the card against the CPU (phase 8's
    batch of windows, weights, draws and tolerances)."""
    import torch

    from humor_torch.data.synthetic import synthetic_world_batch
    from humor_torch.data.windows import window_to_pairs_multi
    from humor_torch.models import humor as H

    bodies = train_bodies()
    rec = {}
    for name, kw in CONFIG_TRAIN.items():
        cfg = H.HumorConfig(**kw)
        S = cfg.steps_in
        params = H.init_params(cfg, torch.Generator().manual_seed(3))
        if S == 1:
            data = train_batch(bodies, batch, seed=0, device="cpu")
        else:
            world, meta = synthetic_world_batch(0, batch, TRAIN_T + S,
                                                model=bodies["male"])
            din, dout = window_to_pairs_multi(world, S)
            data = {"data_in": din, "data_out": dout, "betas": meta["betas"],
                    "gender_ids": meta["gender_ids"].long() % 2}
        g = torch.Generator().manual_seed(4)
        eps = {False: torch.randn(batch * TRAIN_T, 48, generator=g),
               True: torch.randn(TRAIN_T, batch, 48, generator=g)}
        for sched in (False, True):
            card = train_grads(params, bodies, data, device, sched,
                               eps[sched], cfg)
            cpu = train_grads(params, bodies, data, "cpu", sched, eps[sched],
                              cfg)
            scaled = max(float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30)) for a, b in zip(card[2], cpu[2]))
            rec[f"{name}_{'sched_samp' if sched else 'supervised'}"] = {
                "loss_card": card[0], "loss_cpu": cpu[0],
                "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
                "grad_norm_rel": abs(card[1] - cpu[1]) / abs(cpu[1]),
                "grad_max_scaled": scaled}
    print("[configs train card vs cpu] " + json.dumps(rec))
    for name, r in rec.items():
        if not (r["loss_rel"] <= TRAIN_LOSS_RTOL
                and r["grad_norm_rel"] <= TRAIN_LOSS_RTOL
                and r["grad_max_scaled"] <= TRAIN_GRAD_TOL):
            fail(f"{name} step on the card parts from the CPU: {r}")
    return rec


def run_steps_in_cli(device="cuda", batch=16, steps=4):
    """Phase 11b: the train CLI for one epoch at --model-steps-in 2 on
    the synthetic sequences (windows of sample_num_frames + 2 frames)."""
    import tempfile

    import numpy as np

    from humor_torch.train import cli as TC

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        smplh = os.path.join(tmp, "smplh")
        for gender, body in train_bodies().items():
            write_body_npz(smplh, body, gender)
        out = os.path.join(tmp, "train")
        reset_launches()
        t0 = time.perf_counter()
        TC.main(["@" + os.path.join(root, "configs", "train_humor.cfg"),
                 "--device", device, "--model-steps-in", "2",
                 "--batch-size", str(batch), "--epochs", "1",
                 "--steps-per-epoch", str(steps), "--val-every", "1",
                 "--out", out, "--data-path", os.path.join(tmp, "no_amass"),
                 "--smplh-root", smplh])
        launches = read_launches()
        with open(os.path.join(out, "stats.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        ok = (len(rows) == steps and os.path.exists(
            os.path.join(out, "final_model.npz")) and np.isfinite(
                [v for r in rows for v in r.values()]).all())
        print("[configs train cli steps_in=2] " + json.dumps({
            "seconds": time.perf_counter() - t0, "steps": len(rows),
            "losses": [r["total_loss"] for r in rows],
            "launches": launches}))
        if not ok:
            fail("the train CLI at --model-steps-in 2 logged the wrong "
                 "number of steps, non-finite stats or no checkpoint")
    return launches


def run_config_fit(models, device="cuda", iters=CONFIG_FIT_ITERS):
    """Phase 11c: the joints3d fit (phase 3's observation and weights) of
    an unconditional-prior, absolute-output model (seeded, its decoder
    head damped x0.1) on the card, on the CPU, on the card with the
    observation nudged 1e-6 m and on the card as CONFIG_FIT_CONTROL
    (the same weights read as deltas): every loss history card against
    CPU within CONFIG_FIT_RTOL, the final pose within CONFIG_FIT_ATOL of
    the CPU's and the control's farther than that (the nudged run's gap
    printed beside them: the damped chain is well-conditioned), and no
    kernel launched (the typed rollout, by design)."""
    import torch

    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import humor as H

    cfg = H.HumorConfig(**CONFIG_FIT)
    m = models._replace(humor_cfg=cfg, humor=damped(H.init_params(
        cfg, torch.Generator().manual_seed(5)), 0.1))
    control = m._replace(humor_cfg=H.HumorConfig(**CONFIG_FIT_CONTROL))
    w1 = E.StageWeights(joints3d=1.0)
    w2 = E.StageWeights(joints3d=1.0, pose_prior=2e-4, shape_prior=1.67e-4,
                        joints3d_smooth=10.0)
    w3 = E.StageWeights(joints3d=1.0, shape_prior=1.67e-4, motion_prior=1e-3,
                        joint_consistency=1.0, bone_length=10.0,
                        contact_vel=1.0, contact_height=1.0)
    tcfg = O.TTOConfig(seq_len=T, stage_weights=(w1, w2, w3),
                       num_iters=iters, stage3_freeze_start=1,
                       stage3_freeze_end=2)
    obs = make_observations(models, seed=0)
    runs = {}
    launches = None
    for name, mm, dev, nudge in (("card", m, device, 0.0),
                                 ("cpu", m, "cpu", 0.0),
                                 ("nudged", m, device, 1e-6),
                                 ("control", control, device, 0.0)):
        reset_launches()
        t0 = time.perf_counter()
        res = O.make_runner(tcfg, mm, device=dev)(
            {"joints3d": obs["joints3d"] + nudge})
        runs[name] = (res, time.perf_counter() - t0)
        if name == "card":
            launches = read_launches()
    card, cpu, nudged, ctrl = (runs[k][0] for k in ("card", "cpu", "nudged",
                                                     "control"))
    hist = max(float(((card.losses[k].cpu() - cpu.losses[k]).abs()
                      / cpu.losses[k].abs()).max()) for k in card.losses)
    gap = lambda a, b: float((a.final["pose_body"].cpu()
                              - b.final["pose_body"].cpu()).abs().max())
    finite = all(bool(torch.isfinite(v).all()) for v in (
        *card.losses.values(), card.final["trans"], card.final["pose_body"]))
    rec = {"config": CONFIG_FIT, "iters": list(iters),
           "seconds": {k: v[1] for k, v in runs.items()},
           "history_rel": hist, "pose_gap_cpu": gap(card, cpu),
           "pose_gap_nudged": gap(card, nudged),
           "pose_gap_control": gap(ctrl, cpu),
           "contacts": "contacts" in card.final, "finite": finite,
           "launches": launches}
    print("[configs fit card vs cpu] " + json.dumps(rec))
    if not finite:
        fail("the non-default fit on the card gave non-finite values")
    if hist > CONFIG_FIT_RTOL:
        fail(f"the non-default fit's histories part card from CPU: {hist}")
    if rec["pose_gap_cpu"] > CONFIG_FIT_ATOL:
        fail(f"the non-default fit's final pose parts card from CPU: {rec}")
    if not rec["pose_gap_control"] > CONFIG_FIT_ATOL:
        fail(f"a wrong configuration's fit passes CONFIG_FIT_ATOL: {rec}")
    if any(launches.values()):
        fail(f"the non-default fit launched a kernel: {launches}")
    return launches


def run_configs(models, device="cuda"):
    """Phase 11; returns the launches of its CLI and fit (none)."""
    t0 = time.perf_counter()
    compare_config_steps(device)
    launches = {"configs_train_cli": run_steps_in_cli(device),
                "configs_fit": run_config_fit(models, device)}
    if any(launches["configs_train_cli"].values()):
        fail("the train CLI at --model-steps-in 2 launched a kernel")
    print("[phase 11] " + json.dumps({"seconds": time.perf_counter() - t0}))
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the k-step train dispatch and the multi-device layer
# ---------------------------------------------------------------------------

# k-step chunks against single steps, at phase 8's size
PAR_K = 4
# params, moments and stats, chunk vs singles: equal (0 measured on an
# NVIDIA H100 80GB HBM3 at 700 W; the same kernels in the same order)
PAR_GAP_LIMIT = 0.0
K_TIMED = (1, 4, 8)            # the supervised step at 200 x 10, k a chunk
K_TIMED_STEPS = 16             # steps timed at each k, twice, in turns
# the windows-sharded fit: the JAX sharded test's configuration at full
# width, 4 windows of 60 frames sharing 10 (1 and 2 ranks)
SHARD_B, SHARD_T, SHARD_OVERLAP = 4, 60, 10
SHARD_ITERS = (10, 10, 10)
SHARD_NUDGES_M = (1e-6, -1e-6)  # the plain fit's joints moved by these
# history values held against the plain fit's. The fit is chaotic on
# random weights: on the CPU a 1e-6 m nudge parts stage 2's third value by
# 1e-4 and stage 3's first by 0.3%, and the sharded run's stage 3 starts
# 1.1% off, so stage 3 and the final pose are held against the nudges'
# gaps instead (SHARD_NUDGE_RATIO)
SHARD_HIST_FIRST = {"stage1": 3, "stage2": 2}
# measured 0 at world 1 (NCCL) and 1.5e-6 at world 2 (gloo) on an NVIDIA
# H100 80GB HBM3 at 700 W, 1.2e-6 on the CPU
SHARD_HIST_RTOL = 1e-5
SHARD_NUDGE_RATIO = RGB_STAGE3_NUDGE_RATIO
DP_STEPS = ("sup", "sup", "ss")  # the data-parallel steps compared
DP_CLI_TIMEOUT = 420


def _dist_env():
    """Every rank of this phase runs on one host: the collectives go over
    the loopback interface."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def compare_multi_steps(device="cuda", batch=TRAIN_CMP_B, k=PAR_K):
    """Phase 12a: multi_sup and multi_ss over a chunk of k batches on the
    card against k single steps with the same generator: params, moments
    and every stat."""
    import torch

    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS

    bodies = {n: v.to(device) for n, v in train_bodies().items()}
    cfg, opt = H.HumorConfig(), TS.make_optimizer()
    params = H.init_params(cfg, torch.Generator().manual_seed(3), device)
    sup, ss, _ = TS.make_train_steps(cfg, LossConfig(), opt, bodies)
    multi_sup, multi_ss = TS.make_multi_steps(sup, ss, k)
    batches = [train_batch(bodies, batch, seed=10 + i, device=device)
               for i in range(k)]
    stacked = TS.stack_batches(batches)
    rec = {}
    for name, single, multi, extra in (("supervised", sup, multi_sup, ()),
                                       ("sched_samp", ss, multi_ss, (0.5,))):
        g1 = torch.Generator(device=device).manual_seed(7)
        g2 = torch.Generator(device=device).manual_seed(7)
        st = TS.make_train_state(params, opt)
        singles = []
        for b in batches:
            st, stats = single(st, b, 10, *extra, generator=g1)
            singles.append(stats)
        st_k, stats_k = multi(TS.make_train_state(params, opt), stacked, 10,
                              *extra, generator=g2)
        gap = max(float((a - b).detach().abs().max()) for a, b in zip(
            TS.tree_leaves(st_k.params), TS.tree_leaves(st.params)))
        moments = max(float((a - b).abs().max()) for m in ("mu", "nu")
                      for a, b in zip(TS.tree_leaves(st_k.opt_state[m]),
                                      TS.tree_leaves(st.opt_state[m])))
        stats_gap = max(float((stats_k[n] - torch.stack(
            [s[n] for s in singles])).abs().max()) for n in stats_k)
        rec[name] = {"params_gap": gap, "moments_gap": moments,
                     "stats_gap": stats_gap,
                     "losses": stats_k["total_loss"].tolist()}
    print("[k-step vs singles] " + json.dumps({"k": k, "batch": batch,
                                                **rec}))
    for name, r in rec.items():
        if not (r["params_gap"] <= PAR_GAP_LIMIT
                and r["moments_gap"] <= PAR_GAP_LIMIT
                and r["stats_gap"] <= PAR_GAP_LIMIT
                and all(map(math.isfinite, r["losses"]))):
            fail(f"{name}: a chunk of {k} steps parts from {k} single "
                 f"steps: {r}")
    return rec


def time_k_steps(device="cuda", batch=TRAIN_B, ks=K_TIMED,
                 steps=K_TIMED_STEPS):
    """Phase 12b: ms a supervised step at the config's 200 x 10 when the
    steps run in chunks of k (make_multi_steps, the stats read once a
    chunk as the trainer reads them), and the host synchronisations a
    step (torch.cuda's sync debug mode counts them over one chunk), at
    each k twice, in turns."""
    import warnings

    import torch

    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS
    from humor_torch.utils.stats import to_host

    bodies = {n: v.to(device) for n, v in train_bodies().items()}
    cfg, opt = H.HumorConfig(), TS.make_optimizer()
    sup, ss, _ = TS.make_train_steps(cfg, LossConfig(), opt, bodies)
    batches = [train_batch(bodies, batch, seed=20 + i, device=device)
               for i in range(max(ks))]
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                device)
    gen = torch.Generator(device=device).manual_seed(1)
    runners = {}
    for k in ks:
        if k == 1:
            runners[k] = (lambda st, i: sup(st, batches[i % len(batches)],
                                            10, generator=gen))
        else:
            chunks = [TS.stack_batches(batches[j:j + k])
                      for j in range(0, len(batches), k)]
            multi = TS.make_multi_steps(sup, ss, k)[0]
            runners[k] = (lambda st, i, m=multi, c=chunks:
                          m(st, c[i % len(c)], 10, generator=gen))

    def chunk(st, k, i):
        st, stats = runners[k](st, i)
        return st, to_host(stats)

    root = os.path.dirname(os.path.abspath(__file__))
    rec = {k: {"ms_per_step": [], "syncs_per_step": None} for k in ks}
    sites = {}
    for k in ks:                  # warm-up, and the syncs of one chunk
        state, _ = chunk(state, k, 0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, _ = chunk(state, k, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        rec[k]["syncs_per_step"] = len(syncs) / k
        if k == 1:                # where a single step synchronises
            for w in syncs:
                site = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
                sites[site] = sites.get(site, 0) + 1
    losses = []
    for k in (*ks, *reversed(ks)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps // k):
            state, host = chunk(state, k, i)
            losses.append(host["total_loss"])
        torch.cuda.synchronize()
        rec[k]["ms_per_step"].append(1e3 * (time.perf_counter() - t0)
                                     / steps)
    print("[k-step timing B=%d] " % batch + json.dumps(
        {str(k): r for k, r in rec.items()}))
    print("[k-step sync sites, k=1] " + json.dumps(dict(sorted(
        sites.items(), key=lambda kv: -kv[1]))))
    if not all(map(math.isfinite, losses)):
        fail(f"the timed k-step chunks gave non-finite losses: {losses}")
    return rec


def _dp_steps(mesh, device, batch=TRAIN_CMP_B):
    """The data-parallel steps of DP_STEPS on this rank's rows (every row
    when `mesh` is None) of seeded global batches with injected global
    draws: (losses, the first step's gradient averaged over ranks, the
    params after the steps)."""
    import torch

    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.parallel import mesh as P
    from humor_torch.train import step as TS

    bodies = {n: v.to(device) for n, v in train_bodies().items()}
    cfg, opt = H.HumorConfig(), TS.make_optimizer()
    params = H.init_params(cfg, torch.Generator().manual_seed(3), device)
    sup, ss, _ = TS.make_train_steps(cfg, LossConfig(), opt, bodies,
                                     mesh=mesh)
    state = TS.make_train_state(params, opt)
    g = torch.Generator().manual_seed(5)
    local = (lambda b: b) if mesh is None else (
        lambda b: P.shard_batch(mesh, b))
    rows = (lambda n: slice(None)) if mesh is None else (
        lambda n: P.local_rows(mesh, n))
    losses, grads = [], None
    for i, kind in enumerate(DP_STEPS):
        b = train_batch(bodies, batch, seed=30 + i, device=device)
        if kind == "sup":
            eps = torch.randn(batch * TRAIN_T, 48, generator=g).to(device)
            if grads is None:
                loss, _ = TS.supervised_loss_fn(cfg, LossConfig(), bodies)(
                    state.params, local(b), 10, eps=eps[rows(eps.shape[0])])
                grads = list(torch.autograd.grad(
                    loss, TS.tree_leaves(state.params)))
                if mesh is not None:
                    grads = P.all_reduce_grad_mean(mesh, grads)
            state, stats = sup(state, local(b), 10, eps=eps)
        else:
            eps = torch.randn(TRAIN_T, batch, 48, generator=g).to(device)
            state, stats = ss(state, local(b), 10, 0.5, use_gt=SS_USE_GT,
                              eps=eps)
        losses.append(float(stats["total_loss"]))
    return {"losses": losses, "grads": [x.detach().cpu() for x in grads],
            "params": [p.detach().cpu()
                       for p in TS.tree_leaves(state.params)]}


def _dp_steps_rank(mesh):
    return _dp_steps(mesh, mesh.device)


def compare_dp_steps(device="cuda"):
    """Phase 12c: the data-parallel steps at world 2, two processes on
    this one card over gloo, against world 1 in this process: losses and
    the first step's gradient at phase 8's tolerances, the params within
    2 lr a step of world 1's and equal, bit for bit, across the ranks."""
    from humor_torch.parallel import launch

    ref = _dp_steps(None, device)
    ranks = launch.spawn(_dp_steps_rank, 2, backend="gloo",
                         device=f"{device}:0", timeout=600, threads=None)
    same = all(bool((a == b).all()) for r in ranks[1:]
               for a, b in zip(r["params"], ranks[0]["params"]))
    loss_rel = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref["losses"]))
    grad = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for r in ranks for a, b in zip(r["grads"], ref["grads"]))
    params = max(float((a - b).abs().max())
                 for a, b in zip(ranks[0]["params"], ref["params"]))
    rec = {"world": 2, "backend": "gloo", "batch": TRAIN_CMP_B,
           "steps": list(DP_STEPS), "losses_w1": ref["losses"],
           "losses_w2": ranks[0]["losses"], "loss_rel": loss_rel,
           "grad_max_scaled": grad, "params_abs": params,
           "params_equal_across_ranks": same}
    print("[dp world 2 vs 1] " + json.dumps(rec))
    if not (same and loss_rel <= TRAIN_LOSS_RTOL and grad <= TRAIN_GRAD_TOL
            and params <= 2 * len(DP_STEPS) * 1e-4 + 1e-7):
        fail(f"data-parallel steps at world 2 part from world 1: {rec}")
    return rec


def compare_dp_trainer(mesh, device="cuda"):
    """Phase 12d: the trainer at world 1 over NCCL (the store's chunk
    source at k = 2, 4 supervised steps at phase 8's batch) against the
    plain trainer with the same seed: the params equal."""
    import tempfile
    from types import SimpleNamespace

    import torch

    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train import cli as TC
    from humor_torch.train import step as TS
    from humor_torch.train.trainer import Trainer, TrainRunConfig

    bodies = {n: v.to(device) for n, v in train_bodies().items()}
    cfg = SimpleNamespace(batch_size=TRAIN_CMP_B, data_noise_std=0.0,
                          model_steps_in=1, data_on_device=1,
                          data_path="no_amass")
    ds = TC.build_dataset(cfg, (), device=device)
    params = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in (("plain", None), ("nccl_world1", mesh)):
            batches, chunks = TC.make_batch_fns(ds, cfg, TRAIN_T + 1, 4, 0,
                                                device, mesh=m)
            rc = TrainRunConfig(out_dir=os.path.join(tmp, name), epochs=1,
                                steps_per_dispatch=2, use_mesh=m is not None,
                                print_every=10)
            tr = Trainer(H.HumorConfig(), LossConfig(), rc,
                         train_batches=batches, train_chunks=chunks,
                         steps_per_epoch=4, smpl_models=bodies, seed=0,
                         device=device)
            tr.fit()
            params[name] = [p.detach() for p in
                            TS.tree_leaves(tr.state.params)]
    gap = max(float((a - b).abs().max()) for a, b in zip(
        params["plain"], params["nccl_world1"]))
    print("[dp trainer nccl world 1] " + json.dumps({"params_gap": gap}))
    if gap != 0.0:
        fail(f"the trainer at world 1 over NCCL parts from the plain "
             f"trainer by {gap}")
    return gap


def run_dp_train_cli(device="cuda", batch=TRAIN_CMP_B, steps=8, k=PAR_K):
    """Phase 12e: `torchrun --nproc-per-node 2 -m humor_torch.train.cli
    --dist-backend gloo` on this one card, one epoch of `steps` at k on
    the synthetic sequences with the 6890-vertex bodies: the run ends,
    rank 0 alone writes the log, one stats row a chunk and the
    checkpoints."""
    import tempfile

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        smplh = os.path.join(tmp, "smplh")
        for gender, body in train_bodies().items():
            write_body_npz(smplh, body, gender)
        out = os.path.join(tmp, "out")
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "humor_torch.train.cli",
             "@" + os.path.join(root, "configs", "train_humor.cfg"),
             "--device", device, "--dist-backend", "gloo",
             "--batch-size", str(batch), "--epochs", "1",
             "--steps-per-epoch", str(steps), "--steps-per-dispatch", str(k),
             "--val-every", "1", "--print-every", "1", "--out", out,
             "--data-path", os.path.join(tmp, "no_amass"),
             "--smplh-root", smplh],
            cwd=tmp, env=env, capture_output=True, text=True,
            timeout=DP_CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the train CLI under torchrun failed "
                 f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(os.path.join(out, "stats.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "train.log")) as f:
            log = f.read()
        ckpts = {n: os.path.exists(os.path.join(out, n)) for n in (
            "best_train_model.npz", "best_model.npz", "final_model.npz")}
    rec = {"seconds": wall, "world": 2, "batch": batch, "k": k,
           "stat_rows": [r["step"] for r in rows],
           "log_opened": log.count("log opened"),
           "data_parallel": "data-parallel over 2 ranks" in log,
           "checkpoints": ckpts}
    print("[dp train cli] " + json.dumps(rec))
    if not (rec["stat_rows"] == list(range(k, steps + 1, k))
            and rec["log_opened"] == 1 and rec["data_parallel"]
            and all(ckpts.values())
            and np.isfinite([v for r in rows for v in r.values()]).all()):
        fail(f"the train CLI under torchrun at world 2: {rec}")
    return rec


def shard_config():
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O

    # tests/test_tto_sharded.py's: the overlap consistency in stages 1-2,
    # zoom (its step moves continuously under reordered sums), no
    # stage-3 init tuning
    w1 = E.StageWeights(joints3d=1.0, rgb_overlap_consist=1.0)
    w2 = E.StageWeights(joints3d=1.0, pose_prior=4e-4,
                        rgb_overlap_consist=1.0)
    w3 = E.StageWeights(joints3d=1.0, motion_prior=1e-4,
                        joint_consistency=1.0)
    return O.TTOConfig(seq_len=SHARD_T, stage_weights=(w1, w2, w3),
                       num_iters=SHARD_ITERS, stage3_tune_init_state=False,
                       lbfgs_linesearch="zoom")


def shard_observations(models, seed=0):
    """The joints of one seeded sequence of (B-1)(T-overlap)+T frames, cut
    into SHARD_B windows of SHARD_T sharing SHARD_OVERLAP, with their
    seq_interval."""
    import numpy as np
    import torch

    from humor_torch.fitting import optimizer as O
    from humor_torch.models import vposer as vp

    step = SHARD_T - SHARD_OVERLAP
    n = (SHARD_B - 1) * step + SHARD_T
    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    z = f(rng.randn(1, n, models.vposer_cfg.latent_dim) * 0.3)
    with torch.no_grad():
        pose = vp.latent2pose(models.vposer_cfg, models.vposer, z)
        trans = f(np.cumsum(rng.randn(1, n, 3) * 0.01, axis=1))
        ro = f(np.tile(rng.randn(1, 1, 3) * 0.2, (1, n, 1)))
        joints = O.smpl_results(models.body, trans, ro, pose,
                                torch.zeros(1, 16))["joints3d"][0]
    starts = [i * step for i in range(SHARD_B)]
    return {"joints3d": torch.stack([joints[s:s + SHARD_T] for s in starts]),
            "seq_interval": torch.tensor([[s, s + SHARD_T] for s in starts],
                                         dtype=torch.int32)}


def _shard_fit(mesh, obs, device):
    """The sharded (or, with mesh None, plain) fit on the damped models:
    (final, losses, seconds, launches)."""
    import torch

    from humor_torch.fitting import optimizer as O

    models = make_models()
    dm = models._replace(humor=damped(models.humor, 0.1))
    runner = O.make_runner(shard_config(), dm, device=device, mesh=mesh)
    reset_launches()
    t0 = time.perf_counter()
    res = runner(obs)
    torch.cuda.synchronize()
    return {"final": {k: v.detach().cpu() for k, v in res.final.items()},
            "losses": {k: v.detach().cpu() for k, v in res.losses.items()},
            "seconds": time.perf_counter() - t0,
            "launches": read_launches()}


def _shard_fit_rank(mesh, obs):
    return _shard_fit(mesh, obs, mesh.device)


def check_sharded_fit(runs, plain, nudged):
    """Each sharded run against the plain one: the first history values
    of stages 1-2 (SHARD_HIST_FIRST) within SHARD_HIST_RTOL, the final
    translation and pose within SHARD_NUDGE_RATIO of the farther of the
    plain run's gaps to its nudged runs, every rank's result equal, both
    rollout kernels launched by every rank."""
    def gap(a, b, key):
        return float((a["final"][key] - b["final"][key]).abs().max())

    nudge = {k: max(gap(n, plain, k) for n in nudged)
             for k in ("trans", "pose_body")}
    rec = {"nudge_gap": nudge, "plain_seconds": plain["seconds"]}
    bad = []
    for name, ranks in runs.items():
        hist = max(float(((r["losses"][st][:n] - plain["losses"][st][:n])
                          .abs() / plain["losses"][st][:n].abs()).max())
                   for r in ranks for st, n in SHARD_HIST_FIRST.items())
        finals = {k: gap(ranks[0], plain, k) for k in nudge}
        same = all(torch_equal(r["final"], ranks[0]["final"])
                   for r in ranks[1:])
        launched = [{k: r["launches"][k] for k in ("rollout_fwd",
                                                   "rollout_bwd")}
                    for r in ranks]
        rec[name] = {"seconds": [r["seconds"] for r in ranks],
                     "hist_rel_first": hist, "final_gap": finals,
                     "ranks_equal": same, "launches": launched}
        if not (hist <= SHARD_HIST_RTOL and same and all(
                finals[k] <= SHARD_NUDGE_RATIO * nudge[k]
                for k in nudge) and all(
                n > 0 for lr in launched for n in lr.values())):
            bad.append(name)
    print("[sharded fit] " + json.dumps(rec))
    if bad:
        fail(f"the sharded fit at {bad} parts from the plain fit or missed "
             f"a kernel on a rank: {rec}")
    return rec


def torch_equal(a, b):
    import torch

    return all(torch.equal(a[k], b[k]) for k in a)


def run_parallel(models, device="cuda"):
    """Phase 12; returns the launches of the sharded fits."""
    import tempfile

    import torch
    import torch.distributed as dist

    from humor_torch.parallel import launch
    from humor_torch.parallel import mesh as P

    _dist_env()
    t0 = time.perf_counter()
    compare_multi_steps(device)
    time_k_steps(device)
    obs = shard_observations(models)
    plain = _shard_fit(None, obs, device)
    nudged = [_shard_fit(None, dict(obs, joints3d=obs["joints3d"] + m),
                         device) for m in SHARD_NUDGES_M]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = P.make_mesh(device=torch.device(device, 0))
            compare_dp_trainer(mesh, device)
            world1 = _shard_fit(mesh, obs, device)
        finally:
            dist.destroy_process_group()
    compare_dp_steps(device)
    run_dp_train_cli(device)
    world2 = launch.spawn(_shard_fit_rank, 2, args=(obs,), backend="gloo",
                          device=f"{device}:0", timeout=900, threads=None)
    check_sharded_fit({"nccl_world1": [world1], "gloo_world2": world2},
                      plain, nudged)
    print("[phase 12] " + json.dumps({"seconds": time.perf_counter() - t0}))
    return {"sharded_fit_plain": plain["launches"],
            "sharded_fit_nudged": {k: sum(n["launches"][k] for n in nudged)
                                   for k in plain["launches"]},
            "sharded_fit_nccl_world1": world1["launches"],
            "sharded_fit_gloo_world2": {
                k: sum(r["launches"][k] for r in world2)
                for k in world2[0]["launches"]}}


# phase 13: the bf16 precision policy (HumorConfig.compute_dtype, the
# loss bodies' LossConfig.smpl_loss_dtype) and the PROX fit's determinism
BF16_MLP_ROWS = (16, 2000)      # the MLPs' rows: a fit's candidates, a batch
# card against the CPU, bf16: one product differs by f32 summation order
# (|err| <= 1e-4 of the |a| |b| sum, f32 rounding of a 1,024-term sum);
# through the stacked layers a value the two leave one f32 ulp apart
# rounds to a neighbouring bf16 value (as between the port and JAX on the
# CPU, tests/test_torch_bf16.py), and a few such values set the largest
# gap, so a head is held by the norm of its gap to the CPU: at most
# BF16_HEAD_RATIO of the norm of its bf16-vs-f32 gap
BF16_PRODUCT_RTOL = 1e-4
BF16_HEAD_RATIO = 0.5
BF16_TC_SPEEDUP = 0.5          # the bf16 product's time over the f32 one's
BF16_SMPL_ROWS, BF16_SMPL_CPU_ROWS = 2000, 200
# the bf16 vertices against f32 and the card against the CPU, in bf16
# steps (2^-8) of the largest |v|: the JAX package's 2e-2 m bound was set
# on 8 bodies of 256 vertices; over 2,000 x 6,890 the largest gap is ~1
# step (0.0195 m at |v| <= 4.4 m on an H100)
BF16_SMPL_ULPS = 4
# bf16 steps, card against the CPU: tests/test_torch_bf16.py's limits
# against JAX (the loss 3e-4 relative, the whole gradient 2e-2 of its
# norm; measured there 7.8e-5 and 1.2e-2)
BF16_LOSS_RTOL = 3e-4
BF16_GRAD_GAP = 2e-2
BF16_MODES = {"f32": (None, ""), "mlp_bf16": ("bfloat16", ""),
              "loss_bf16": (None, "bfloat16"),
              "both_bf16": ("bfloat16", "bfloat16")}
BF16_TIMED = 5                 # steps a turn at 200 x 10, two turns a mode
BF16_FIT_ITERS = NUM_ITERS
DET_ITERS = PROFILE_ITERS      # the PROX fits held bit for bit


def _bf16_check(problems, ok, msg):
    """Phase 13's checks: a failure is printed and added to `problems`,
    and the phase fails at its end, so one run reports every sub-phase."""
    if not ok:
        print(f"chip_smoke: phase 13 check failed: {msg}", flush=True)
        problems.append(msg)


def _product_kernels(a, b):
    """The device kernels one bf16 product enqueues (torch.profiler)."""
    import torch

    from humor_torch.ops import mlp as MLP

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        MLP._product_f32(a, b)
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def check_bf16_mlps(problems, device="cuda", rows=BF16_MLP_ROWS):
    """13a: the prior, posterior and decoder in bf16 at full width, card
    against the CPU's plain bf16 (the f32 product of the rounded inputs)
    at each row count; one product alone; the product's kernels, f32
    output and time against the f32 product's."""
    import torch

    from humor_torch.models import humor as H
    from humor_torch.ops import mlp as MLP

    params = H.init_params(H.HumorConfig(), torch.Generator().manual_seed(3))
    to = lambda tree, dev: {k: [{n: v.to(dev) for n, v in layer.items()}
                                for layer in mlp] for k, mlp in tree.items()}
    card, cpu = to(params, device), params
    bf = H.HumorConfig(compute_dtype="bfloat16")
    f32 = H.HumorConfig()
    d, L = bf.input_data_dim, bf.latent_size
    rec = {}
    for m in rows:
        g = torch.Generator().manual_seed(m)
        past = torch.randn(m, d, generator=g) * 0.5
        cur = torch.randn(m, d, generator=g) * 0.5
        z = torch.randn(m, L, generator=g)

        def heads(cfg, p, dev):
            x = lambda t: t.to(dev)
            pm, pv = H.prior(cfg, p, x(past))
            qm, qv = H.posterior(cfg, p, x(past), x(cur))
            dec = H.decode(cfg, p, x(z), x(past))
            return {"prior": torch.cat([pm, pv], -1).cpu(),
                    "posterior": torch.cat([qm, qv], -1).cpu(),
                    "decoder": torch.cat(list(dec.values()), -1).cpu()}

        with torch.no_grad():
            on_card = heads(bf, card, device)
            on_cpu = heads(bf, cpu, "cpu")
            on_card32 = heads(f32, card, device)
        for name in on_card:
            gap, gap32 = on_card[name] - on_cpu[name], (on_card[name]
                                                        - on_card32[name])
            r = {"card_vs_cpu_max": float(gap.abs().max()),
                 "bf16_vs_f32_max": float(gap32.abs().max()),
                 "norm_ratio": float(gap.norm() / gap32.norm())}
            rec[f"{name}_m{m}"] = r
            _bf16_check(problems, r["norm_ratio"] <= BF16_HEAD_RATIO,
                        f"bf16 {name} at {m} rows, card vs CPU: {r}")
    # one product: the first prior layer at the larger row count
    w = params["prior"][1]["w"]
    a = torch.randn(rows[-1], w.shape[0], generator=torch.Generator()
                    .manual_seed(5))
    ab, wb = a.bfloat16(), w.bfloat16()
    with torch.no_grad():
        out = MLP._product_f32(ab.to(device), wb.to(device))
        ref = MLP._product_f32(ab, wb)
    scale = (ab.float().abs() @ wb.float().abs()).clamp_min(1e-30)
    prod_err = float(((out.cpu() - ref).abs() / scale).max())
    below_bf16 = float((out - out.bfloat16().float()).abs().max())
    ab, wb = ab.to(device), wb.to(device)
    a32, w32 = a.to(device), w.to(device)
    kernels = _product_kernels(ab, wb)
    kernels32 = _product_kernels(a32, w32)
    ms_bf16 = cuda_ms(lambda: MLP._product_f32(ab, wb), 50)
    ms_f32 = cuda_ms(lambda: a32 @ w32, 50)
    rec["product"] = {"shape": [rows[-1], *w.shape], "dtype": str(out.dtype),
                      "err_over_abs_sum": prod_err,
                      "bits_below_bf16": below_bf16, "kernels": kernels,
                      "kernels_f32": kernels32, "ms_bf16": ms_bf16,
                      "ms_f32": ms_f32}
    print("[bf16 mlps] " + json.dumps(rec))
    _bf16_check(problems, out.dtype == torch.float32 and below_bf16 > 0.0,
                "the bf16 product's output is not f32 beyond bf16 precision")
    _bf16_check(problems, prod_err <= BF16_PRODUCT_RTOL,
                f"the bf16 product on the card parts from the CPU's: "
                f"{prod_err}")
    # tensor cores: under half the f32 product's time (TF32 is off, so
    # f32 runs without them); the kernels' names are printed (a second
    # profiler session in one process may record none)
    _bf16_check(problems, ms_bf16 <= BF16_TC_SPEEDUP * ms_f32,
                f"the bf16 product did not run as a tensor-core GEMM: "
                f"{rec['product']}")
    return rec


def check_bf16_smpl(problems, device="cuda", rows=BF16_SMPL_ROWS,
                    cpu_rows=BF16_SMPL_CPU_ROWS):
    """13b: lbs in bf16 at `rows` x 6890 on the card: the joints equal
    the f32 call's, the vertices and the first `cpu_rows` on the CPU
    within BF16_SMPL_ULPS bf16 steps of the f32 call's and the card's."""
    import torch

    from humor_torch.body_model import smpl as S

    body = train_bodies()["male"]
    g = torch.Generator().manual_seed(6)
    ro, pose = 0.3 * torch.randn(rows, 3, generator=g), 0.3 * torch.randn(
        rows, 63, generator=g)
    betas, trans = 0.5 * torch.randn(rows, 16, generator=g), torch.randn(
        rows, 3, generator=g)
    args = lambda dev, n: [t[:n].to(dev) for t in (ro, pose, betas, trans)]
    card_body = body.to(device)
    with torch.no_grad():
        v32 = S.forward(card_body, *args(device, rows))
        v16 = S.forward(card_body, *args(device, rows),
                        compute_dtype=torch.bfloat16)
        cpu16 = S.forward(body, *args("cpu", cpu_rows),
                          compute_dtype=torch.bfloat16)
    nj = 22
    joints_equal = bool(torch.equal(v16.Jtr[:, :nj], v32.Jtr[:, :nj]))
    vs32 = float((v16.v - v32.v).abs().max())
    card_cpu = float((v16.v[:cpu_rows].cpu() - cpu16.v).abs().max())
    ulp = 2.0 ** -8 * float(cpu16.v.abs().max())
    rec = {"rows": rows, "verts": int(v16.v.shape[1]),
           "joints_equal_f32": joints_equal, "verts_vs_f32": vs32,
           "card_vs_cpu": card_cpu, "bf16_step_m": ulp,
           "dtype": str(v16.v.dtype)}
    print("[bf16 smpl] " + json.dumps(rec))
    _bf16_check(problems, joints_equal and v16.v.dtype == torch.float32,
                "bf16 lbs: joints differ from the f32 call's or the vertices "
                "are not f32")
    _bf16_check(problems, 0.0 < vs32 <= BF16_SMPL_ULPS * ulp,
                f"bf16 lbs vertices {vs32} from f32 > {BF16_SMPL_ULPS} "
                f"steps")
    _bf16_check(problems, card_cpu <= BF16_SMPL_ULPS * ulp,
                f"bf16 lbs card vs CPU {card_cpu} > {BF16_SMPL_ULPS} steps")
    return rec


def _bf16_cfgs(mode):
    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H

    cd, ld = BF16_MODES[mode]
    return H.HumorConfig(compute_dtype=cd), LossConfig(smpl_loss_dtype=ld)


def compare_bf16_steps(problems, device="cuda", batch=TRAIN_CMP_B):
    """13c (1): each mode's supervised loss and gradient, and the
    scheduled-sampling one with both knobs, on the card against the CPU
    (phase 8's data and draws): f32 to phase 8's limits, bf16 to
    BF16_LOSS_RTOL and BF16_GRAD_GAP."""
    import torch

    from humor_torch.models import humor as H

    bodies = train_bodies()
    params = H.init_params(H.HumorConfig(), torch.Generator().manual_seed(3))
    data = train_batch(bodies, batch, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    eps = {False: torch.randn(batch * TRAIN_T, 48, generator=g),
           True: torch.randn(TRAIN_T, batch, 48, generator=g)}
    rec = {}
    cases = [(m, False) for m in BF16_MODES] + [("both_bf16", True)]
    for mode, sched in cases:
        cfg, loss_cfg = _bf16_cfgs(mode)
        card = train_grads(params, bodies, data, device, sched, eps[sched],
                           cfg, loss_cfg)
        cpu = train_grads(params, bodies, data, "cpu", sched, eps[sched],
                          cfg, loss_cfg)
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(card[2], cpu[2]))
        den = sum(float((b ** 2).sum()) for b in cpu[2])
        r = {"loss_card": card[0], "loss_cpu": cpu[0],
             "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
             "grad_gap": (num / den) ** 0.5,
             "grad_max_scaled": max(
                 float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(card[2], cpu[2]))}
        rec[("sched_samp_" if sched else "supervised_") + mode] = r
        if mode == "f32":
            ok = (r["loss_rel"] <= TRAIN_LOSS_RTOL
                  and r["grad_max_scaled"] <= TRAIN_GRAD_TOL)
        else:
            ok = (r["loss_rel"] <= BF16_LOSS_RTOL
                  and r["grad_gap"] <= BF16_GRAD_GAP)
        _bf16_check(problems, ok, f"{mode} step (sched {sched}) on the "
                                  f"card parts from the CPU: {r}")
    print("[bf16 train card vs cpu] " + json.dumps(rec))
    return rec


def time_bf16_steps(problems, device="cuda", batch=TRAIN_B,
                    reps=BF16_TIMED, turns=2):
    """13c (2): ms a supervised step at `batch` x 10 in each mode, the
    modes in turns (f32, mlp, loss, both; twice), each mode's peak device
    memory; then the scheduled-sampling step with both knobs."""
    import torch

    from humor_torch.train import step as TS

    bodies = {k: v.to(device) for k, v in train_bodies().items()}
    data = train_batch(bodies, batch, seed=1, device=device)
    opt = TS.make_optimizer()
    steps, states = {}, {}
    for mode in BF16_MODES:
        cfg, loss_cfg = _bf16_cfgs(mode)
        states[mode] = TS.init_train_state(
            cfg, opt, torch.Generator().manual_seed(0), device)
        steps[mode] = TS.make_train_steps(cfg, loss_cfg, opt, bodies)[:2]
    gen = torch.Generator(device=device).manual_seed(1)
    rec = {m: {"ms": [], "peak_gb": 0.0, "losses": []} for m in BF16_MODES}
    rec["sched_samp_both_bf16"] = {"ms": [], "peak_gb": 0.0, "losses": []}
    runs = [(m, m, 0) for m in BF16_MODES] + [
        ("sched_samp_both_bf16", "both_bf16", 1)]
    for _ in range(turns):
        for key, mode, which in runs:
            step = steps[mode][which]
            call = ((lambda s: step(s, data, 10, generator=gen)) if which == 0
                    else (lambda s: step(s, data, 10, 0.5, generator=gen)))
            states[mode], stats = call(states[mode])     # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                states[mode], stats = call(states[mode])
                rec[key]["losses"].append(float(stats["total_loss"]))
            torch.cuda.synchronize()
            rec[key]["ms"].append(1e3 * (time.perf_counter() - t0) / reps)
            rec[key]["peak_gb"] = max(rec[key]["peak_gb"],
                                      torch.cuda.max_memory_allocated() / 1e9)
    print("[bf16 train steps B=%d] " % batch + json.dumps(
        {k: {"ms": v["ms"], "peak_gb": v["peak_gb"]} for k, v in rec.items()}))
    _bf16_check(problems, all(all(map(math.isfinite, r["losses"]))
                    for r in rec.values()),
                "bf16 timed steps gave non-finite losses")
    return rec


def run_bf16_clis(models, device="cuda", batch=TRAIN_B, steps=4,
                  iters=BF16_FIT_ITERS, seq_len=T):
    """13d: the train CLI with --model-compute-dtype bfloat16 for one
    epoch of `steps` steps at `batch`, then the fit CLI's AMASS joints fit
    of B=2 processed sequences x `seq_len` at `iters` with the flag: the
    checks of phase 3, and no rollout-kernel launch (the typed rollout
    serves a bf16 model, as JAX's lax.scan serves its bf16 fit)."""
    import tempfile

    from humor_torch.train import cli as TC

    root = os.path.dirname(os.path.abspath(__file__))
    cfgs = os.path.join(root, "configs")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        smplh = os.path.join(tmp, "smplh")
        for gender, body in train_bodies().items():
            write_body_npz(smplh, body, gender)
        write_body_npz(smplh, models.body)
        reset_launches()
        t0 = time.perf_counter()
        res = TC.main(["@" + os.path.join(cfgs, "train_humor.cfg"),
                       "--device", device, "--batch-size", str(batch),
                       "--epochs", "1", "--steps-per-epoch", str(steps),
                       "--print-every", str(steps),
                       "--model-compute-dtype", "bfloat16",
                       "--out", os.path.join(tmp, "train"),
                       "--data-path", os.path.join(tmp, "no_amass"),
                       "--smplh-root", smplh])
        wall = time.perf_counter() - t0
        launches["bf16_train_cli"] = read_launches()
        print("[bf16 train cli] " + json.dumps({
            "seconds": wall, "ms_a_step": 1e3 * wall / steps,
            "min_train_loss": res["min_train_loss"],
            "launches": launches["bf16_train_cli"]}))
        if not math.isfinite(res["min_train_loss"]):
            fail("the bf16 train CLI gave a non-finite loss")
        data = write_processed_tree(os.path.join(tmp, "amass"), models.body,
                                    device)
        shapes = {k: (B, seq_len) + v[2:] if k != "betas" else v
                  for k, v in FINAL_SHAPES.items()}
        shapes["latent_motion"] = (B, seq_len - 1, 48)
        launches["bf16_fit_cli"], _ = run_amass_fit(
            "bf16 fit cli",
            ["@" + os.path.join(cfgs, "fit_amass_joints.cfg"),
             "--data-path", data, "--smplh-root", smplh,
             "--seq-len", str(seq_len), "--batch-size", str(B),
             "--num-iters-scale", "1", "--num-iters", *map(str, iters),
             "--humor-ckpt", "", "--vposer-ckpt", "",
             "--init-motion-prior-ckpt", "",
             "--model-compute-dtype", "bfloat16",
             "--out", os.path.join(tmp, "fit")], iters, device, shapes)
    for path, n in launches.items():
        if any(n.values()):
            fail(f"the {path} path launched a kernel: {n}")
    return launches


def check_prox_determinism(problems, models, iters=DET_ITERS):
    """13e: the PROX fit twice in one call, bit for bit; the path's ops
    that PyTorch's deterministic mode names as non-deterministic (one
    more fit with warn_only=True, its warnings listed); the
    nearest-neighbour backward's scatter (index_put_ with accumulate)
    timed beside the atomic index_add_ it replaced at (960, 4096, 6890),
    and repeated bit for bit."""
    import warnings

    import torch

    from humor_torch.fitting import optimizer as O
    from humor_torch.ops import chamfer as CH

    models = prox_models(models)
    obs = make_prox_observations(models, seed=0)
    runner = O.make_runner(prox_config(iters), models, device="cuda")
    runs = []
    for _ in range(2):
        reset_launches()
        res = runner(obs)
        torch.cuda.synchronize()
        runs.append((res, read_launches()))
    (a, la), (b, lb) = runs
    differ = sorted(k for k in a.final
                    if not torch.equal(a.final[k], b.final[k]))
    differ += sorted(f"losses.{k}" for k in a.losses
                     if not torch.equal(a.losses[k], b.losses[k]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runner(obs)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    sites = sorted({str(w.message).split("\n")[0][:200] for w in caught
                    if "deterministic" in str(w.message)})
    # the control: the same two fits with the atomic index_add_ that the
    # backward's scatter replaced (printed, not held)
    real = CH.scatter_rows
    CH.scatter_rows = lambda index, rows, n: torch.zeros(
        n, rows.shape[-1], dtype=rows.dtype, device=rows.device).index_add_(
        0, index, rows)
    try:
        c1, c2 = runner(obs), runner(obs)
        torch.cuda.synchronize()
    finally:
        CH.scatter_rows = real
    control = sorted(k for k in c1.final
                     if not torch.equal(c1.final[k], c2.final[k]))
    # the backward's scatter at the fit's nearest-neighbour shape
    x, y, _ = nn_inputs(960, N_POINTS, V_VERTS, seed=3)
    _, idx = CH.nn_distance(x, y)
    Bn, N = idx.shape
    flat = (idx.long() + V_VERTS * torch.arange(Bn, device=idx.device)[
        :, None]).reshape(-1)
    rows = torch.randn(Bn * N, 3, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(7))
    new = lambda: CH.scatter_rows(flat, rows, Bn * V_VERTS)
    old = lambda: torch.zeros(Bn * V_VERTS, 3, device="cuda").index_add_(
        0, flat, rows)
    repeat_equal = bool(torch.equal(new(), new()))
    scatter_gap = float((new() - old()).abs().max())
    ms_new, ms_old = cuda_ms(new, 20), cuda_ms(old, 20)
    rec = {"iters": list(iters), "fits_bit_equal": not differ,
           "differ": differ, "launches": [la, lb],
           "deterministic_mode_sites": sites,
           "index_add_fits_differ_in": control,
           "scatter": {"shape": [Bn, N, V_VERTS], "ms_index_put": ms_new,
                       "ms_index_add": ms_old, "repeat_bit_equal":
                       repeat_equal, "max_abs_vs_index_add": scatter_gap}}
    print("[prox determinism] " + json.dumps(rec))
    _bf16_check(problems, not differ and repeat_equal,
                f"two PROX fits or two backward scatters differ: {differ}, "
                f"{repeat_equal}")
    return la


def run_bf16(models, device="cuda"):
    """Phase 13: 13a-d the bf16 policy, 13e the PROX fit's determinism;
    returns each path's launches (the bf16 paths launch no rollout
    kernel, by design)."""
    t0 = time.perf_counter()
    problems = []
    check_bf16_mlps(problems, device)
    check_bf16_smpl(problems, device)
    compare_bf16_steps(problems, device)
    time_bf16_steps(problems, device)
    launches = run_bf16_clis(models, device)
    launches["prox_fit_repeat"] = check_prox_determinism(problems, models)
    print("[phase 13] " + json.dumps({"seconds": time.perf_counter() - t0}))
    if problems:
        fail(f"phase 13: {len(problems)} check(s) failed: {problems}")
    return launches


def run_fit(models):
    import torch

    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O

    w1 = E.StageWeights(joints3d=1.0)
    w2 = E.StageWeights(joints3d=1.0, pose_prior=2e-4, shape_prior=1.67e-4,
                        joints3d_smooth=10.0)
    w3 = E.StageWeights(joints3d=1.0, shape_prior=1.67e-4, motion_prior=1e-3,
                        init_motion_prior=1e-3, joint_consistency=1.0,
                        bone_length=10.0, contact_vel=1.0, contact_height=1.0)
    cfg = O.TTOConfig(seq_len=T, stage_weights=(w1, w2, w3),
                      num_iters=NUM_ITERS)
    runner = O.make_runner(cfg, models, device="cuda")
    obs = make_observations(models, seed=0)
    reset_launches()
    timings = {}
    t0 = time.perf_counter()
    res = runner(obs, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = check_result(res, NUM_ITERS, FINAL_SHAPES)
    for k in ("rollout_fwd", "rollout_bwd"):
        if launches[k] <= 0:
            fail(f"the fit never launched {k}")
    with torch.no_grad():
        s1 = res.per_stage["stage1"]
        pred1 = O.smpl_results(models.body, s1["trans"].cpu(),
                               s1["root_orient"].cpu(),
                               s1["pose_body"].cpu(), s1["betas"].cpu())
        err1 = (pred1["joints3d"] - obs["joints3d"]).norm(dim=-1).mean()
        rolled = res.final["joints3d_rollout"].cpu()
        err3 = (rolled - obs["joints3d"]).norm(dim=-1).mean()
    print("[fit] " + json.dumps({
        "seconds": wall, "stage_seconds": timings,
        "final_losses": {k: float(v[-1]) for k, v in losses.items()},
        "first_losses": {k: float(v[0]) for k, v in losses.items()},
        "stage1_mean_joint_err_m": float(err1),
        "stage3_rollout_mean_joint_err_m": float(err3),
        "launches": launches}))
    return launches


def phase_runners(models):
    """Phases 3-13 by name, in order: each returns its paths' launches,
    every path counted from zero."""
    def rgb():
        out = {"rgb_fit": run_rgb_fit(models)}
        compare_rgb_stage3(models)
        return out

    def training():
        compare_train_steps()
        time_train_steps()
        return run_training(models)

    return {
        "3": lambda: {"joints3d_fit": run_fit(models)},
        "4-5": lambda: {"prox_fit": run_prox_fit(models)},
        "6": rgb,
        # the CLIs
        "7": lambda: run_clis(models),
        "8": training,
        # the AMASS fits, the GMM, evaluation and preprocessing
        "9": lambda: run_dataset_clis(models),
        # the trained fixture and the accuracy fits
        "10": run_accuracy,
        # the other HuMoR configurations: typed rollout, no kernel, by
        # design (the kernels' layout is the default configuration's)
        "11": lambda: run_configs(models),
        # the k-step dispatch, data-parallel training and the sharded fit
        "12": lambda: run_parallel(models),
        # the bf16 precision policy and the PROX fit's determinism
        "13": lambda: run_bf16(models),
    }


PHASES = ("3", "4-5", "6", "7", "8", "9", "10", "11", "12", "13")


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--phases", nargs="+", choices=PHASES,
                    help="run only these phases after the build; prints "
                         "no kernels' line and no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from humor_torch import resolve_device
    from humor_torch.models import humor as H
    from humor_torch.ops import cuda_build
    from humor_torch.ops import rollout_kernel as RK

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. build
    t0 = time.perf_counter()
    built = cuda_build.build(["rollout_fwd", "rollout_bwd", "nn_distance"],
                             force=True)
    print("[build] " + json.dumps({"seconds": time.perf_counter() - t0,
                                   "per_library": built}))
    seconds = {"1": time.perf_counter() - t0}

    def run_phases(names):
        runners = phase_runners(make_models())
        by_path = {}
        for name in names:
            start = time.perf_counter()
            by_path.update(runners[name]())
            seconds[name] = time.perf_counter() - start
        print("[phase seconds] " + json.dumps(seconds))
        return by_path

    if args.phases:
        by_path = run_phases([p for p in PHASES if p in args.phases])
        print(json.dumps({"launches_by_path": by_path}))
        print(card_line())
        return

    # 2. kernels against their plain versions
    t2 = time.perf_counter()
    g = torch.Generator().manual_seed(1)
    params = H.init_params(H.HumorConfig(), g)
    weights = RK.RolloutWeights(params, dev)
    check_kernels(weights, M_STAGE3, 6, tol_world=1e-4, tol_bwd=1e-4,
                  timed=False)
    check_steps(weights, M_STAGE3, T_ROLL, tol_world=5e-3)
    damped_weights = RK.RolloutWeights(damped(params, 0.1), dev)
    full = check_kernels(damped_weights, M_STAGE3, T_ROLL, tol_world=5e-3,
                         tol_bwd=1e-3, timed=True)
    shapes = edge_shapes(
        weights, RK.RolloutWeights(params, dev, dtype=torch.float64),
        damped_weights, RK.RolloutWeights(damped(params, 0.1), dev,
                                          dtype=torch.float64))
    fwd_edge_err = check_fwd_edges(shapes)
    bwd_edge_err = check_bwd_edges(shapes)
    fwd_design = RK.forward_design()
    fwd_ms_128 = time_fwd(damped_weights, M_MAX, T_ROLL)
    print("[timing fwd] " + json.dumps({**fwd_design, "M": M_MAX,
                                        "T": T_ROLL, "ms": fwd_ms_128}))
    bwd_design = RK.backward_design()
    bwd_ms_128 = time_bwd(damped_weights, M_MAX, T_ROLL)
    print("[timing bwd] " + json.dumps({**bwd_design, "M": M_MAX,
                                        "T": T_ROLL, "ms": bwd_ms_128}))
    del damped_weights
    nn_err, nn_rec = check_nn()
    seconds["2"] = time.perf_counter() - t2

    # 3.-13. the fits, the CLIs, training, the dataset CLIs, the trained
    # fixture, the other configurations, the multi-device layer and the
    # bf16 policy, each path counted from zero
    by_path = run_phases(PHASES)
    launches = {k: sum(p[k] for p in by_path.values())
                for k in by_path["prox_fit"]}

    b_fwd, by_fwd = fwd_bound(weights, M_STAGE3, T_ROLL)
    b_bwd, by_bwd = bwd_bound(weights, M_STAGE3, T_ROLL)
    b_nn, by_nn = nn_bound(nn_rec["shape"])
    kernels = [
        {"name": "rollout_fwd", "route": "cuda",
         "source": "humor_torch/csrc/rollout_fwd.cu",
         "replaces": "humor_tpu/ops/rollout_kernel.py:536",
         "launches": launches["rollout_fwd"],
         "max_abs_err": full["fwd_err"], "ms": full["fwd_ms"],
         "plain_ms": full["fwd_plain_ms"], "bound_ms": b_fwd,
         "bound_by": by_fwd, "library_ms": None,
         "barriers_per_step": fwd_design["barriers_per_step"],
         "grid_blocks": fwd_design["grid_blocks"],
         "ms_m128": fwd_ms_128,
         "bound_ms_m128": fwd_bound(weights, M_MAX, T_ROLL)[0],
         "bit_identical": full["fwd_bit_identical"],
         "edge_max_abs_err": fwd_edge_err},
        {"name": "rollout_bwd", "route": "cuda",
         "source": "humor_torch/csrc/rollout_bwd.cu",
         "replaces": "humor_tpu/ops/rollout_kernel.py:609",
         "launches": launches["rollout_bwd"],
         "max_abs_err": full["bwd_err"], "ms": full["bwd_ms"],
         "plain_ms": full["bwd_plain_ms"], "bound_ms": b_bwd,
         "bound_by": by_bwd, "library_ms": None,
         "barriers_per_step": bwd_design["barriers_per_step"],
         "grid_blocks": bwd_design["grid_blocks"],
         "ms_m128": bwd_ms_128,
         "bound_ms_m128": bwd_bound(weights, M_MAX, T_ROLL)[0],
         "bit_identical": full["bwd_bit_identical"],
         "edge_max_scaled": bwd_edge_err},
        {"name": "nn_distance", "route": "cuda",
         "source": "humor_torch/csrc/nn_distance.cu",
         "replaces": "humor_tpu/ops/chamfer.py:90",
         "launches": launches["nn_distance"], "max_abs_err": nn_err,
         "ms": nn_rec["ms"], "plain_ms": nn_rec["plain_ms"], "bound_ms": b_nn,
         "bound_by": by_nn, "library_ms": None},
    ]
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
