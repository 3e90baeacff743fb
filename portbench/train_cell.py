"""The training cells (traffic kind "train"): HuMoR's training
step at configs/train_humor.cfg's 200 windows x 10 transitions, through
`humor_torch.train.step.make_train_steps` and `make_multi_steps` in
chunks of k steps, each chunk fed by one
`DeviceWindowStore.sample_window_chunk` gather and canonicalized into
pairs as the train CLI's chunk source does, its stats read by the host
once a chunk as the trainer reads them.

Set-up makes the weights on the device from the seed, the synthetic
sequences (through `AmassDataset.from_processed`) and the device store,
builds one train state, and drives it through its first chunk of k
steps, the window's own call on the window's own feed, which the output
check holds to the plain reference. The window hands that same state on
and runs whole chunks back to back while the time left is at least the
longest chunk seen. The posterior noise and the scheduled-sampling
choices are drawn by the benchmark on the device and passed to the
steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts, trace, train_check
from portbench import train_traffic as TT
from portbench import weights as W
from portbench.fit_cell import humor_kwargs, sub_seeds, sync


def loss_kwargs(conf):
    return {k: conf[k] for k in (
        "kl_loss", "kl_loss_anneal_start", "kl_loss_anneal_end",
        "contacts_loss", "contacts_vel_loss", "smpl_joint_loss",
        "smpl_mesh_loss", "smpl_joint_consistency_loss")}


def optimizer(TS, conf):
    return TS.make_optimizer(lr=conf["lr"], milestones=conf["sched_milestones"],
                             decays=conf["sched_decays"],
                             steps_per_epoch=conf["steps_per_epoch"],
                             optim=conf["optimizer"])


class TrainCell:
    """Set-up of one training cell."""

    def __init__(self, cell, seed: int, device):
        from humor_torch.body_model.smpl import SmplModel
        from humor_torch.data.dataset import AmassDataset
        from humor_torch.data.device_store import DeviceWindowStore
        from humor_torch.losses.elbo import LossConfig
        from humor_torch.models import humor as H
        from humor_torch.train import step as TS
        from portbench.reference import humor as RH
        from portbench.reference import smpl as RS

        conf, traffic = cell.config, cell.traffic
        self.conf, self.traffic = conf, traffic
        self.device = dev = torch.device(device)
        self.TS = TS
        s = sub_seeds(seed, 4)
        gen = torch.Generator(device=dev).manual_seed(s[0])
        hkw = humor_kwargs(conf)
        self.hcfg, self.rhcfg = H.HumorConfig(**hkw), RH.HumorConfig(**hkw)
        self.weights = W.humor_weights(self.rhcfg, conf["humor_hidden"], gen)
        arrays = {g: W.synthetic_body(conf["body_seeds"][g],
                                      conf["num_verts"], conf["num_joints"])
                  for g in ("male", "female")}
        self.bodies = {g: W.body_model(SmplModel, a, dev)
                       for g, a in arrays.items()}
        self.ref_bodies = {g: W.body_model(RS.SmplModel, a, dev)
                           for g, a in arrays.items()}
        self.seqs = TT.make_sequences(conf["train_sequences"],
                                      conf["sequence_frames"], s[1],
                                      self.ref_bodies, dev)
        self.store = DeviceWindowStore.from_dataset(
            AmassDataset.from_processed(self.seqs), dev)
        self.B, self.T = conf["batch_size"], conf["sample_num_frames"]
        self.k = conf["steps_per_dispatch"]
        self.epoch = traffic["epoch"]
        self.use_gt_p = TS.sched_samp_prob(self.epoch, conf["sched_samp_start"],
                                           conf["sched_samp_end"])
        self.sched = self.use_gt_p < 1.0
        self.loss_cfg = LossConfig(**loss_kwargs(conf))
        self.opt = optimizer(TS, conf)
        sup, ss, _ = TS.make_train_steps(self.hcfg, self.loss_cfg, self.opt,
                                         self.bodies)
        self.multi = TS.make_multi_steps(sup, ss, self.k)[
            1 if self.sched else 0]
        self.draw_gen = torch.Generator(device=dev).manual_seed(s[2])
        self.seed_rng = np.random.RandomState(s[3] % (2 ** 32))

    def chunk(self, k: int):
        """(stacked batches, step seeds, draws) of the next k steps: one
        gather of k windows batches on the device, canonicalized into
        pairs over its (k, B) axes."""
        from humor_torch.data.windows import window_to_pairs

        seeds = [int(x) for x in self.seed_rng.randint(0, 2 ** 31 - 1, k)]
        world, meta = self.store.sample_window_chunk(
            seeds, self.B, self.T + 1, noise_std=self.conf["data_noise_std"])
        data_in, data_out, _ = window_to_pairs(world)
        stacked = {"data_in": data_in, "data_out": data_out,
                   "betas": meta["betas"], "gender_ids": meta["gender_ids"]}
        L, g, dev = self.hcfg.latent_size, self.draw_gen, self.device
        if self.sched:
            draws = {"use_gt": torch.rand(k, self.T, generator=g, device=dev)
                     < self.use_gt_p,
                     "eps": torch.randn(k, self.T, self.B, L, generator=g,
                                        device=dev)}
        else:
            draws = {"eps": torch.randn(k, self.B * self.T, L, generator=g,
                                        device=dev)}
        return stacked, seeds, draws

    def step(self, multi, state, stacked, draws):
        extra = (self.use_gt_p,) if self.sched else ()
        return multi(state, stacked, self.epoch, *extra, **draws)


def run(cell, args, t_start: float, device="cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = TrainCell(cell, args.seed, device)
    TS = tc.TS
    state = TS.make_train_state(tc.weights, tc.opt)
    # the first chunk, held to the reference after the window
    stacked, seeds, draws = tc.chunk(tc.k)
    state, stats = tc.step(tc.multi, state, stacked, draws)
    first = {"seeds": seeds, "draws": draws,
             "losses": stats["total_loss"].tolist(),
             "moment": [m.detach().clone() for m in
                        TS.tree_leaves(state.opt_state["mu"])],
             "params": [p.detach().clone()
                        for p in TS.tree_leaves(state.params)]}
    sync(device)
    setup_s = time.perf_counter() - t_start

    walls, losses = [], []
    longest = 0.0
    t_open = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if walls and t_open + args.seconds - t0 < longest:
            break
        stacked, _, draws = tc.chunk(tc.k)
        state, stats = tc.step(tc.multi, state, stacked, draws)
        losses.append(stats["total_loss"].cpu())   # one read a chunk
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        longest = max(longest, t1 - t0)
        t_last = t1
    span = t_last - t_open
    steps = len(walls) * tc.k
    dev_info = {"platform": "gpu" if tc.device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0)
                         if tc.device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if tc.device.type == "cuda" else 0)}
    failed = int(sum(int((~torch.isfinite(l)).sum()) for l in losses))
    record = {"step_s": span / steps, "chunk_s": span / len(walls),
              "step_flops": counts.train_step_flops(
                  tc.B, tc.T, cell.config["num_verts"])}
    breakdown = None
    if args.trace:
        import warnings

        stacked, _, draws = tc.chunk(tc.k)
        sync(device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, stats = tc.step(tc.multi, state, stacked, draws)
                stats["total_loss"].cpu()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        record["syncs_per_step"] = sum(
            1 for w in caught if "synchroniz" in str(w.message)) / tc.k
        stacked, _, draws = tc.chunk(tc.k)

        def one_chunk():
            tc.step(tc.multi, state, stacked, draws)[1]["total_loss"].cpu()

        prof, wall = trace.profile(one_chunk)
        record["profile"] = prof
        dev_info["busy_s"] = prof.busy_s()
        dev_info["window_s"] = wall
        breakdown = {"device_ops": prof.top_ops(),
                     "idle_gaps": prof.idle_gaps()}
    del state, stacked, stats, draws
    tc.multi = None
    if tc.device.type == "cuda":
        torch.cuda.empty_cache()
    compared = train_check.compare(tc, first, cell.limits)
    return {"end_to_end": {"train_samples_per_s": steps * tc.B / span,
                           "setup_s": setup_s},
            "record": record, "compared": compared, "walls": walls, "attempted": steps,
            "failed": failed, "device": dev_info, "breakdown": breakdown}
