"""Training loop: epochs with the scheduled-sampling curriculum,
validation, and the best-train, epoch, best-val and final checkpoints
(port of humor_tpu/train/trainer.py).

The steps of an epoch run in chunks of k (`steps_per_dispatch`,
train/step.make_multi_steps), and each batch of the epoch's remainder as
a chunk of 1: a chunk's stats stay on the device and are read once,
averaged over its steps. On one card every step, at every k, is the
replay of one captured CUDA graph. The chunks of an epoch are built in a
daemon thread (`_prefetch`) ahead of the steps, so the host gather
overlaps the card's work.

Data-parallel: under a `Mesh` (parallel/mesh.py) every rank steps on its
rows of each batch, the gradients are averaged over ranks, and rank 0
alone writes the log, the stats and the checkpoints.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from humor_torch.device import resolve_device
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as H
from humor_torch.parallel import mesh as P
from humor_torch.train import step as TS
from humor_torch.utils.checkpoint import load_state, save_state
from humor_torch.utils.logging import Logger
from humor_torch.utils.stats import StatTracker, to_host


@dataclass
class TrainRunConfig:
    out_dir: str = "./out/humor_train"
    epochs: int = 200
    lr: float = 1e-4
    sched_milestones: tuple = (50, 80, 140)
    sched_decays: tuple = (0.5, 0.2, 0.4)
    sched_samp_start: int = 10
    sched_samp_end: int = 20
    val_every: int = 2
    save_every: int = 25
    print_every: int = 10
    resume_ckpt: Optional[str] = None
    load_optim: bool = True
    # HuMoR-Qual: SMPL-forward joints fed back during scheduled sampling
    use_smpl_joint_inputs: bool = False
    # k steps a chunk (step.make_multi_steps), the chunk's stats read once
    # and entered in the tracker as one update of weight k; 0:
    # _AUTO_STEPS_PER_DISPATCH
    steps_per_dispatch: int = 0
    # chunks built ahead of the steps by a daemon thread (depth * k
    # batches); 0: no thread
    prefetch_depth: int = 2
    # data-parallel over the torch.distributed process group when one is
    # initialised, one device otherwise
    use_mesh: bool = True


# k when steps_per_dispatch is 0, the JAX package's knee on its TPU. On
# one card every step replays the captured graph whatever k is, so k sets
# how often the host reads the stats: once a chunk, a sync that leaves
# the card idle until the next chunk is enqueued. The supervised step at
# 200 x 10 took 25.17-25.24 ms at k = 1, 23.92-24.10 at k = 4 and
# 23.83-23.91 at k = 8 (chip_smoke.py phase 12, two turns each, NVIDIA
# H100 80GB HBM3 at 700 W), so auto keeps 8.
_AUTO_STEPS_PER_DISPATCH = 8


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Pull from `it` in a daemon thread, up to `depth` items ahead of
    the consumer. Exceptions re-raise at the consumer; a consumer that
    stops early sets `stop`, which lets the worker exit."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put((item, None)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            _put((_END, e))
        else:
            _put((_END, None))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item, exc = q.get()
            if item is _END:
                if exc is not None:
                    raise exc
                return
            yield item
    finally:
        stop.set()


class Trainer:
    def __init__(self, model_cfg: H.HumorConfig, loss_cfg: LossConfig,
                 run_cfg: TrainRunConfig,
                 train_batches: Callable[[int], Iterable[Dict]],
                 val_batches: Optional[Callable[[int], Iterable[Dict]]] = None,
                 steps_per_epoch: int = 1,
                 smpl_models: Optional[Dict] = None, seed: int = 0,
                 device="cuda",
                 train_chunks: Optional[Callable[[int, int],
                                                 Iterable]] = None):
        """train_batches(epoch) yields batches {"data_in", "data_out"
        (typed (B, T, D)), "betas", "gender_ids"} on `device`. Params
        start from H.init_params with a generator seeded `seed`; the
        posterior noise and the curriculum's draws come from a generator
        on the device seeded `seed + 1`.

        train_chunks(epoch, k), when given, is the chunk source: it
        yields (chunk, n), n batches stacked along a leading axis: n == k
        (the device store's one gather, train/cli.make_batch_fns), then
        each batch of the remainder with n == 1; its values equal
        train_batches' items stacked. Without it the trainer stacks
        train_batches' items itself. Every chunk runs through
        train/step.make_multi_steps: on one card as replays of one
        captured CUDA graph, on the CPU and under a mesh eagerly.

        With run_cfg.use_mesh and an initialised process group the
        training is data-parallel over it (parallel.mesh.make_mesh): each
        source then yields this rank's rows of every batch
        (make_batch_fns(..., mesh=) or parallel.mesh.shard_batch). A
        torchrun launch (WORLD_SIZE > 1) without an initialised group
        raises rather than train W unrelated copies."""
        if run_cfg.steps_per_dispatch < 0:
            raise ValueError(f"steps_per_dispatch "
                             f"{run_cfg.steps_per_dispatch} < 0")
        self.device = resolve_device(device)
        self.model_cfg, self.loss_cfg, self.run_cfg = model_cfg, loss_cfg, run_cfg
        self.train_batches, self.val_batches = train_batches, val_batches
        self.train_chunks = train_chunks
        self.steps_per_epoch = steps_per_epoch
        self.mesh = self._group_mesh() if run_cfg.use_mesh else None
        self.lead = self.mesh is None or self.mesh.rank == 0

        os.makedirs(run_cfg.out_dir, exist_ok=True)
        if self.lead:
            Logger.init(os.path.join(run_cfg.out_dir, "train.log"))
        self.opt = TS.make_optimizer(
            lr=run_cfg.lr, milestones=run_cfg.sched_milestones,
            decays=run_cfg.sched_decays, steps_per_epoch=steps_per_epoch)
        self.state = TS.init_train_state(
            model_cfg, self.opt, torch.Generator().manual_seed(seed),
            self.device)
        self.start_epoch = 0
        self.min_train_loss = float("inf")
        self.min_val_loss = float("inf")
        if run_cfg.resume_ckpt:
            restored = load_state(run_cfg.resume_ckpt, self.device)
            state = TS.make_train_state(restored["params"], self.opt)
            if run_cfg.load_optim and restored["opt_state"] is not None:
                state = state._replace(opt_state=restored["opt_state"])
            self.state = state
            self.start_epoch = restored["epoch"] + 1
            self.min_train_loss = restored["min_train_loss"]
            self.min_val_loss = restored["min_val_loss"]
            self._log(f"resumed from {run_cfg.resume_ckpt} at epoch "
                      f"{self.start_epoch}")
        self.sup_step, self.ss_step, self.eval_step = TS.make_train_steps(
            model_cfg, loss_cfg, self.opt, smpl_models,
            use_smpl_joint_inputs=run_cfg.use_smpl_joint_inputs,
            mesh=self.mesh)
        self.k = run_cfg.steps_per_dispatch or _AUTO_STEPS_PER_DISPATCH
        self.multi_sup, self.multi_ss = TS.make_multi_steps(
            self.sup_step, self.ss_step, self.k)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        n_params = sum(p.numel() for p in TS.tree_leaves(self.state.params))
        self._log(f"model params: {n_params / 1e6:.2f}M; device: "
                  f"{self.device}"
                  + (f" ({torch.cuda.get_device_name(self.device)})"
                     if self.device.type == "cuda" else "")
                  + (f"; data-parallel over {self.mesh.size} ranks"
                     if self.mesh is not None else "")
                  + f"; {self.k} steps a chunk")

    def _group_mesh(self) -> Optional[P.Mesh]:
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            return P.make_mesh(device=self.device)
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                "WORLD_SIZE > 1 but no process group is initialised: call "
                "humor_torch.parallel.mesh.init_from_env() first")
        return None

    def _log(self, msg: str) -> None:
        if self.lead:
            Logger.log(msg)

    def _chunk_source(self, epoch: int, k: int):
        """(chunk, n) items: stacked (k, B, ...) chunks with n == k, then
        each batch of the remainder stacked alone, n == 1."""
        if self.train_chunks is not None:
            yield from self.train_chunks(epoch, k)
            return
        it = iter(self.train_batches(epoch))
        while chunk := list(itertools.islice(it, k)):
            if len(chunk) == k:
                yield TS.stack_batches(chunk), k
            else:
                for b in chunk:
                    yield TS.stack_batches([b]), 1

    def _run_epoch(self, epoch: int, tracker: StatTracker) -> float:
        rc = self.run_cfg
        use_gt_p = TS.sched_samp_prob(epoch, rc.sched_samp_start,
                                      rc.sched_samp_end)
        sup = use_gt_p >= 1.0
        extra = () if sup else (use_gt_p,)
        multi = self.multi_sup if sup else self.multi_ss
        src = self._chunk_source(epoch, self.k)
        if rc.prefetch_depth > 0:
            src = _prefetch(src, rc.prefetch_depth)
        i = chunks = 0
        for payload, n in src:
            self.state, stats = multi(self.state, payload, epoch, *extra,
                                      generator=self.generator)
            # one read of the chunk's means, of weight n: every step of
            # the chunk weighs in the epoch's averages as a single step
            # does
            tracker.update(stats, n=n, global_step=self.state.step)
            i += n
            chunks += 1
            if chunks % rc.print_every == 0:
                self._log(f"epoch {epoch} "
                          f"{tracker.progress_str(i, max(self.steps_per_epoch, i))}"
                          f" (gt_p={use_gt_p:.2f})")
        if chunks % rc.print_every != 0:
            self._log(f"epoch {epoch} {tracker.progress_str(i, i)} "
                      f"(gt_p={use_gt_p:.2f})")
        return tracker.averages().get("total_loss", float("nan"))

    def _run_val(self, epoch: int) -> float:
        vals = [to_host(self.eval_step(self.state.params, batch, epoch,
                                       generator=self.generator))
                ["total_loss"] for batch in self.val_batches(epoch)]
        return float(np.mean(vals)) if vals else float("nan")

    def _ckpt(self, name: str, epoch: int):
        if not self.lead:
            return
        save_state(os.path.join(self.run_cfg.out_dir, name),
                   self.state.params, self.state.opt_state, epoch=epoch,
                   min_train_loss=self.min_train_loss,
                   min_val_loss=self.min_val_loss)

    def fit(self) -> Dict[str, float]:
        rc = self.run_cfg
        for epoch in range(self.start_epoch, rc.epochs):
            # the loss records restart at the curriculum's edges
            if epoch in (rc.sched_samp_start, rc.sched_samp_end):
                self.min_train_loss = float("inf")
                self.min_val_loss = float("inf")
            tracker = StatTracker(rc.out_dir if self.lead else None)
            t0 = time.time()
            try:
                train_loss = self._run_epoch(epoch, tracker)
            finally:
                tracker.close()
            self._log(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                       f"train_loss={train_loss:.5f}")
            if np.isfinite(train_loss) and train_loss < self.min_train_loss:
                self.min_train_loss = train_loss
                self._ckpt("best_train_model.npz", epoch)
            if (epoch + 1) % rc.save_every == 0:
                self._ckpt(f"epoch_{epoch:04d}.npz", epoch)
            if (self.val_batches is not None
                    and (epoch + 1) % rc.val_every == 0):
                val_loss = self._run_val(epoch)
                self._log(f"epoch {epoch} val_loss={val_loss:.5f}")
                if np.isfinite(val_loss) and val_loss < self.min_val_loss:
                    self.min_val_loss = val_loss
                    self._ckpt("best_model.npz", epoch)
        self._ckpt("final_model.npz", rc.epochs - 1)
        return {"min_train_loss": self.min_train_loss,
                "min_val_loss": self.min_val_loss}
