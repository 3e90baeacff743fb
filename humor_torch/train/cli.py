"""Training CLI (port of humor_tpu/train/cli.py):

    python -m humor_torch.train.cli @configs/train_humor.cfg [--device cpu]
    torchrun --nproc-per-node N -m humor_torch.train.cli \
        @configs/train_humor.cfg          # data-parallel over N ranks

Trains on processed AMASS npz files under --data-path, else on eight
synthetic sequences (so the CLI runs without licensed data), with the
male and female SMPL+H bodies under --smplh-root, else seeded synthetic
stand-ins. Runs on the card unless `--device cpu` is given; asking for
the card without one raises. Under torchrun (WORLD_SIZE > 1) it
initialises the process group from the environment (NCCL on the card,
gloo on the CPU, or --dist-backend) and trains data-parallel: every rank
takes its rows of each --batch-size batch, and rank 0 writes the log,
stats and checkpoints.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def build_dataset(cfg, datasets, fallback_seed=0, default_names=None,
                  device="cpu"):
    """Processed-npz dataset when files exist, else synthetic sequences.

    default_names: the HuMoR paper's split for this role
    (data/amass.py), used when `datasets` is empty; if it matches no
    file, every processed file is used."""
    from humor_torch.data.dataset import AmassDataset, find_processed_files

    names = list(datasets) if datasets else list(default_names or ())
    paths = find_processed_files(cfg.data_path, names or None)
    if not paths and names and not datasets:
        paths = find_processed_files(cfg.data_path, None)
    if paths:
        return AmassDataset.from_npz_files(paths)
    from humor_torch.body_model.smpl import synthetic_smpl_model
    from humor_torch.data import amass as A

    print(f"[train] no processed data under {cfg.data_path!r}; "
          "using synthetic sequences")
    model = synthetic_smpl_model(device=device)
    rng = np.random.RandomState(fallback_seed)
    seqs = []
    for i in range(8):
        raw = {
            "fps": np.asarray(60.0),
            "gender": ["male", "female"][i % 2],
            "trans": np.cumsum(rng.randn(400, 3) * 0.01, axis=0),
            "root_orient": rng.randn(400, 3) * 0.2,
            "pose_body": rng.randn(400, 63) * 0.1,
            "betas": rng.randn(16) * 0.3,
        }
        seq = A.process_sequence(model, raw, discard_terrain=False)
        if seq is not None:
            seqs.append(seq)
    return AmassDataset.from_processed(seqs)


def load_body_models(smplh_root: str, device="cpu") -> Dict:
    """The male and female SMPL+H bodies under `smplh_root`, else seeded
    synthetic stand-ins (the JAX package's PRNGKey(10) / (20) bodies)."""
    from humor_torch.body_model import smpl as S

    out = {}
    for gender in ("male", "female"):
        path = S.find_model_path(smplh_root, gender)
        if os.path.exists(path):
            out[gender] = S.load_smpl_npz(path, device=device)
    if len(out) == 2:
        return out
    print(f"[train] no male and female bodies under {smplh_root!r}; "
          "using synthetic ones")
    return {"male": S.synthetic_smpl_model(10, device=device),
            "female": S.synthetic_smpl_model(20, device=device)}


def make_batch_fns(dataset, cfg, window_frames: int, steps: int, seed: int,
                   device, budget_bytes: Optional[int] = None, mesh=None):
    """-> (train_batches(epoch), train_chunks(epoch, k) | None): the
    generator factories of `steps` training batches an epoch (batch i of
    an epoch from seed seed + epoch * 100003 + i; pairs with a
    cfg.model_steps_in-frame past, data.windows.window_to_pairs_multi when
    that is over 1).

    With the device store (cfg.data_on_device, data/device_store
    .maybe_stage) a batch moves only its start rows to the card, and
    train_chunks yields the k batches of a k-step chunk as one (k, B, ...)
    gather, `(chunk, k)`, then the epoch's remainder as `(batch, 1)`
    items; a chunk equals the k batches of train_batches stacked. Without
    the store the windows are gathered on the host and copied, and
    train_chunks is None (the trainer stacks batches itself). Both paths
    give the same values at noise_std 0 (tests/test_torch_train_data.py).

    Under a data-parallel `mesh` every rank samples the same global
    windows and keeps its rows of each batch (parallel.mesh.local_rows):
    the store gathers only those; the host path gathers the batch and
    copies those."""
    from humor_torch.data.device_store import TRAIN_COLUMNS, maybe_stage
    from humor_torch.data.windows import (window_to_pairs,
                                          window_to_pairs_multi)
    from humor_torch.parallel.mesh import local_rows

    S = cfg.model_steps_in
    to_pairs = ((lambda w: window_to_pairs(w)[:2]) if S == 1
                else (lambda w: window_to_pairs_multi(w, S)))
    store = maybe_stage(dataset, device, cfg.data_on_device,
                        budget_bytes=budget_bytes)
    rows = None if mesh is None else local_rows(mesh, cfg.batch_size)
    step_seed = lambda epoch, i: seed + epoch * 100003 + i

    def _batch(world, meta):
        data_in, data_out = to_pairs(world)
        return {"data_in": data_in, "data_out": data_out,
                "betas": meta["betas"], "gender_ids": meta["gender_ids"]}

    def _store_batch(s: int):
        return _batch(*store.sample_windows(
            s, cfg.batch_size, window_frames, noise_std=cfg.data_noise_std,
            rows=rows))

    def _host_batch(s: int):
        world_np, meta_np = dataset.sample_windows(
            s, cfg.batch_size, window_frames, noise_std=cfg.data_noise_std)
        keep = slice(None) if rows is None else rows
        world = {k: torch.as_tensor(np.ascontiguousarray(world_np[k][keep]))
                 .to(device) for k in TRAIN_COLUMNS}
        meta = {"betas": torch.as_tensor(meta_np["betas"][keep]).to(device),
                "gender_ids": torch.as_tensor(
                    meta_np["gender_ids"][keep].astype(np.int64) % 2)
                .to(device)}
        return _batch(world, meta)

    one = _store_batch if store is not None else _host_batch

    def batches(epoch: int):
        for i in range(steps):
            yield one(step_seed(epoch, i))

    if store is None:
        return batches, None

    def chunks(epoch: int, k: int):
        i = 0
        while i < steps:
            n = min(k, steps - i)
            seeds = [step_seed(epoch, i + j) for j in range(n)]
            if n == k:
                # pairs over the chunk's leading (k, B) axes
                yield _batch(*store.sample_window_chunk(
                    seeds, cfg.batch_size, window_frames,
                    noise_std=cfg.data_noise_std, rows=rows)), k
            else:
                for s in seeds:
                    yield _store_batch(s), 1
            i += n

    return batches, chunks


def make_batch_fn(dataset, cfg, window_frames: int, steps: int, seed: int,
                  device, budget_bytes: Optional[int] = None, mesh=None):
    """train_batches of make_batch_fns alone (the validation source)."""
    return make_batch_fns(dataset, cfg, window_frames, steps, seed, device,
                          budget_bytes=budget_bytes, mesh=mesh)[0]


def main(argv=None) -> Dict[str, float]:
    from humor_torch.data import amass as A
    from humor_torch.data.device_store import (DeviceWindowStore,
                                               default_budget_bytes)
    from humor_torch.device import resolve_device
    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.parallel.mesh import init_from_env
    from humor_torch.train.trainer import TrainRunConfig, Trainer
    from humor_torch.utils.config import TrainCLIConfig, parse_into

    cfg = parse_into(TrainCLIConfig, argv, prog="humor-torch-train")
    dev = resolve_device(cfg.device)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # a torchrun launch: data-parallel over its ranks
        mesh = init_from_env(cfg.dist_backend or None, device=dev)
        dev = mesh.device
    model_cfg = H.HumorConfig(
        latent_size=cfg.latent_size, in_rot_rep=cfg.in_rot_rep,
        out_rot_rep=cfg.out_rot_rep,
        model_data_config=cfg.model_data_config,
        conditional_prior=cfg.conditional_prior,
        output_delta=cfg.output_delta, steps_in=cfg.model_steps_in,
        compute_dtype=cfg.model_compute_dtype or None)
    smpl_w = lambda w: w if cfg.use_smpl_losses else 0.0
    loss_cfg = LossConfig(
        kl_loss=cfg.kl_loss, kl_loss_anneal_start=cfg.kl_loss_anneal_start,
        kl_loss_anneal_end=cfg.kl_loss_anneal_end,
        contacts_loss=cfg.contacts_loss,
        contacts_vel_loss=cfg.contacts_vel_loss,
        smpl_joint_loss=smpl_w(cfg.smpl_joint_loss),
        smpl_mesh_loss=smpl_w(cfg.smpl_mesh_loss),
        smpl_joint_consistency_loss=smpl_w(cfg.smpl_joint_consistency_loss))
    run_cfg = TrainRunConfig(
        out_dir=cfg.out, epochs=cfg.epochs, lr=cfg.lr,
        sched_milestones=tuple(cfg.sched_milestones),
        sched_decays=tuple(cfg.sched_decays),
        sched_samp_start=cfg.sched_samp_start,
        sched_samp_end=cfg.sched_samp_end, val_every=cfg.val_every,
        save_every=cfg.save_every, print_every=cfg.print_every,
        resume_ckpt=cfg.ckpt or None, load_optim=not cfg.no_load_optim,
        use_smpl_joint_inputs=cfg.model_use_smpl_joint_inputs,
        steps_per_dispatch=cfg.steps_per_dispatch,
        prefetch_depth=cfg.prefetch_depth)

    train_ds = build_dataset(cfg, cfg.train_datasets,
                             default_names=A.TRAIN_DATASETS, device=dev)
    val_ds = build_dataset(cfg, cfg.val_datasets, fallback_seed=1,
                           default_names=A.VAL_DATASETS, device=dev)
    # sample_num_frames transitions after a steps_in-frame past
    window = cfg.sample_num_frames + cfg.model_steps_in
    # HuMoR-Qual needs the bodies even with the SMPL losses off
    smpl_models = (load_body_models(cfg.smplh_root, dev)
                   if cfg.use_smpl_losses or cfg.model_use_smpl_joint_inputs
                   else None)
    train_batches, train_chunks = make_batch_fns(
        train_ds, cfg, window, cfg.steps_per_epoch, cfg.seed, dev,
        mesh=mesh)
    # the val store only auto-stages into what the train store left
    used = (DeviceWindowStore.staged_nbytes(train_ds)
            if train_chunks is not None else 0)
    val_batches = make_batch_fn(
        val_ds, cfg, window, max(1, cfg.steps_per_epoch // 10),
        cfg.seed + 7, dev,
        budget_bytes=max(0, default_budget_bytes(dev) - used), mesh=mesh)
    trainer = Trainer(model_cfg, loss_cfg, run_cfg,
                      train_batches=train_batches, val_batches=val_batches,
                      train_chunks=train_chunks,
                      steps_per_epoch=cfg.steps_per_epoch,
                      smpl_models=smpl_models, seed=cfg.seed, device=dev)
    return trainer.fit()


if __name__ == "__main__":
    main()
