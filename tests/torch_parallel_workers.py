"""Rank functions for the port's multi-process CPU tests
(test_torch_parallel.py, test_torch_tto_sharded.py), run by
humor_torch.parallel.launch.spawn. They import torch and humor_torch
only, so that a rank starts without JAX."""

import torch

from humor_torch.fitting import optimizer as TO
from humor_torch.parallel import mesh as P
from humor_torch.train import step as TS


def fit(mesh, cfg, models, observed):
    """The sharded fit of the whole observation on this rank."""
    res = TO.make_runner(cfg, models, device="cpu", mesh=mesh)(observed)
    return {"final": res.final, "losses": res.losses,
            "per_stage": res.per_stage}


def fit_odd_batch(mesh, cfg, models, observed):
    """The sharded fit of a batch the ranks do not divide: the error."""
    try:
        TO.make_runner(cfg, models, device="cpu", mesh=mesh)(observed)
    except ValueError as e:
        return str(e)
    return None


def _bodies(smpl):
    from humor_torch.body_model.smpl import synthetic_smpl_model

    return ({"male": synthetic_smpl_model(10),
             "female": synthetic_smpl_model(20)} if smpl else None)


def train_steps(mesh, phase, params, batches, draws, lr, k, smpl=False):
    """Data-parallel train steps on this rank's rows of each global batch
    (every row when `mesh` is None), the global draws injected: single
    steps (k = 1; draws[i] is eps (B*T, L) for "sup", (use_gt (T,), eps
    (T, B, L)) for "ss"), or one chunk of k (make_multi_steps over the
    stacked batches, the draws stacked). Returns the losses, the first
    step's gradient averaged over ranks (single steps) and the params
    after the steps."""
    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H

    cfg = H.HumorConfig()
    loss_cfg = LossConfig() if smpl else LossConfig(
        smpl_joint_loss=0.0, smpl_mesh_loss=0.0,
        smpl_joint_consistency_loss=0.0)
    bodies = _bodies(smpl)
    opt = TS.make_optimizer(lr=lr, steps_per_epoch=10)
    sup, ss, _ = TS.make_train_steps(cfg, loss_cfg, opt, bodies, mesh=mesh)
    state = TS.make_train_state(params, opt)
    shard = (lambda b, axis=0: b) if mesh is None else (
        lambda b, axis=0: P.shard_batch(mesh, b, axis))
    if k > 1:
        multi_sup, multi_ss = TS.make_multi_steps(sup, ss, k)
        stacked = shard(TS.stack_batches(batches), 1)
        if phase == "sup":
            state, stats = multi_sup(state, stacked, 3,
                                     eps=torch.stack(draws))
        else:
            state, stats = multi_ss(
                state, stacked, 12, 0.5,
                use_gt=torch.stack([torch.as_tensor(u) for u, _ in draws]),
                eps=torch.stack([e for _, e in draws]))
        return {"losses": stats["total_loss"], "grads": None,
                "params": [p.detach() for p in TS.tree_leaves(state.params)]}
    losses, grads = [], None
    for b, d in zip(batches, draws):
        local = shard(b)
        if grads is None:
            # the first step's gradient, averaged over ranks as the step
            # averages it
            if phase == "sup":
                rows = slice(None) if mesh is None else P.local_rows(
                    mesh, d.shape[0])
                loss, _ = TS.supervised_loss_fn(cfg, loss_cfg, bodies)(
                    state.params, local, 3, eps=d[rows])
            else:
                use_gt, eps = d
                rows = slice(None) if mesh is None else P.local_rows(
                    mesh, eps.shape[1])
                loss, _ = TS.sched_samp_loss_fn(cfg, loss_cfg, bodies)(
                    state.params, local, 12, 0.5, use_gt=use_gt,
                    eps=eps[:, rows])
            g = list(torch.autograd.grad(loss, TS.tree_leaves(state.params)))
            grads = g if mesh is None else P.all_reduce_grad_mean(mesh, g)
        if phase == "sup":
            state, stats = sup(state, local, 3, eps=d)
        else:
            state, stats = ss(state, local, 12, 0.5, use_gt=d[0], eps=d[1])
        losses.append(stats["total_loss"])
    return {"losses": torch.stack(losses), "grads": grads,
            "params": [p.detach() for p in TS.tree_leaves(state.params)]}


def gather_grad(mesh, n):
    """all_gather_batch of each rank's (n, 1) rows, the squared sum
    charged on rank 0 only: the gradient each rank gets."""
    x = (torch.arange(n, dtype=torch.float32)[:, None]
         + 10.0 * mesh.rank).requires_grad_(True)
    g = P.all_gather_batch(mesh, x)
    loss = (g ** 2).sum() if mesh.rank == 0 else (g * 0.0).sum()
    loss.backward()
    return {"gathered": g.detach(), "grad": x.grad,
            "max": P.all_reduce_max(mesh, torch.tensor(float(mesh.rank)))}


def trainer_fit(mesh, processed, out_dir, k, epochs=2):
    """The trainer over the device store's chunk source (CPU store) at
    batch 4, 4 steps an epoch, with validation: the rank's rows of each
    batch, data-parallel over the process group when `mesh` is given
    (the trainer finds it), in one process when None."""
    from types import SimpleNamespace

    from humor_torch.data.dataset import AmassDataset
    from humor_torch.losses.elbo import LossConfig
    from humor_torch.models import humor as H
    from humor_torch.train.cli import make_batch_fn, make_batch_fns
    from humor_torch.train.trainer import Trainer, TrainRunConfig

    ds = AmassDataset.from_processed(processed)
    cfg = SimpleNamespace(batch_size=4, data_noise_std=0.0, model_steps_in=1,
                          data_on_device=1)
    batches, chunks = make_batch_fns(ds, cfg, 6, 4, 3, "cpu", mesh=mesh)
    rc = TrainRunConfig(out_dir=out_dir, epochs=epochs, val_every=1,
                        save_every=1, print_every=1, sched_samp_start=1,
                        sched_samp_end=3, steps_per_dispatch=k)
    tr = Trainer(H.HumorConfig(), LossConfig(
        smpl_joint_loss=0.0, smpl_mesh_loss=0.0,
        smpl_joint_consistency_loss=0.0), rc, train_batches=batches,
        train_chunks=chunks,
        val_batches=make_batch_fn(ds, cfg, 6, 2, 10, "cpu", mesh=mesh),
        steps_per_epoch=4, seed=0, device="cpu")
    out = tr.fit()
    return {**out, "params": [p.detach() for p in
                              TS.tree_leaves(tr.state.params)],
            "step": tr.state.step,
            "ranks": 1 if tr.mesh is None else tr.mesh.size}
