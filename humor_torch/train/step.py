"""Training and eval steps for the HuMoR CVAE (port of
humor_tpu/train/step.py).

The supervised phase flattens (B, T) transitions into one batch of B*T
rows; the scheduled-sampling phase is models.humor.scheduled_sampling.
Gradients come from torch.autograd over the params pytree (leaves with
requires_grad). The optimizer is optax's
apply_if_finite(chain([clip_by_global_norm], adamax or
adam(piecewise_constant))) written in torch as optax 0.2.6 computes it:
a step with a non-finite gradient leaves params, moments and the
schedule's count unchanged, and the schedule's milestones count applied
steps.

`make_multi_steps` runs k steps over a chunk stacked along a new leading
axis (`stack_batches`), as the JAX package scans them in one program; its
stats stay on the device, so the trainer reads a chunk's stats once.
Under a data-parallel `Mesh` (parallel/mesh.py) each rank steps on its
rows of the batch; see make_train_steps.

Spans (utils/profiling): "train.step" a step, in "train.forward" (the
model), "train.elbo" (the loss; its SMPL terms "train.smpl_losses"),
"train.backward" (the gradient) and "train.optimizer".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from humor_torch.body_model.gendered import make_rollout_joint_fn
from humor_torch.losses.elbo import LossConfig, elbo_loss
from humor_torch.models import humor as H
from humor_torch.parallel import mesh as P
from humor_torch.utils import profiling as PR

MAX_CONSECUTIVE_ERRORS = 10 ** 6   # apply_if_finite's, as the JAX package


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in jax.tree_util order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the summed squares of every leaf."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclass(frozen=True)
class _Optimizer:
    """optax's base(piecewise_constant_schedule(lr, {m*spe: d})) behind
    clip_by_global_norm(grad_clip) (when set) and apply_if_finite; the
    subclass gives the moments and the direction. State: {"count",
    "notfinite_count", "total_notfinite", "last_finite", "mu", "nu"}; all
    on the params' device, so a step never waits for the host. The bias
    corrections and the rate are in the params' dtype (float32 as in the
    JAX package; float64 as optax computes under x64)."""

    lr: float = 1e-4
    boundaries: Tuple[Tuple[int, float], ...] = ()
    grad_clip: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Any) -> Dict[str, Any]:
        dev = tree_leaves(params)[0].device
        i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        zeros = lambda p: torch.zeros_like(p)
        return {"count": i32(), "notfinite_count": i32(),
                "total_notfinite": i32(),
                "last_finite": torch.ones((), dtype=torch.bool, device=dev),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def learning_rate(self, count: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
        """piecewise_constant_schedule at `count`."""
        v = torch.tensor(self.lr, dtype=dtype, device=count.device)
        for boundary, scale in sorted(self.boundaries):
            v = torch.where(count >= boundary, v * scale, v)
        return v

    def _step(self, g, mu, nu, count_inc, dtype):
        """-> (new mu, new nu, the direction the rate scales)."""
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: Any) -> Dict[str, Any]:
        """Apply one step to the leaves of `params` in place (grads in
        tree_leaves order); returns the new state."""
        leaves = tree_leaves(params)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        notfinite = torch.where(finite, torch.zeros_like(
            state["notfinite_count"]), state["notfinite_count"] + 1)
        ok = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
        if self.grad_clip:
            g_norm = global_norm(grads)
            grads = [torch.where(g_norm < self.grad_clip, g,
                                 (g / g_norm) * self.grad_clip)
                     for g in grads]
        count = state["count"]
        dtype = leaves[0].dtype
        step_size = -self.learning_rate(count, dtype)
        count_inc = count + 1
        mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        for p, g, mu, nu in zip(leaves, grads, mus, nus):
            mu_new, nu_new, direction = self._step(g, mu, nu, count_inc,
                                                   dtype)
            upd = step_size * direction
            p.copy_(torch.where(ok, p + upd, p))
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
        return {**state, "count": torch.where(ok, count_inc, count),
                "notfinite_count": notfinite, "last_finite": finite,
                "total_notfinite": torch.where(
                    finite, state["total_notfinite"],
                    state["total_notfinite"] + 1)}


def _bias(decay: float, count_inc: torch.Tensor, dtype) -> torch.Tensor:
    """optax's bias correction 1 - decay^count."""
    return 1.0 - torch.tensor(decay, dtype=dtype,
                              device=count_inc.device) ** count_inc


class Adamax(_Optimizer):
    """optax.adamax:

        mu  = (1 - b1) g + b1 mu
        nu  = max(|g| + eps, b2 nu)
        p  -= lr(count) * (mu / (1 - b1^(count+1))) / nu

    (optax 0.2.6 adds eps inside the max, as torch.optim.Adamax does; the
    two differ in where the bias correction and the rate are applied.)"""

    def _step(self, g, mu, nu, count_inc, dtype):
        mu_new = (1.0 - self.b1) * g + self.b1 * mu
        nu_new = torch.maximum(torch.abs(g) + self.eps, self.b2 * nu)
        return mu_new, nu_new, (mu_new / _bias(self.b1, count_inc, dtype)) \
            / nu_new


class Adam(_Optimizer):
    """optax.adam (eps_root 0):

        mu  = (1 - b1) g + b1 mu
        nu  = (1 - b2) g^2 + b2 nu
        p  -= lr(count) * mu_hat / (sqrt(nu_hat) + eps)

    with mu_hat = mu / (1 - b1^(count+1)), nu_hat = nu / (1 - b2^(count+1))
    (eps outside the root)."""

    def _step(self, g, mu, nu, count_inc, dtype):
        mu_new = (1.0 - self.b1) * g + self.b1 * mu
        nu_new = (1.0 - self.b2) * g ** 2 + self.b2 * nu
        mu_hat = mu_new / _bias(self.b1, count_inc, dtype)
        nu_hat = nu_new / _bias(self.b2, count_inc, dtype)
        return mu_new, nu_new, mu_hat / (torch.sqrt(nu_hat) + self.eps)


_OPTIMIZERS = {"adamax": Adamax, "adam": Adam}


def make_optimizer(lr: float = 1e-4, milestones=(50, 80, 140),
                   decays=(0.5, 0.2, 0.4), steps_per_epoch: int = 1,
                   optim: str = "adamax",
                   grad_clip: Optional[float] = None) -> _Optimizer:
    """Adamax (or Adam, `optim="adam"`) with the reference's MultiStepLR
    as a step schedule: the rate is scaled by decays[i] from
    milestones[i] * steps_per_epoch applied steps on."""
    return _OPTIMIZERS[optim](lr=lr, grad_clip=grad_clip, boundaries=tuple(
        (int(m) * steps_per_epoch, float(d))
        for m, d in zip(milestones, decays)))


class TrainState(NamedTuple):
    params: Any            # pytree of leaves with requires_grad
    opt_state: Dict[str, Any]
    step: int


def init_train_state(cfg: H.HumorConfig, opt: _Optimizer,
                     generator: torch.Generator, device="cpu") -> TrainState:
    params = H.init_params(cfg, generator, device=device)
    return make_train_state(params, opt)


def make_train_state(params: Any, opt: _Optimizer) -> TrainState:
    """Take `params` (a float32 pytree) as the trained leaves."""
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    return TrainState(params, opt.init(params), 0)


def _flatten_supervised(cfg: H.HumorConfig, batch: Dict) -> Tuple:
    """(B, T, D) typed dicts -> flat (B*T, ...) inputs, gt, gender, betas.
    At steps_in = S > 1 the data_in components are (B, T, S, D) windows
    (data.windows.window_to_pairs_multi)."""
    data_in, data_out = batch["data_in"], batch["data_out"]
    B, T = data_in["trans"].shape[:2]
    flat_out = {k: v.reshape(B * T, -1) for k, v in data_out.items()}
    if cfg.steps_in == 1:
        past = H.state_to_input(
            cfg, {k: v.reshape(B * T, -1) for k, v in data_in.items()})
    else:
        past = H.state_to_input_window(cfg, {
            k: v.reshape(B * T, cfg.steps_in, -1) for k, v in data_in.items()})
    return (past, H.state_to_input(cfg, flat_out),
            flat_out, batch["gender_ids"].repeat_interleave(T),
            batch["betas"].repeat_interleave(T, dim=0))


def supervised_loss_fn(cfg: H.HumorConfig, loss_cfg: LossConfig,
                       smpl_models: Optional[Dict]):
    """fn(params, batch, epoch, eps=None, generator=None) -> (loss,
    stats): every step teacher-forced; eps (B*T, latent) is the
    posterior noise."""

    def fn(params, batch, epoch, eps=None, generator=None):
        with PR.span("train.forward"):
            past, t_in, gt, gender, betas = _flatten_supervised(cfg, batch)
            out = H.single_step(cfg, params, past, t_in, eps=eps,
                                generator=generator)
        with PR.span("train.elbo"):
            return elbo_loss(loss_cfg, out.pred, out.posterior, out.prior,
                             gt, epoch, gender_ids=gender, betas=betas,
                             smpl_models=smpl_models)

    return fn


def sched_samp_loss_fn(cfg: H.HumorConfig, loss_cfg: LossConfig,
                       smpl_models: Optional[Dict],
                       use_smpl_joint_inputs: bool = False):
    """fn(params, batch, epoch, use_gt_p, use_gt=None, eps=None,
    generator=None) -> (loss, stats): predictions fed forward with
    probability 1 - use_gt_p per step, each step supervised. With
    `use_smpl_joint_inputs` (HuMoR-Qual) the fed-back joints come from
    the gendered SMPL forward."""
    if use_smpl_joint_inputs and smpl_models is None:
        raise ValueError("use_smpl_joint_inputs requires smpl_models")

    def fn(params, batch, epoch, use_gt_p, use_gt=None, eps=None,
           generator=None):
        data_in, data_out = batch["data_in"], batch["data_out"]
        B, T = data_in["trans"].shape[:2]
        with PR.span("train.forward"):
            joint_fn = (make_rollout_joint_fn(
                smpl_models, batch["gender_ids"], batch["betas"])
                if use_smpl_joint_inputs else None)
            x_past = (H.state_to_input(cfg, data_in) if cfg.steps_in == 1
                      else H.state_to_input_window(cfg, data_in))
            out = H.scheduled_sampling(
                cfg, params, x_past,
                H.state_to_input(cfg, data_out),
                {k: v[:, 0] for k, v in data_in.items()}, use_gt_p,
                smpl_joint_fn=joint_fn, use_gt=use_gt, eps=eps,
                generator=generator)
        flat = lambda v: v.reshape(B * T, -1)
        with PR.span("train.elbo"):
            return elbo_loss(
                loss_cfg, {k: flat(v) for k, v in out.pred.items()},
                tuple(flat(v) for v in out.posterior),
                tuple(flat(v) for v in out.prior),
                {k: flat(v) for k, v in data_out.items()}, epoch,
                gender_ids=batch["gender_ids"].repeat_interleave(T),
                betas=batch["betas"].repeat_interleave(T, dim=0),
                smpl_models=smpl_models)

    return fn


def _global_noise(generator, rows: int, latent: int, dtype, device
                  ) -> torch.Tensor:
    """The (rows, latent) standard-normal draw that models.humor.rsample
    makes for a batch of `rows` rows."""
    return torch.randn((rows, latent), generator=generator, dtype=dtype,
                       device=generator.device if generator is not None
                       else device).to(device)


def make_train_steps(cfg: H.HumorConfig, loss_cfg: LossConfig,
                     opt: _Optimizer,
                     smpl_models: Optional[Dict] = None,
                     use_smpl_joint_inputs: bool = False,
                     mesh: Optional[P.Mesh] = None):
    """(supervised_step, sched_samp_step, eval_step).

    supervised_step(state, batch, epoch, eps=None, generator=None) and
    sched_samp_step(state, batch, epoch, use_gt_p, use_gt=None, eps=None,
    generator=None) update the params and the optimizer's moments in
    place and return (TrainState, stats); eval_step(params, batch, epoch,
    eps=None, generator=None) -> stats. Stats are 0-d tensors, with
    "total_loss" and, for the train steps, "grad_norm"
    (optax.global_norm of the gradient before clipping).

    With a `mesh` the batch is this rank's rows of a global batch of W
    times as many (parallel.mesh.shard_batch). Every rank draws the
    global posterior noise (and the curriculum's choices) from its copy
    of the generator, in the order the single-rank step draws them, and
    keeps its own rows; `eps` and `use_gt`, when given, are the global
    draws. Each rank's loss is the mean over its rows, and every ELBO
    term (losses/elbo.py) is a mean over rows, so over equal shards the
    mean of the ranks' losses is the global loss: the gradients are
    averaged over ranks before the optimizer, whose non-finite skip is
    then the same on every rank, and the params stay equal on all of
    them. The stats are averaged over ranks too (for the contact
    accuracies, ratios over a rank's rows, that is not the global
    ratio)."""
    sup_loss = supervised_loss_fn(cfg, loss_cfg, smpl_models)
    ss_loss = sched_samp_loss_fn(cfg, loss_cfg, smpl_models,
                                 use_smpl_joint_inputs=use_smpl_joint_inputs)

    def _local(batch):
        """(B_local, T, rows of a global batch)."""
        B, T = batch["data_in"]["trans"].shape[:2]
        return B, T, slice(None) if mesh is None else P.local_rows(
            mesh, B * mesh.size)

    def _sup_eps(params, batch, eps, generator):
        if mesh is None:
            return eps
        B, T, rows = _local(batch)
        if eps is None:
            leaf = tree_leaves(params)[0]
            eps = _global_noise(generator, B * mesh.size * T,
                                cfg.latent_size, leaf.dtype, leaf.device)
        return eps[rows.start * T:rows.stop * T]

    def _ss_draws(params, batch, use_gt_p, use_gt, eps, generator):
        if mesh is None:
            return use_gt, eps
        B, T, rows = _local(batch)
        if use_gt is None:
            use_gt = torch.rand(
                T, generator=generator,
                device=generator.device if generator is not None
                else "cpu") < use_gt_p
        if eps is None:
            leaf = tree_leaves(params)[0]
            eps = torch.stack([_global_noise(
                generator, B * mesh.size, cfg.latent_size, leaf.dtype,
                leaf.device) for _ in range(T)])
        return use_gt, eps[:, rows]

    def _mean_over_ranks(stats):
        keys = sorted(stats)
        total = P.all_reduce_sum(mesh, torch.stack(
            [stats[k].to(torch.float32) for k in keys]).detach())
        return dict(zip(keys, (total / mesh.size).unbind()))

    def _update(state: TrainState, loss, stats):
        leaves = tree_leaves(state.params)
        with PR.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        with PR.span("train.optimizer"):
            stats = {k: v.detach() for k, v in stats.items()}
            stats["total_loss"] = loss.detach()
            if mesh is not None:
                grads = P.all_reduce_grad_mean(mesh, list(grads))
                stats = _mean_over_ranks(stats)
            stats["grad_norm"] = global_norm(grads)
            opt_state = opt.update(list(grads), state.opt_state,
                                   state.params)
        return TrainState(state.params, opt_state, state.step + 1), stats

    def supervised_step(state: TrainState, batch, epoch, eps=None,
                        generator=None):
        with PR.span("train.step"):
            eps = _sup_eps(state.params, batch, eps, generator)
            loss, stats = sup_loss(state.params, batch, epoch, eps=eps,
                                   generator=generator)
            return _update(state, loss, stats)

    def sched_samp_step(state: TrainState, batch, epoch, use_gt_p,
                        use_gt=None, eps=None, generator=None):
        with PR.span("train.step"):
            use_gt, eps = _ss_draws(state.params, batch, use_gt_p, use_gt,
                                    eps, generator)
            loss, stats = ss_loss(state.params, batch, epoch, use_gt_p,
                                  use_gt=use_gt, eps=eps,
                                  generator=generator)
            return _update(state, loss, stats)

    @torch.no_grad()
    def eval_step(params, batch, epoch, eps=None, generator=None):
        eps = _sup_eps(params, batch, eps, generator)
        loss, stats = sup_loss(params, batch, epoch, eps=eps,
                               generator=generator)
        stats = {**stats, "total_loss": loss}
        return stats if mesh is None else _mean_over_ranks(stats)

    return supervised_step, sched_samp_step, eval_step


def make_multi_steps(sup_step, ss_step, k: int):
    """(multi_sup, multi_ss): k steps over a chunk stacked along a new
    leading axis (stack_batches), the counterpart of the JAX package's
    lax.scan of k steps in one program.

      multi_sup(state, stacked, epoch, eps=None, generator=None)
      multi_ss(state, stacked, epoch, use_gt_p, use_gt=None, eps=None,
               generator=None)

    -> (state, stats) with every stat (k,), left on the device: nothing
    is read by the host inside a chunk. The k steps run in order on the
    chunk's slices and draw from `generator` in the order k calls of the
    single step do, so a chunk equals k single steps bit for bit; `eps`
    and `use_gt` with a leading k axis inject the draws, as the single
    steps take them. Under a mesh the chunk holds this rank's rows of
    each batch (shard_batch(..., batch_axis_index=1)).
    """

    def _run(step, state, stacked, draws, *extra, generator=None):
        n = tree_leaves(stacked)[0].shape[0]
        if n != k:
            raise ValueError(f"a chunk of {n} batches for k = {k}")
        stats = []
        for i in range(k):
            kw = {name: v[i] for name, v in draws.items() if v is not None}
            state, s = step(state, tree_map(lambda x: x[i], stacked),
                            *extra, generator=generator, **kw)
            stats.append(s)
        return state, {key: torch.stack([s[key] for s in stats])
                       for key in stats[0]}

    def multi_sup(state, stacked, epoch, eps=None, generator=None):
        return _run(sup_step, state, stacked, {"eps": eps}, epoch,
                    generator=generator)

    def multi_ss(state, stacked, epoch, use_gt_p, use_gt=None, eps=None,
                 generator=None):
        return _run(ss_step, state, stacked, {"use_gt": use_gt, "eps": eps},
                    epoch, use_gt_p, generator=generator)

    return multi_sup, multi_ss


def stack_batches(batches: List[Any]) -> Any:
    """Batches stacked along a new leading axis, on their device (the k
    axis of make_multi_steps)."""
    first = batches[0]
    if isinstance(first, dict):
        return {key: stack_batches([b[key] for b in batches])
                for key in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_batches([b[i] for b in batches])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(b) for b in batches])


def sched_samp_prob(epoch: int, start: int, end: int) -> float:
    """GT-input probability: 1 before `start`, linear to 0 at `end`, 0
    after."""
    if epoch < start:
        return 1.0
    if end <= start or epoch >= end:
        return 0.0
    return 1.0 - (epoch - start) / float(end - start)
