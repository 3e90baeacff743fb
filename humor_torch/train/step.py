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

`make_multi_steps` runs the steps of a chunk of up to k batches stacked
along a new leading axis (`stack_batches`), as the JAX package scans them
in one program, and on one card replays one captured CUDA graph a step;
its stats stay on the device, so the trainer reads a chunk's stats once.
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
    on the params' device and updated in place, so a step never waits for
    the host and a captured step replays on its own outputs. The bias
    corrections and the rate are in the params' dtype (float32 as in the
    JAX package; float64 as optax computes under x64), made by device-side
    fills."""

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
        v = torch.full((), self.lr, dtype=dtype, device=count.device)
        for boundary, scale in sorted(self.boundaries):
            v = torch.where(count >= boundary, v * scale, v)
        return v

    def _biases(self, count_inc, dtype) -> Tuple[torch.Tensor, ...]:
        """The bias corrections `_step` divides by, made once a step."""
        raise NotImplementedError

    def _step(self, g, mu, nu, biases):
        """-> (new mu, new nu, the direction the rate scales)."""
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: Any) -> Dict[str, Any]:
        """Apply one step to the leaves of `params` and to `state`'s
        tensors, in place (grads in tree_leaves order); returns `state`."""
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
        biases = self._biases(count_inc, dtype)
        mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        for p, g, mu, nu in zip(leaves, grads, mus, nus):
            mu_new, nu_new, direction = self._step(g, mu, nu, biases)
            upd = step_size * direction
            p.copy_(torch.where(ok, p + upd, p))
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
        total = state["total_notfinite"]
        for name, value in (
                ("count", torch.where(ok, count_inc, count)),
                ("notfinite_count", notfinite), ("last_finite", finite),
                ("total_notfinite", torch.where(finite, total, total + 1))):
            state[name].copy_(value)
        return state


def _bias(decay: float, count_inc: torch.Tensor, dtype) -> torch.Tensor:
    """optax's bias correction 1 - decay^count."""
    return 1.0 - torch.full((), decay, dtype=dtype,
                            device=count_inc.device) ** count_inc


class Adamax(_Optimizer):
    """optax.adamax:

        mu  = (1 - b1) g + b1 mu
        nu  = max(|g| + eps, b2 nu)
        p  -= lr(count) * (mu / (1 - b1^(count+1))) / nu

    (optax 0.2.6 adds eps inside the max, as torch.optim.Adamax does; the
    two differ in where the bias correction and the rate are applied.)"""

    def _biases(self, count_inc, dtype):
        return (_bias(self.b1, count_inc, dtype),)

    def _step(self, g, mu, nu, biases):
        mu_new = (1.0 - self.b1) * g + self.b1 * mu
        nu_new = torch.maximum(torch.abs(g) + self.eps, self.b2 * nu)
        return mu_new, nu_new, (mu_new / biases[0]) / nu_new


class Adam(_Optimizer):
    """optax.adam (eps_root 0):

        mu  = (1 - b1) g + b1 mu
        nu  = (1 - b2) g^2 + b2 nu
        p  -= lr(count) * mu_hat / (sqrt(nu_hat) + eps)

    with mu_hat = mu / (1 - b1^(count+1)), nu_hat = nu / (1 - b2^(count+1))
    (eps outside the root)."""

    def _biases(self, count_inc, dtype):
        return (_bias(self.b1, count_inc, dtype),
                _bias(self.b2, count_inc, dtype))

    def _step(self, g, mu, nu, biases):
        mu_new = (1.0 - self.b1) * g + self.b1 * mu
        nu_new = (1.0 - self.b2) * g ** 2 + self.b2 * nu
        mu_hat = mu_new / biases[0]
        nu_hat = nu_new / biases[1]
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


def step_draws(cfg: H.HumorConfig, kind: str, batch, names,
               generator: Optional[torch.Generator], like: torch.Tensor,
               use_gt_p: float = 1.0, world: int = 1
               ) -> Dict[str, torch.Tensor]:
    """The draws among `names` that one step of `kind` ("sup" or "ss")
    makes from `generator` on a global batch of `world` times `batch`'s
    B rows, in the order the model draws them: scheduled sampling's (T,)
    curriculum choice (uniform < use_gt_p), then the posterior noise,
    (world B T, latent) over the supervised step's flattened rows or
    (T, world B, latent), a frame at a time, over the rollout's. The
    noise takes `like`'s dtype and device."""
    B, T = batch["data_in"]["trans"].shape[:2]
    out = {}
    if "use_gt" in names:
        out["use_gt"] = torch.rand(
            T, generator=generator,
            device=generator.device if generator is not None
            else "cpu") < use_gt_p
    if "eps" in names:
        noise = lambda rows: _global_noise(       # noqa: E731
            generator, rows, cfg.latent_size, like.dtype, like.device)
        out["eps"] = (noise(world * B * T) if kind == "sup" else
                      torch.stack([noise(world * B) for _ in range(T)]))
    return out


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
    of the generator, by step_draws as the single-rank step draws them,
    and keeps its own rows; `eps` and `use_gt`, when given, are the global
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

    def _draws(kind, params, batch, given, generator, use_gt_p=1.0):
        """`given` (global draws, None where not given) completed by
        step_draws and cut to this rank's rows."""
        missing = [name for name, v in given.items() if v is None]
        draws = {**given, **step_draws(
            cfg, kind, batch, missing, generator, tree_leaves(params)[0],
            use_gt_p, 1 if mesh is None else mesh.size)}
        if mesh is not None:
            B, T = batch["data_in"]["trans"].shape[:2]
            rows = P.local_rows(mesh, B * mesh.size)
            eps = draws["eps"]
            draws["eps"] = (eps[rows.start * T:rows.stop * T]
                            if kind == "sup" else eps[:, rows])
        return draws

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
            eps = _draws("sup", state.params, batch, {"eps": eps},
                         generator)["eps"]
            loss, stats = sup_loss(state.params, batch, epoch, eps=eps)
            return _update(state, loss, stats)

    def sched_samp_step(state: TrainState, batch, epoch, use_gt_p,
                        use_gt=None, eps=None, generator=None):
        with PR.span("train.step"):
            draws = _draws("ss", state.params, batch,
                           {"use_gt": use_gt, "eps": eps}, generator,
                           use_gt_p)
            loss, stats = ss_loss(state.params, batch, epoch, use_gt_p,
                                  **draws)
            return _update(state, loss, stats)

    @torch.no_grad()
    def eval_step(params, batch, epoch, eps=None, generator=None):
        eps = _draws("sup", params, batch, {"eps": eps}, generator)["eps"]
        loss, stats = sup_loss(params, batch, epoch, eps=eps)
        stats = {**stats, "total_loss": loss}
        return stats if mesh is None else _mean_over_ranks(stats)

    supervised_step.cfg = sched_samp_step.cfg = cfg
    supervised_step.mesh = sched_samp_step.mesh = mesh
    return supervised_step, sched_samp_step, eval_step


def _step_signature(chunk: Any) -> Tuple:
    """One step's shapes, dtypes and devices: a chunk's, less its leading
    axis."""
    return tuple((tuple(x.shape[1:]), x.dtype, x.device)
                 for x in tree_leaves(chunk))


def make_multi_steps(sup_step, ss_step, k: int):
    """(multi_sup, multi_ss): the steps of a chunk of 1 to k batches
    stacked along a new leading axis (stack_batches), the counterpart of
    the JAX package's lax.scan of k steps in one program.

      multi_sup(state, stacked, epoch, eps=None, generator=None)
      multi_ss(state, stacked, epoch, use_gt_p, use_gt=None, eps=None,
               generator=None)

    -> (state, stats) with every stat (n,) for a chunk of n, left on the
    device: nothing is read by the host inside a chunk. The n steps run
    in order on the chunk's slices and draw from `generator` in the order
    n calls of the single step do, so a chunk equals n single steps bit
    for bit; `eps` and `use_gt` with a leading n axis inject the draws,
    as the single steps take them. Under a mesh the chunk holds this
    rank's rows of each batch (shard_batch(..., batch_axis_index=1)).

    A step on CUDA leaves that names no mesh (its `mesh` attribute, set
    by make_train_steps; a wrapper that names none is taken as
    single-rank) runs as the replay of one captured CUDA graph: the
    forward, the ELBO, the gradient and the optimizer, with the same
    kernels in the same order, dispatched by the card instead of the
    host. The chunk copies each slice, its draws and the epoch into the
    graph's static inputs and replays; draws not given are drawn from
    `generator` outside the graph by step_draws, with the step's `cfg`,
    as the eager steps draw them. The first chunk on a state (or at new
    shapes) runs its first step eagerly, on the stream the capture uses,
    as the warm-up, captures the step and replays it for the rest: every
    chunk is n real steps. One captured step is kept, keyed by the
    state's tensors and one step's kind, shapes and dtypes, so chunks of
    every length replay it; a step with another key captures anew. On
    the CPU and under a mesh the steps run eagerly. Counters
    (utils/profiling): "train.graph_captures", "train.graph_replays",
    "train.eager_steps"; spans inside the step are recorded at its
    capture, and each replay is a "train.graph_replay" span.
    """
    captured: Dict[str, Any] = {}   # the one captured step's record

    def _graphable(step, state) -> bool:
        return (tree_leaves(state.params)[0].is_cuda
                and getattr(step, "mesh", None) is None)

    def _eager(step, state, stacked, n, draws, extra, generator):
        PR.count("train.eager_steps", n)
        stats = []
        for i in range(n):
            kw = {name: v[i] for name, v in draws.items() if v is not None}
            state, s = step(state, tree_map(lambda x: x[i], stacked),
                            *extra, generator=generator, **kw)
            stats.append(s)
        return state, {key: torch.stack([s[key] for s in stats])
                       for key in stats[0]}

    def _chunk_draws(kind, step, state, stacked, n, draws, extra,
                     generator):
        """Every draw of the chunk on the params' device, (n, ...) each,
        those not given drawn step by step as the eager steps draw."""
        leaf = tree_leaves(state.params)[0]
        missing = [name for name, v in draws.items() if v is None]
        if missing:
            made = [step_draws(step.cfg, kind,
                               tree_map(lambda x: x[i], stacked), missing,
                               generator, leaf, *extra[1:])
                    for i in range(n)]
            draws = {**draws, **{name: torch.stack([m[name] for m in made])
                                 for name in missing}}
        return {name: torch.as_tensor(v).to(leaf.device)
                for name, v in sorted(draws.items())}

    def _capture(step, state, stacked, draws, extra):
        """Step 0 eagerly on the capture stream (the warm-up), then the
        capture of the step on the static inputs; -> (the captured step's
        record, step 0's stats)."""
        dev = tree_leaves(state.params)[0].device
        main = torch.cuda.current_stream(dev)
        static = {"batch": tree_map(lambda x: torch.empty_like(x[0]),
                                    stacked),
                  "draws": {n: torch.empty_like(v[0])
                            for n, v in draws.items()},
                  "epoch": torch.empty((), dtype=torch.float32, device=dev)}
        rec = {"static": static}
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _load(rec, stacked, draws, extra[0], 0)
            PR.count("train.eager_steps")
            _, stats = step(state, static["batch"], static["epoch"],
                            *extra[1:], **static["draws"])
            rec["keys"] = list(stats)
            rec["dtypes"] = [stats[key].dtype for key in rec["keys"]]
            first = torch.stack([stats[key] for key in rec["keys"]])
        main.wait_stream(side)
        first.record_stream(main)
        owned = [id(x) for x in tree_leaves(state[:2])]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            new_state, stats = step(state, static["batch"], static["epoch"],
                                    *extra[1:], **static["draws"])
            rec["stats"] = torch.stack([stats[key] for key in rec["keys"]])
        if [id(x) for x in tree_leaves(new_state[:2])] != owned:
            raise RuntimeError("a captured train step must update its "
                               "state's own tensors in place")
        PR.count("train.graph_captures")
        rec["graph"] = graph
        return rec, first

    def _load(rec, stacked, draws, epoch, i):
        """Slice i of the chunk, its draws and the epoch into the static
        inputs."""
        static = rec["static"]
        for dst, src in zip(tree_leaves(static["batch"]),
                            tree_leaves(stacked)):
            dst.copy_(src[i])
        for name, dst in static["draws"].items():
            dst.copy_(draws[name][i])
        static["epoch"].fill_(float(epoch))

    def _graphed(kind, step, state, stacked, n, draws, extra, generator):
        draws = _chunk_draws(kind, step, state, stacked, n, draws, extra,
                             generator)
        key = (kind, _step_signature(stacked), _step_signature(draws),
               tuple(x.data_ptr() for x in tree_leaves(state[:2])))
        rec, cols = captured.get("step"), []
        if rec is None or rec["key"] != key:
            # drop the previous graph, and its memory pool, before capturing
            rec = None
            captured.clear()
            rec, first = _capture(step, state, stacked, draws, extra)
            rec["key"] = key
            captured["step"] = rec
            cols.append(first)
        for i in range(len(cols), n):
            _load(rec, stacked, draws, extra[0], i)
            with PR.span("train.graph_replay"):
                rec["graph"].replay()
            PR.count("train.graph_replays")
            cols.append(rec["stats"].clone())
        rows = torch.stack(cols, dim=1).unbind(0)
        return (TrainState(state.params, state.opt_state, state.step + n),
                {key: row.to(dtype) for key, dtype, row in
                 zip(rec["keys"], rec["dtypes"], rows)})

    def _run(kind, step, state, stacked, draws, *extra, generator=None):
        n = tree_leaves(stacked)[0].shape[0]
        if not 1 <= n <= k:
            raise ValueError(f"a chunk of {n} batches: a chunk holds 1 to "
                             f"k = {k}")
        if _graphable(step, state):
            return _graphed(kind, step, state, stacked, n, draws, extra,
                            generator)
        return _eager(step, state, stacked, n, draws, extra, generator)

    def multi_sup(state, stacked, epoch, eps=None, generator=None):
        return _run("sup", sup_step, state, stacked, {"eps": eps}, epoch,
                    generator=generator)

    def multi_ss(state, stacked, epoch, use_gt_p, use_gt=None, eps=None,
                 generator=None):
        return _run("ss", ss_step, state, stacked,
                    {"use_gt": use_gt, "eps": eps}, epoch, use_gt_p,
                    generator=generator)

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
