"""HuMoR transition CVAE (port of humor_tpu/models/humor.py).

    posterior  q(z | x_{t-1}, x_t)   4x1024 MLP -> (mu, var)
    cond prior p(z | x_{t-1})        4x1024 MLP -> (mu, var)
    decoder    x_t = f(z, x_{t-1})   1024,1024,512 MLP, z skip-connected to
                                     every layer; predicts residuals
                                     (additive for vectors, R_delta @ R_prev
                                     for rotations).

Only the configuration the released models use is supported: steps_in=1,
matrix input rotations, axis-angle output deltas, conditional prior. The
training forwards (`single_step`, `scheduled_sampling`) take every random
draw as an argument, or draw it from a torch.Generator when it is not
given: JAX's random streams cannot be reproduced in torch, so the tests
hand both packages the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from humor_torch.models import state as state_lib
from humor_torch.models.canonical import (
    FrameTransform,
    apply_world2local,
    frame_from_state,
)
from humor_torch.models.state import StateSpec, make_specs
from humor_torch.ops import transforms
from humor_torch.ops.mlp import init_mlp, mlp_apply

MLP_WIDTH = 1024


@dataclass(frozen=True)
class HumorConfig:
    in_rot_rep: str = "mat"
    out_rot_rep: str = "aa"
    latent_size: int = 48
    steps_in: int = 1
    conditional_prior: bool = True
    output_delta: bool = True
    model_data_config: str = "smpl+joints+contacts"
    # scheduled sampling feeds its own predictions back without gradient
    detach_sched_samp: bool = True

    def __post_init__(self):
        if (self.in_rot_rep, self.out_rot_rep, self.steps_in,
                self.conditional_prior, self.output_delta) != (
                    "mat", "aa", 1, True, True):
            raise NotImplementedError(
                "humor_torch supports the default HuMoR configuration only "
                "(mat in, aa out, steps_in=1, conditional prior, deltas)")

    @property
    def specs(self) -> Tuple[StateSpec, StateSpec, StateSpec, bool]:
        return make_specs(self.model_data_config, self.in_rot_rep,
                          self.out_rot_rep)

    @property
    def input_spec(self) -> StateSpec:
        return self.specs[0]

    @property
    def out_spec(self) -> StateSpec:
        return self.specs[1]

    @property
    def input_data_dim(self) -> int:
        return self.input_spec.total_dim

    @property
    def output_data_dim(self) -> int:
        return self.out_spec.total_dim


def init_params(cfg: HumorConfig, generator: torch.Generator,
                device="cpu") -> Dict:
    """Seeded random weights (same shapes as the JAX init)."""
    d_in, L = cfg.input_data_dim, cfg.latent_size
    return {
        "encoder": init_mlp([2 * d_in] + [MLP_WIDTH] * 4 + [L * 2],
                            generator, device=device),
        "decoder": init_mlp([d_in + L, MLP_WIDTH, MLP_WIDTH, 512,
                             cfg.output_data_dim], generator, skip_dim=L,
                            device=device),
        "prior": init_mlp([d_in] + [MLP_WIDTH] * 4 + [L * 2], generator,
                          device=device),
    }


def posterior(cfg: HumorConfig, params: Dict, past_in: torch.Tensor,
              t_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q(z | x_{t-1}, x_t): (mean, var)."""
    h = mlp_apply(params["encoder"], torch.cat([past_in, t_in], dim=-1))
    mean, logvar = torch.chunk(h, 2, dim=-1)
    return mean, torch.exp(logvar)


def prior(cfg: HumorConfig, params: Dict, past_in: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p(z | x_{t-1}): (mean, var)."""
    h = mlp_apply(params["prior"], past_in)
    mean, logvar = torch.chunk(h, 2, dim=-1)
    return mean, torch.exp(logvar)


def rsample(mean: torch.Tensor, var: torch.Tensor,
            eps: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mean + eps * sqrt(var); eps ~ N(0, 1) is drawn from `generator` (on
    the generator's device) when not given."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=generator.device if generator is not None
                          else mean.device).to(mean.device)
    return mean + eps * torch.sqrt(var)


def decode(cfg: HumorConfig, params: Dict, z: torch.Tensor,
           past_in: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(z, x_{t-1}) -> typed next state with matrix rotations (+ raw
    contact logits); the residual composition happens here."""
    raw = mlp_apply(params["decoder"], torch.cat([past_in, z], dim=-1),
                    skip_dim=cfg.latent_size)
    out_parts = cfg.out_spec.unpack(raw)
    in_parts = cfg.input_spec.unpack(past_in)
    batch_shape = past_in.shape[:-1]
    out: Dict[str, torch.Tensor] = {}
    for name in cfg.out_spec.names:
        val = out_parts[name]
        if name == "contacts":
            out[name] = val
            continue
        prev = in_parts[name]
        if state_lib.component(name).is_rotation:
            Rp = prev.reshape(*batch_shape, -1, 3, 3)
            Rd = transforms.aa_to_rotmat(val.reshape(*batch_shape, -1, 3))
            out[name] = transforms.rotmat_multiply(Rd, Rp).reshape(
                *batch_shape, -1)
        else:
            out[name] = val + prev
    return out


class StepOutput(NamedTuple):
    pred: Dict[str, torch.Tensor]          # typed next state (mat rots)
    posterior: Tuple[torch.Tensor, torch.Tensor]
    prior: Tuple[torch.Tensor, torch.Tensor]
    z: torch.Tensor


def single_step(cfg: HumorConfig, params: Dict, past_in: torch.Tensor,
                t_in: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> StepOutput:
    """Training forward: posterior sample (noise `eps`, else drawn from
    `generator`) -> decode."""
    qm, qv = posterior(cfg, params, past_in, t_in)
    pm, pv = prior(cfg, params, past_in)
    z = rsample(qm, qv, eps, generator)
    return StepOutput(decode(cfg, params, z, past_in), (qm, qv), (pm, pv), z)


def state_to_input(cfg: HumorConfig, state_mat: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """Typed state with matrix rotations -> flat network input."""
    return torch.cat([state_mat[n] for n in cfg.input_spec.names], dim=-1)


def _heading_frame(pred: Dict[str, torch.Tensor],
                   trans2joint: torch.Tensor) -> FrameTransform:
    root = pred["root_orient"]
    tr = pred["trans"]
    return FrameTransform(
        rot=transforms.compute_world2aligned_mat(
            root.reshape(*root.shape[:-1], 3, 3)),
        trans=torch.cat([-tr[..., :2], torch.zeros_like(tr[..., :1])],
                        dim=-1),
        trans2joint=trans2joint)


class RolloutResult(NamedTuple):
    world: Dict[str, torch.Tensor]   # each (B, T, D) in the global frame
    z: torch.Tensor                  # (B, T, latent)
    prior: Tuple[torch.Tensor, torch.Tensor]  # (B, T, latent) mean/var


def rollout(cfg: HumorConfig, params: Dict,
            init_state: Dict[str, torch.Tensor], num_steps: int,
            use_mean: bool = False,
            z_seq: Optional[torch.Tensor] = None,
            canonicalize_input: bool = False,
            uncanonicalize_output: bool = False,
            generator: Optional[torch.Generator] = None) -> RolloutResult:
    """Autoregressive generation from a typed initial state (matrix rots,
    components (B, D)), one Python step per frame. z comes from `z_seq`
    (B, T, latent), the prior mean (`use_mean`), or a prior sample drawn
    with `generator`. With `canonicalize_input` the initial state may sit
    in any world frame; `uncanonicalize_output` returns the trajectory
    in that frame."""
    B = init_state["trans"].shape[0]
    tr = init_state["trans"]
    if canonicalize_input:
        init_frame = frame_from_state(init_state)
        local = apply_world2local(init_frame, init_state)
    else:
        init_frame = FrameTransform.identity((B,), tr.dtype, tr.device)
        local = init_state
    local = {k: local[k] for k in cfg.input_spec.names}
    zeros1 = torch.zeros(B, 1, dtype=tr.dtype, device=tr.device)
    t2j = torch.cat([-local["joints"][:, :2], zeros1], dim=-1)
    if uncanonicalize_output and canonicalize_input:
        g_rot, g_trans = init_frame.rot, init_frame.trans
    else:
        g_rot = torch.eye(3, dtype=tr.dtype, device=tr.device).expand(
            B, 3, 3)
        g_trans = torch.zeros(B, 3, dtype=tr.dtype, device=tr.device)

    worlds, zs, pms, pvs = [], [], [], []
    for t in range(num_steps):
        past_in = state_to_input(cfg, local)
        pm, pv = prior(cfg, params, past_in)
        if z_seq is not None:
            z = z_seq[:, t]
        elif use_mean:
            z = pm
        else:
            z = rsample(pm, pv, generator=generator)
        pred = decode(cfg, params, z, past_in)
        world = apply_world2local(FrameTransform(g_rot, g_trans, t2j), pred,
                                  invert=True)
        step_frame = _heading_frame(pred, t2j)
        local = apply_world2local(
            step_frame, {k: pred[k] for k in cfg.input_spec.names})
        g_trans = torch.cat([-world["trans"][..., :2], zeros1], dim=-1)
        g_rot = torch.matmul(g_rot, step_frame.rot)
        worlds.append(world)
        zs.append(z)
        pms.append(pm)
        pvs.append(pv)

    world_bt = {k: torch.stack([w[k] for w in worlds], dim=1)
                for k in worlds[0]}
    return RolloutResult(world=world_bt, z=torch.stack(zs, dim=1),
                         prior=(torch.stack(pms, dim=1),
                                torch.stack(pvs, dim=1)))


class InferResult(NamedTuple):
    prior: Tuple[torch.Tensor, torch.Tensor]      # (B, T-1, latent)
    posterior: Tuple[torch.Tensor, torch.Tensor]  # (B, T-1, latent)


def infer_global_seq(cfg: HumorConfig, params: Dict,
                     global_seq: Dict[str, torch.Tensor]) -> InferResult:
    """Per-transition prior/posterior over a world-frame sequence
    (components (B, T, D), matrix rotations): each pair (x_t, x_{t+1}) is
    canonicalized into x_t's heading frame. All T-1 transitions run as
    one batch."""
    B, T = global_seq["trans"].shape[:2]
    tr = global_seq["trans"]
    zeros1 = torch.zeros(B, 1, dtype=tr.dtype, device=tr.device)
    root_xy = global_seq["joints"][:, 0, :2] - tr[:, 0, :2]
    t2j = torch.cat([-root_xy, zeros1], dim=-1)        # (B, 3)
    names = list(cfg.input_spec.names)
    past = {k: global_seq[k][:, :-1] for k in names}   # (B, T-1, D)
    nxt = {k: global_seq[k][:, 1:] for k in names}
    frame = frame_from_state(past, trans2joint=t2j[:, None].expand(
        B, T - 1, 3))
    past_in = state_to_input(cfg, apply_world2local(frame, past))
    t_in = state_to_input(cfg, apply_world2local(frame, nxt))
    qm, qv = posterior(cfg, params, past_in, t_in)
    pm, pv = prior(cfg, params, past_in)
    return InferResult(prior=(pm, pv), posterior=(qm, qv))


class SchedSampOutput(NamedTuple):
    pred: Dict[str, torch.Tensor]                 # local-frame (B, T, D)
    posterior: Tuple[torch.Tensor, torch.Tensor]  # (B, T, latent)
    prior: Tuple[torch.Tensor, torch.Tensor]


def scheduled_sampling(cfg: HumorConfig, params: Dict,
                       x_past_seq: torch.Tensor, x_t_seq: torch.Tensor,
                       init_state: Dict[str, torch.Tensor], use_gt_p: float,
                       smpl_joint_fn=None, use_gt=None,
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> SchedSampOutput:
    """Teacher-forcing curriculum over T steps: step t takes the GT input
    x_past_seq[:, t] where use_gt[t], else the model's own previous
    prediction re-canonicalized into its heading frame (detached with
    cfg.detach_sched_samp). x_past_seq, x_t_seq (B, T, D_in) are GT
    canonical inputs/outputs, init_state typed (B, D) matrix rotations.

    use_gt: (T,) booleans, one draw shared by the batch (step 0 always
    takes GT); drawn as uniform(generator) < use_gt_p when not given.
    eps: (T, B, latent) posterior noise, else drawn from `generator`.
    `smpl_joint_fn(trans, root_orient_mat, pose_body_mat) -> (B, 66)` is
    HuMoR-Qual training: the fed-back joints come from an SMPL forward
    while the loss still sees the regressed joints."""
    B, T, _ = x_past_seq.shape
    if use_gt is None:
        draw = torch.rand(T, generator=generator,
                          device=generator.device if generator is not None
                          else "cpu")
        use_gt = draw < use_gt_p
    use_gt = [bool(u) for u in torch.as_tensor(use_gt).tolist()]
    use_gt[0] = True
    zeros1 = torch.zeros(B, 1, dtype=x_past_seq.dtype,
                         device=x_past_seq.device)
    t2j = torch.cat([-init_state["joints"][:, :2], zeros1], dim=-1)
    local = {k: init_state[k] for k in cfg.input_spec.names}
    outs = []
    for t in range(T):
        past_in = (x_past_seq[:, t] if use_gt[t]
                   else state_to_input(cfg, local))
        out = single_step(cfg, params, past_in, x_t_seq[:, t],
                          eps=None if eps is None else eps[t],
                          generator=generator)
        outs.append(out)
        if t == T - 1:
            break
        fed = out.pred
        if cfg.detach_sched_samp:
            fed = {k: v.detach() for k, v in fed.items()}
        if smpl_joint_fn is not None and "joints" in fed:
            fed = dict(fed)
            with torch.set_grad_enabled(not cfg.detach_sched_samp
                                        and torch.is_grad_enabled()):
                fed["joints"] = smpl_joint_fn(
                    fed["trans"], fed["root_orient"], fed["pose_body"])
        local = apply_world2local(
            _heading_frame(fed, t2j),
            {k: fed[k] for k in cfg.input_spec.names})

    stack = lambda xs: torch.stack(xs, dim=1)
    return SchedSampOutput(
        pred={k: stack([o.pred[k] for o in outs]) for k in outs[0].pred},
        posterior=(stack([o.posterior[0] for o in outs]),
                   stack([o.posterior[1] for o in outs])),
        prior=(stack([o.prior[0] for o in outs]),
               stack([o.prior[1] for o in outs])))
