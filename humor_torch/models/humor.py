"""HuMoR transition CVAE (port of humor_tpu/models/humor.py).

    posterior  q(z | x_{t-1}, x_t)   4x1024 MLP -> (mu, var)
    cond prior p(z | x_{t-1})        4x1024 MLP -> (mu, var)
    decoder    x_t = f(z, x_{t-1})   1024,1024,512 MLP, z skip-connected to
                                     every layer; predicts residuals
                                     (additive for vectors, R_delta @ R_prev
                                     for rotations).

Every configuration of the JAX module: input rotations as matrices, aa
or 6d; outputs as aa, 6d or 9d, residual or absolute; an S-frame past
window (steps_in = S); a conditional or standard-normal prior; the three
state configurations of models.state. The released models use the
default (mat in, aa deltas out, S = 1, conditional prior). The
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
from humor_torch.ops.mlp import init_mlp, mlp_apply, resolve_compute_dtype
from humor_torch.utils import profiling as PR

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
    # the MLPs' products: None = f32, "bfloat16" = bf16 inputs with f32
    # accumulation and outputs (ops.mlp); geometry, canonicalization and
    # the rest stay f32
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.in_rot_rep not in state_lib.IN_ROT_REPS:
            raise ValueError(f"in_rot_rep {self.in_rot_rep!r} not in "
                             f"{state_lib.IN_ROT_REPS}")
        if self.out_rot_rep not in state_lib.OUT_ROT_REPS:
            raise ValueError(f"out_rot_rep {self.out_rot_rep!r} not in "
                             f"{state_lib.OUT_ROT_REPS}")
        if self.model_data_config not in state_lib.RETURN_CONFIGS:
            raise ValueError(
                f"model_data_config {self.model_data_config!r} not in "
                f"{tuple(state_lib.RETURN_CONFIGS)}")
        if self.steps_in < 1:
            raise ValueError(f"steps_in {self.steps_in} < 1")
        resolve_compute_dtype(self.compute_dtype)

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
    def mat_spec(self) -> StateSpec:
        return self.specs[2]

    @property
    def pred_contacts(self) -> bool:
        return self.specs[3]

    @property
    def input_data_dim(self) -> int:
        return self.input_spec.total_dim

    @property
    def past_data_dim(self) -> int:
        return self.steps_in * self.input_data_dim

    @property
    def output_data_dim(self) -> int:
        return self.out_spec.total_dim

    @property
    def need_trans2joint(self) -> bool:
        return ("joints" in self.input_spec.names
                or "verts" in self.input_spec.names)


def init_params(cfg: HumorConfig, generator: torch.Generator,
                device="cpu") -> Dict:
    """Seeded random weights (same shapes as the JAX init; no "prior"
    when the prior is the standard normal)."""
    d_past, L = cfg.past_data_dim, cfg.latent_size
    params = {
        "encoder": init_mlp([d_past + cfg.input_data_dim] + [MLP_WIDTH] * 4
                            + [L * 2], generator, device=device),
        "decoder": init_mlp([d_past + L, MLP_WIDTH, MLP_WIDTH, 512,
                             cfg.output_data_dim], generator, skip_dim=L,
                            device=device),
    }
    if cfg.conditional_prior:
        params["prior"] = init_mlp([d_past] + [MLP_WIDTH] * 4 + [L * 2],
                                   generator, device=device)
    return params


def posterior(cfg: HumorConfig, params: Dict, past_in: torch.Tensor,
              t_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q(z | x_{t-1}, x_t): (mean, var)."""
    h = mlp_apply(params["encoder"], torch.cat([past_in, t_in], dim=-1),
                  compute_dtype=cfg.compute_dtype)
    mean, logvar = torch.chunk(h, 2, dim=-1)
    return mean, torch.exp(logvar)


def prior(cfg: HumorConfig, params: Dict, past_in: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p(z | x_{t-1}): (mean, var); the standard normal when the prior is
    not conditional."""
    if not cfg.conditional_prior:
        shape = (*past_in.shape[:-1], cfg.latent_size)
        return (torch.zeros(shape, dtype=past_in.dtype, device=past_in.device),
                torch.ones(shape, dtype=past_in.dtype, device=past_in.device))
    h = mlp_apply(params["prior"], past_in, compute_dtype=cfg.compute_dtype)
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
    """(z, past window) -> typed next state with matrix rotations (+ raw
    contact logits). With output_delta the outputs are residuals on the
    newest past frame (R_delta @ R_prev for rotations), else absolute."""
    raw = mlp_apply(params["decoder"], torch.cat([past_in, z], dim=-1),
                    skip_dim=cfg.latent_size, compute_dtype=cfg.compute_dtype)
    out_parts = cfg.out_spec.unpack(raw)
    batch_shape = past_in.shape[:-1]
    newest = past_in[..., (cfg.steps_in - 1) * cfg.input_data_dim:]
    in_parts = cfg.input_spec.unpack(newest)
    out: Dict[str, torch.Tensor] = {}
    for name in cfg.out_spec.names:
        val = out_parts[name]
        if name == "contacts":
            out[name] = val
            continue
        rot = state_lib.component(name).is_rotation
        if rot:
            val = transforms.convert_to_rotmat(val, cfg.out_rot_rep)
        if not cfg.output_delta:
            out[name] = val
        elif rot:
            Rp = transforms.convert_to_rotmat(in_parts[name], cfg.in_rot_rep)
            out[name] = transforms.rotmat_multiply(
                val.reshape(*batch_shape, -1, 3, 3),
                Rp.reshape(*batch_shape, -1, 3, 3)).reshape(*batch_shape, -1)
        else:
            out[name] = val + in_parts[name]
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
    """Typed state with matrix rotations -> flat network input, its
    rotations in cfg.in_rot_rep (6d: the first 6 entries of each
    row-major matrix, as the JAX module and the reference slice it)."""
    parts = []
    for name in cfg.input_spec.names:
        val = state_mat[name]
        if state_lib.component(name).is_rotation and cfg.in_rot_rep != "mat":
            batch_shape = val.shape[:-1]
            if cfg.in_rot_rep == "aa":
                val = transforms.rotmat_to_aa(
                    val.reshape(*batch_shape, -1, 3, 3))
            else:
                val = val.reshape(*batch_shape, -1, 9)[..., :6]
            val = val.reshape(*batch_shape, -1)
        parts.append(val)
    return torch.cat(parts, dim=-1)


def state_to_input_window(cfg: HumorConfig,
                          window: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Typed past window (components (..., S, D), matrix rotations) ->
    frame-major network input (..., S * D_in)."""
    flat = state_to_input(cfg, window)
    return flat.reshape(*flat.shape[:-2], -1)


def _as_window(cfg: HumorConfig, state: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """An initial state as a window (B, S, D): (B, D) is taken when
    steps_in is 1."""
    if state["trans"].dim() == 2:
        if cfg.steps_in != 1:
            raise ValueError(
                f"steps_in={cfg.steps_in} needs (B, {cfg.steps_in}, D) "
                "initial states")
        return {k: v[:, None] for k, v in state.items()}
    return dict(state)


def _expand_frame(frame: FrameTransform) -> FrameTransform:
    """(B, ...) frame -> (B, 1, ...), to move a whole (B, S, D) window."""
    return FrameTransform(frame.rot[:, None], frame.trans[:, None],
                          frame.trans2joint[:, None])


def _trans2joint(cfg: HumorConfig, local: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """(B, 3) trans2joint of the newest frame of a canonical window."""
    tr = local["trans"]
    if not cfg.need_trans2joint:
        return torch.zeros(tr.shape[0], 3, dtype=tr.dtype, device=tr.device)
    j = local["joints"][:, -1]
    return torch.cat([-j[:, :2], torch.zeros_like(j[:, :1])], dim=-1)


def _slide(cfg: HumorConfig, window: Dict[str, torch.Tensor],
           fed: Dict[str, torch.Tensor], frame: FrameTransform
           ) -> Dict[str, torch.Tensor]:
    """Drop the oldest frame, append the fed-back prediction and move the
    whole window into the prediction's heading frame."""
    slid = {k: torch.cat([window[k][:, 1:], fed[k][:, None]], dim=1)
            for k in cfg.input_spec.names}
    return apply_world2local(_expand_frame(frame), slid)


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
            generator: Optional[torch.Generator] = None,
            eps: Optional[torch.Tensor] = None,
            smpl_joint_fn=None) -> RolloutResult:
    """Autoregressive generation from a typed initial state (matrix rots,
    components (B, D), or (B, S, D) windows at steps_in = S), one Python
    step per frame; each step slides the window and moves all S frames
    into the new heading frame. z comes from `z_seq`
    (B, T, latent), the prior mean (`use_mean`), or a prior sample with
    the standard-normal noise `eps` (B, T, latent), else drawn with
    `generator`. With `canonicalize_input` the initial state may sit in
    any world frame; `uncanonicalize_output` returns the trajectory in
    that frame.

    `smpl_joint_fn(trans (B, 3), root_orient_mat (B, 9), pose_body_mat
    (B, 21*9)) -> joints (B, 66)` is HuMoR-Qual: the joints fed back into
    the next step come from an SMPL forward on the predicted state, while
    the returned trajectory keeps the decoder's regressed joints."""
    state0 = _as_window(cfg, init_state)
    B = state0["trans"].shape[0]
    tr = state0["trans"]
    if canonicalize_input:
        init_frame = frame_from_state({k: v[:, -1]
                                       for k, v in state0.items()})
        local = apply_world2local(_expand_frame(init_frame), state0)
    else:
        init_frame = FrameTransform.identity((B,), tr.dtype, tr.device)
        local = state0
    local = {k: local[k] for k in cfg.input_spec.names}
    zeros1 = torch.zeros(B, 1, dtype=tr.dtype, device=tr.device)
    t2j = _trans2joint(cfg, local)
    if uncanonicalize_output and canonicalize_input:
        g_rot, g_trans = init_frame.rot, init_frame.trans
    else:
        g_rot = torch.eye(3, dtype=tr.dtype, device=tr.device).expand(
            B, 3, 3)
        g_trans = torch.zeros(B, 3, dtype=tr.dtype, device=tr.device)

    worlds, zs, pms, pvs = [], [], [], []
    for t in range(num_steps):
        past_in = state_to_input_window(cfg, local)
        pm, pv = prior(cfg, params, past_in)
        if z_seq is not None:
            z = z_seq[:, t]
        elif use_mean:
            z = pm
        else:
            z = rsample(pm, pv, None if eps is None else eps[:, t],
                        generator)
        pred = decode(cfg, params, z, past_in)
        world = apply_world2local(FrameTransform(g_rot, g_trans, t2j), pred,
                                  invert=True)
        fed = pred
        if smpl_joint_fn is not None and "joints" in pred:
            fed = dict(pred)
            fed["joints"] = smpl_joint_fn(
                pred["trans"], pred["root_orient"], pred["pose_body"])
        step_frame = _heading_frame(fed, t2j)
        local = _slide(cfg, local, fed, step_frame)
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
    prior: Tuple[torch.Tensor, torch.Tensor]      # (B, T-S, latent)
    posterior: Tuple[torch.Tensor, torch.Tensor]  # (B, T-S, latent)


def infer_global_seq(cfg: HumorConfig, params: Dict,
                     global_seq: Dict[str, torch.Tensor]) -> InferResult:
    """Per-transition prior/posterior over a world-frame sequence
    (components (B, T, D), matrix rotations): each transition's past is
    the S-frame window ending at t, canonicalized into x_t's heading
    frame with x_{t+1}; the T - S transitions run as one batch."""
    S = cfg.steps_in
    B, T = global_seq["trans"].shape[:2]
    tr = global_seq["trans"]
    n = T - S
    if cfg.need_trans2joint:
        root_xy = global_seq["joints"][:, 0, :2] - tr[:, 0, :2]
        t2j = torch.cat([-root_xy, torch.zeros_like(root_xy[:, :1])], dim=-1)
    else:
        t2j = torch.zeros(B, 3, dtype=tr.dtype, device=tr.device)
    names = list(cfg.input_spec.names)
    past = {k: torch.stack([global_seq[k][:, s: s + n] for s in range(S)],
                           dim=2) for k in names}      # (B, n, S, D)
    nxt = {k: global_seq[k][:, S:] for k in names}     # (B, n, D)
    frame = frame_from_state({k: v[:, :, -1] for k, v in past.items()},
                             trans2joint=t2j[:, None].expand(B, n, 3))
    wframe = FrameTransform(frame.rot[:, :, None], frame.trans[:, :, None],
                            frame.trans2joint[:, :, None])
    past_in = state_to_input_window(cfg, apply_world2local(wframe, past))
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
    cfg.detach_sched_samp). x_past_seq (B, T, S*D_in) and x_t_seq (B, T,
    D_in) are GT canonical inputs/outputs, init_state typed (B, D) (or
    (B, S, D) windows at steps_in = S) matrix rotations.

    use_gt: (T,) booleans, one draw shared by the batch (step 0 always
    takes GT); drawn as uniform(generator) < use_gt_p when not given.
    The choice is made on the device: every step after the first
    computes the fed-back input and a `where` on use_gt[t] picks it or
    the GT one, so the host never reads the draw and one program serves
    every draw (the values are the branch's own; with detach_sched_samp
    off, the input not picked gets exactly zero gradient).
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
    use_gt = torch.as_tensor(use_gt).to(device=x_past_seq.device,
                                        dtype=torch.bool)
    local = {k: v for k, v in _as_window(cfg, init_state).items()
             if k in cfg.input_spec.names}
    t2j = _trans2joint(cfg, local)
    outs = []
    for t in range(T):
        past_in = x_past_seq[:, t] if t == 0 else torch.where(
            use_gt[t], x_past_seq[:, t], state_to_input_window(cfg, local))
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
                                        and torch.is_grad_enabled()), \
                    PR.span("train.smpl_feedback"):
                fed["joints"] = smpl_joint_fn(
                    fed["trans"], fed["root_orient"], fed["pose_body"])
        local = _slide(cfg, local, fed, _heading_frame(fed, t2j))

    stack = lambda xs: torch.stack(xs, dim=1)
    return SchedSampOutput(
        pred={k: stack([o.pred[k] for o in outs]) for k in outs[0].pred},
        posterior=(stack([o.posterior[0] for o in outs]),
                   stack([o.posterior[1] for o in outs])),
        prior=(stack([o.prior[0] for o in outs]),
               stack([o.prior[1] for o in outs])))
