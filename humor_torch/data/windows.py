"""Windowed training pairs: world-frame motion -> per-step canonicalized
(input, output) pairs, and the window-global view (port of
humor_tpu/data/windows.py).

Each step t is canonicalized into the heading frame of state t; the
trans2joint offset comes once from frame 0 of the window and serves every
step, as in the rollout. One batched call does the whole window.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from humor_torch.models.canonical import FrameTransform, apply_world2local
from humor_torch.ops import transforms
from humor_torch.utils import profiling as PR


def window_trans2joint(world: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(..., 3) trans2joint from frame 0: -[joints0_xy - trans0_xy, 0]."""
    root_joint_xy = world["joints"][..., 0, :2] - world["trans"][..., 0, :2]
    return torch.cat([-root_joint_xy, torch.zeros_like(root_joint_xy[..., :1])],
                     dim=-1)


def step_frames(world: Dict[str, torch.Tensor],
                trans2joint: torch.Tensor) -> FrameTransform:
    """Heading frame of every step; components (..., T, D), trans2joint
    (..., 3) broadcast to every step."""
    R = world["root_orient"].reshape(*world["root_orient"].shape[:-1], 3, 3)
    tr = world["trans"]
    trans = torch.cat([-tr[..., :2], torch.zeros_like(tr[..., :1])], dim=-1)
    return FrameTransform(transforms.compute_world2aligned_mat(R), trans,
                          trans2joint[..., None, :].expand(trans.shape))


def _frames(frames: FrameTransform, sl: slice) -> FrameTransform:
    return FrameTransform(frames.rot[..., sl, :, :], frames.trans[..., sl, :],
                          frames.trans2joint[..., sl, :])


def window_to_pairs(world: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """world: typed components (..., T+1, D) with matrix rotations ->
    (data_in: state t in frame t, data_out: state t+1 in frame t,
    global_out: state t+1 in frame 0), each (..., T, D)."""
    with PR.span("data.pairs"):
        frames = step_frames(world, window_trans2joint(world))
        in_frames = _frames(frames, slice(None, -1))
        cur = {k: v[..., :-1, :] for k, v in world.items()}
        nxt = {k: v[..., 1:, :] for k, v in world.items()}
        return (apply_world2local(in_frames, cur),
                apply_world2local(in_frames, nxt),
                apply_world2local(_frames(frames, slice(0, 1)), nxt))


def window_to_pairs_multi(world: Dict[str, torch.Tensor], steps_in: int
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """Pairs with an S-frame past (steps_in = S): world components (...,
    F, D) -> (data_in (..., T, S, D): frames i..i+S-1 in frame i+S-1's
    heading frame, data_out (..., T, D): frame i+S in the same frame),
    T = F - S."""
    with PR.span("data.pairs"):
        frames = step_frames(world, window_trans2joint(world))
        S, F = steps_in, world["trans"].shape[-2]
        T = F - S
        anchor = _frames(frames, slice(S - 1, F - 1))
        win = {k: torch.stack([v[..., s: s + T, :] for s in range(S)],
                              dim=-2)
               for k, v in world.items()}
        nxt = {k: v[..., S:, :] for k, v in world.items()}
        anchor_w = FrameTransform(anchor.rot[..., :, None, :, :],
                                  anchor.trans[..., :, None, :],
                                  anchor.trans2joint[..., :, None, :])
        return (apply_world2local(anchor_w, win),
                apply_world2local(anchor, nxt))


def window_to_global(world: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """All frames canonicalized into frame 0's heading frame."""
    frames = step_frames(world, window_trans2joint(world))
    return apply_world2local(_frames(frames, slice(0, 1)), world)
