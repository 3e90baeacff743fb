"""Motion-state specification: which components make up the model state,
their sizes per rotation representation, and packing to/from the flat
network vectors (port of humor_tpu/models/state.py).

A state is a dict[str, Tensor] with arbitrary leading batch dims; the
spec is static Python metadata.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import torch

from humor_torch.body_model.constants import (
    NUM_BODY_JOINTS,
    NUM_CONTACTS,
    NUM_KEYPT_VERTS,
    NUM_SMPL_JOINTS,
)

ROT_REP_SIZE = {"aa": 3, "6d": 6, "mat": 9, "9d": 9}
IN_ROT_REPS = ("aa", "6d", "mat")
OUT_ROT_REPS = ("aa", "6d", "9d")


class Kind(enum.Enum):
    """How a component transforms under a world->local change of frame."""

    POINT = "point"             # translate then rotate (trans)
    OFFSET_POINT = "offset_pt"  # translate about trans2joint, rotate (joints)
    VECTOR = "vector"           # rotate only (velocities)
    ROTATION = "rotation"       # left-multiply (root_orient)
    LOCAL = "local"             # invariant (pose_body, contacts)


@dataclass(frozen=True)
class Component:
    name: str
    kind: Kind
    count: int
    is_rotation: bool = False
    is_scalar: bool = False

    def dim(self, rot_rep_size: int = 9) -> int:
        if self.is_rotation:
            return self.count * rot_rep_size
        if self.is_scalar:
            return self.count
        return self.count * 3


_COMPONENTS = {
    "trans": Component("trans", Kind.POINT, 1),
    "trans_vel": Component("trans_vel", Kind.VECTOR, 1),
    "root_orient": Component("root_orient", Kind.ROTATION, 1, is_rotation=True),
    "root_orient_vel": Component("root_orient_vel", Kind.VECTOR, 1),
    "pose_body": Component("pose_body", Kind.LOCAL, NUM_BODY_JOINTS,
                           is_rotation=True),
    "pose_body_vel": Component("pose_body_vel", Kind.LOCAL, NUM_BODY_JOINTS),
    "joints": Component("joints", Kind.OFFSET_POINT, NUM_SMPL_JOINTS),
    "joints_vel": Component("joints_vel", Kind.VECTOR, NUM_SMPL_JOINTS),
    "joints_orient_vel": Component("joints_orient_vel", Kind.LOCAL, 1,
                                   is_scalar=True),
    "verts": Component("verts", Kind.OFFSET_POINT, NUM_KEYPT_VERTS),
    "verts_vel": Component("verts_vel", Kind.VECTOR, NUM_KEYPT_VERTS),
    "contacts": Component("contacts", Kind.LOCAL, NUM_CONTACTS, is_scalar=True),
}

RETURN_CONFIGS: Dict[str, Tuple[str, ...]] = {
    "smpl+joints": (
        "trans", "trans_vel", "root_orient", "root_orient_vel", "pose_body",
        "joints", "joints_vel",
    ),
    "smpl+joints+contacts": (
        "trans", "trans_vel", "root_orient", "root_orient_vel", "pose_body",
        "joints", "joints_vel", "contacts",
    ),
    "all": (
        "trans", "trans_vel", "root_orient", "root_orient_vel", "pose_body",
        "joints", "joints_vel", "verts", "contacts",
    ),
}


def component(name: str) -> Component:
    return _COMPONENTS[name]


def is_component(name: str) -> bool:
    return name in _COMPONENTS


def data_name_list(return_config: str) -> List[str]:
    return list(RETURN_CONFIGS[return_config])


def data_dim(name: str, rot_rep_size: int = 9) -> int:
    return _COMPONENTS[name].dim(rot_rep_size)


@dataclass(frozen=True)
class StateSpec:
    """Ordered (name, dim) layout of a packed state vector."""

    names: Tuple[str, ...]
    rot_rep: str

    @property
    def rot_size(self) -> int:
        return ROT_REP_SIZE[self.rot_rep]

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(data_dim(n, self.rot_size) for n in self.names)

    @property
    def total_dim(self) -> int:
        return sum(self.dims)

    @property
    def offsets(self) -> Tuple[Tuple[str, int, int], ...]:
        out, s = [], 0
        for n, d in zip(self.names, self.dims):
            out.append((n, s, s + d))
            s += d
        return tuple(out)

    def pack(self, state: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([state[n] for n in self.names], dim=-1)

    def unpack(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: x[..., s:e] for n, s, e in self.offsets}


def make_specs(model_data_config: str, in_rot_rep: str, out_rot_rep: str
               ) -> Tuple[StateSpec, StateSpec, StateSpec, bool]:
    """(input_spec, decoder_out_spec, state_spec_mat, pred_contacts)."""
    names = data_name_list(model_data_config)
    pred_contacts = "contacts" in names
    in_names = tuple(n for n in names if n != "contacts")
    out_names = in_names + (("contacts",) if pred_contacts else ())
    return (
        StateSpec(in_names, in_rot_rep),
        StateSpec(out_names, out_rot_rep),
        StateSpec(out_names, "mat"),
        pred_contacts,
    )
