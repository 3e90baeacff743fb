"""Linear-blend skinning's per-vertex blend and apply, the last step of
`body_model/smpl.lbs` (humor_tpu/body_model/smpl.py's lbs after the pose
blendshapes):

    v[b, v] = sum_j w[v, j] (Rw[b, j] v_posed[b, v] + t_rel[b, j]) + trans[b]

with weights (V, J) a constant, Rw (B, J, 3, 3), t_rel (B, J, 3),
v_posed (B, V, 3) and trans (B, 3).

`skin(...)` on float32 CUDA tensors is the autograd Function `Skin` over
the hand-written kernels of csrc/skinning.cu: the blended transforms
never reach device memory, forward or backward. Otherwise it is the plain
version below, the einsums the JAX package writes: on the CPU, and for
the bf16 policy's per-vertex pipeline, which runs in the dtype it is
given.

The kernels round as the plain version does on the card, bit for bit at a
training step's shape, 2,000 x 6,890 x 22 (csrc/skinning.cu says how).
The backward kernel writes grad_v_posed and the products grad (x)
v_posed; their sums over the vertices (grad_Rw, grad_t_rel) and
grad_trans's sum run as the plain version's autograd computes them: the
same einsums and sum on equal tensors. The benchmark's training check
holds the program to the plain reference over a chunk of Adamax steps,
and no other float32 summation order passes it (PERF.md sections 2, 7).
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, Tuple

import torch

from humor_torch.ops import cuda_build
from humor_torch.utils import profiling as PR

# Kernel launch counts: the wrappers add one where they launch a kernel.
launches = {"skin_fwd": 0, "skin_bwd": 0}
MAX_JOINTS = 64                # csrc/skinning.cu's MAX_JOINTS


def design() -> Dict[str, int]:
    """The kernels' `constexpr` sizes, read from csrc/skinning.cu (the CPU
    replay and the edge sizes follow them)."""
    with open(cuda_build.CSRC / "skinning.cu") as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def skin_plain(weights: torch.Tensor, Rw: torch.Tensor, t_rel: torch.Tensor,
               v_posed: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """The blended transforms materialized, (B, V, 3, 3) and (B, V, 3),
    then applied; computed in the inputs' dtype, added to trans in
    trans's."""
    R_v = torch.einsum("vj,bjik->bvik", weights, Rw)
    t_v = torch.einsum("vj,bji->bvi", weights, t_rel)
    v_out = torch.einsum("bvik,bvk->bvi", R_v, v_posed) + t_v
    return v_out.to(trans.dtype) + trans[:, None, :]


def _check_inputs(weights: torch.Tensor, rows: Dict[str, torch.Tensor]
                  ) -> Tuple[int, int, int]:
    """(B, V, J) of the kernels' inputs; raises on what they do not take."""
    if weights.dim() != 2:
        raise ValueError(f"skinning: weights must be (V, J), got "
                         f"{tuple(weights.shape)}")
    V, J = weights.shape
    B = rows["Rw"].shape[0]
    shapes = {"Rw": (B, J, 3, 3), "t_rel": (B, J, 3), "v_posed": (B, V, 3),
              "trans": (B, 3), "grad": (B, V, 3)}
    if not 1 <= J <= MAX_JOINTS:
        raise ValueError(f"skinning: the kernels take 1 to {MAX_JOINTS} "
                         f"joints, got {J}")
    for name, t in rows.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"skinning: {name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    tensors = {"weights": weights, **rows}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"skinning: {name} must be a contiguous float32 "
                             f"tensor, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    devices = {name: t.device for name, t in tensors.items()}
    if weights.device.type != "cuda" or len(set(devices.values())) > 1:
        raise ValueError(f"skinning: the kernels take tensors on one CUDA "
                         f"device, got {devices}")
    return B, V, J


def _lib():
    lib = cuda_build.load("skinning")
    if lib.skin_forward.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.skin_forward.argtypes = [P] * 6 + [I] * 3 + [P]
        lib.skin_forward.restype = I
        lib.skin_backward.argtypes = [P] * 6 + [I] * 3 + [P]
        lib.skin_backward.restype = I
    return lib


def skin_forward(weights, Rw, t_rel, v_posed, trans) -> torch.Tensor:
    """The forward kernel: the vertices (B, V, 3). Launches nothing when
    there is no row or no vertex."""
    B, V, J = _check_inputs(weights, {"Rw": Rw, "t_rel": t_rel,
                                      "v_posed": v_posed, "trans": trans})
    out = torch.empty(B, V, 3, dtype=torch.float32, device=v_posed.device)
    if B * V == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(v_posed.device).cuda_stream
    rc = lib.skin_forward(weights.data_ptr(), Rw.data_ptr(), t_rel.data_ptr(),
                          v_posed.data_ptr(), trans.data_ptr(),
                          out.data_ptr(), B, V, J, stream)
    cuda_build.check(lib, rc, "skin_forward")
    launches["skin_fwd"] += 1
    return out


def skin_backward(weights, Rw, v_posed, grad
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: grad_v_posed (B, V, 3) and the products
    prod[b, v, i, k] = grad[b, v, i] v_posed[b, v, k] (B, V, 3, 3), given
    the vertices' `grad`. Launches nothing when there is no row or no
    vertex."""
    B, V, J = _check_inputs(weights, {"Rw": Rw, "v_posed": v_posed,
                                      "grad": grad})
    g_vp = torch.empty(B, V, 3, dtype=torch.float32, device=grad.device)
    prod = torch.empty(B, V, 3, 3, dtype=torch.float32, device=grad.device)
    if B * V == 0:
        return g_vp, prod
    lib = _lib()
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    rc = lib.skin_backward(weights.data_ptr(), Rw.data_ptr(),
                           v_posed.data_ptr(), grad.data_ptr(),
                           g_vp.data_ptr(), prod.data_ptr(), B, V, J, stream)
    cuda_build.check(lib, rc, "skin_backward")
    launches["skin_bwd"] += 1
    return g_vp, prod


class Skin(torch.autograd.Function):
    """(weights, Rw, t_rel, v_posed, trans) -> vertices (B, V, 3) through
    the kernels; weights is a constant (no gradient)."""

    @staticmethod
    def forward(ctx, weights, Rw, t_rel, v_posed, trans):
        w, Rw, t_rel, v_posed, trans = (
            t.contiguous() for t in (weights, Rw, t_rel, v_posed, trans))
        ctx.save_for_backward(weights, w, Rw, v_posed)
        return skin_forward(w, Rw, t_rel, v_posed, trans)

    @staticmethod
    def backward(ctx, grad):
        weights, w, Rw, v_posed = ctx.saved_tensors
        grad = grad.contiguous()
        g_vp, prod = skin_backward(w, Rw, v_posed, grad)
        # the plain version's own reductions (module docstring), on the
        # weights as given: their layout picks cuBLAS's kernel
        g_rw = torch.einsum("vj,bvik->bjik", weights, prod)
        g_t = torch.einsum("vj,bvi->bji", weights, grad)
        return None, g_rw, g_t, g_vp, grad.sum(1)


def skin(weights: torch.Tensor, Rw: torch.Tensor, t_rel: torch.Tensor,
         v_posed: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """The vertices (B, V, 3): the kernels for float32 on CUDA, the plain
    version otherwise (see the module docstring)."""
    if v_posed.device.type != "cuda" or v_posed.dtype != torch.float32:
        return skin_plain(weights, Rw, t_rel, v_posed, trans)
    if weights.requires_grad:
        raise ValueError("skinning: the kernels take the weights as a "
                         "constant; they carry no gradient")
    PR.count("smpl.skin_kernel")
    return Skin.apply(weights, Rw, t_rel, v_posed, trans)
