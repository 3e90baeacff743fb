"""Fused HuMoR rollout: the stage-3 autoregressive chain and its gradient
as hand-written CUDA kernels, with plain PyTorch versions beside them.

Replaces the Pallas kernels of humor_tpu/ops/rollout_kernel.py:
`_fwd_pallas` (:536-606) by csrc/rollout_fwd.cu and `_bwd_pallas`
(:609-709) by csrc/rollout_bwd.cu.

What they compute: T sequential steps of the frozen CVAE. Per step the
conditional prior MLP (339 -> 1024x4 -> 96, GroupNorm(16)+ReLU) gives the
latent mean/var; the decoder MLP (387 -> 1024 -> 1024 -> 512 -> 216, z
concatenated into every layer) gives deltas; the deltas compose onto the
state (Rodrigues x previous rotation for root and 21 joints, additive
for the rest); the result goes to world under the running global
transform and is re-canonicalized to the new heading frame. The
backward runs the chain in reverse and returns d(initial carry), dz for
every step and d(trans2joint); the weights are frozen (TTO contract), so
they get no cotangent.

What bounds it on the H100: operations. Each step is 2*M*5.78M FLOP of
f32 matmul (0.19 GFLOP at M=16, ~11 GFLOP per 59-step rollout) against
67 TFLOP/s of f32 outside the tensor cores; the 23 MB of weights fit the
50 MB L2, so device-memory bytes are a bound only on the first step.
The backward recomputes each step's activations from the saved entry
carry and then runs the transposed products, about twice the forward's
work. At M=16 the real limit is parallelism: a 16-row product gives
little work to spread over 132 SMs. Each kernel is one persistent
cooperative launch a rollout (csrc/rollout_persistent.cuh): one block an
SM holds a share of the weights in shared memory as 64 x 64 tiles loaded
once a call, a product is split over K into those tiles, and each split-K
output tile is finished by one block dealt it, in a fixed summation order.
The forward runs prior layer k beside decoder layer k, then the tail, with
the prior head beside the next step's first layers (csrc/rollout_fwd.cu);
the backward runs the recompute of step t beside the backward of step
t + 1 (csrc/rollout_bwd.cu). No grid barrier separates the phases: each
finished tile is published on a ready counter, and each task waits for
the tiles it reads and for the readers of what it overwrites. Math is
plain f32 FMA: no TF32, no bf16.

Layout (shared by the kernels and the plain versions):
  carry (M, 351) = x (339: trans 3 | trans_vel 3 | root 9 | root_vel 3 |
                   pose 189 | joints 66 | joints_vel 66)
                   | g_rot 9 | g_trans 3
  x is exactly the network input (matrix rotations, row-major), so layer
  0 reads the carry directly.
  out (T, M, 444) = world x (339) | contact logits 9 | prior mean 48 |
                    prior var 48
  decoder raw output (216) = d_trans 3 | d_trans_vel 3 | d_root aa 3 |
                    d_root_vel 3 | d_pose aa 63 | d_joints 66 | d_jvel 66
                    | contacts 9
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from humor_torch.models.canonical import apply_world2local, frame_from_state
from humor_torch.ops import cuda_build
from humor_torch.ops.mlp import GN_EPS, GN_GROUPS
from humor_torch.utils import profiling

LATENT = 48
D_X = 339
CW = 351
OUT_W = 444
IN_NAMES = ("trans", "trans_vel", "root_orient", "root_orient_vel",
            "pose_body", "joints", "joints_vel")

# Kernel launch counts: each wrapper adds one where it launches its
# kernel (a run shows the main path went through the kernels).
launches = {"rollout_fwd": 0, "rollout_bwd": 0}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class _WeightsStruct(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p * n) for name, n in (
        ("pw", 5), ("pb", 5), ("pgs", 5), ("pgb", 5),
        ("dw", 4), ("db", 4), ("dgs", 4), ("dgb", 4))]


class RolloutWeights:
    """Frozen prior + decoder weights in the kernels' layout: per layer
    w (in, out), b, and the GroupNorm affine applied to that layer's INPUT
    (None for layer 0). The backward's transposed products read rows of
    w, so no transposed copy is kept. The kernels take float32 only;
    float64 weights serve the plain versions in precision studies."""

    def __init__(self, params: Dict, device, dtype=torch.float32):
        def cast(t):
            return t.to(device=device, dtype=dtype).contiguous()

        def prep(layers):
            ws, bs, gss, gbs = [], [], [], []
            for layer in layers:
                ws.append(cast(layer["w"]))
                bs.append(cast(layer["b"]))
                gss.append(cast(layer["gn_scale"]) if "gn_scale" in layer
                           else None)
                gbs.append(cast(layer["gn_bias"]) if "gn_bias" in layer
                           else None)
            return ws, bs, gss, gbs

        self.prior = prep(params["prior"])
        self.decoder = prep(params["decoder"])
        self.device = self.prior[0][0].device
        if len(self.prior[0]) != 5 or len(self.decoder[0]) != 4:
            raise ValueError("expected a 5-layer prior and 4-layer decoder")
        self._struct = None

    def struct(self) -> _WeightsStruct:
        if self._struct is None:
            s = _WeightsStruct()
            for prefix, (ws, bs, gss, gbs) in (("p", self.prior),
                                               ("d", self.decoder)):
                for i in range(len(ws)):
                    for field, t in (("w", ws[i]), ("b", bs[i]),
                                     ("gs", gss[i]), ("gb", gbs[i])):
                        if t is not None and t.data_ptr() % 16:
                            raise ValueError("the kernels read weights as "
                                             "float4: need 16-byte-aligned "
                                             "tensors")
                        getattr(s, prefix + field)[i] = (
                            t.data_ptr() if t is not None else None)
            self._struct = s
        return self._struct


# ---------------------------------------------------------------------------
# Plain PyTorch forward
# ---------------------------------------------------------------------------

def _gn(h, gs, gb):
    M, N = h.shape
    g = h.reshape(M, GN_GROUPS, N // GN_GROUPS)
    mean = g.mean(dim=-1, keepdim=True)
    cent = g - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    return (cent * torch.rsqrt(var + GN_EPS)).reshape(M, N) * gs + gb


def _mlp(layers, inp, z=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Head output and the pre-GroupNorm activations of layers 0..n-2."""
    ws, bs, gss, gbs = layers
    h = (inp if z is None else torch.cat([inp, z], dim=-1)) @ ws[0] + bs[0]
    hs = []
    for i in range(1, len(ws)):
        hs.append(h)
        a = torch.relu(_gn(h, gss[i], gbs[i]))
        if z is not None:
            a = torch.cat([a, z], dim=-1)
        h = a @ ws[i] + bs[i]
    return h, hs


def _rodrigues(aa):
    """(..., 3) -> (..., 3, 3): transforms.aa_to_rotmat's math (+1e-8
    bias, max(sq, 1e-16)) written out per entry."""
    x, y, z = aa[..., 0] + 1e-8, aa[..., 1] + 1e-8, aa[..., 2] + 1e-8
    angle = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-16))
    ux, uy, uz = x / angle, y / angle, z / angle
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    return torch.stack([
        c + ux * ux * C, ux * uy * C - uz * s, ux * uz * C + uy * s,
        uy * ux * C + uz * s, c + uy * uy * C, uy * uz * C - ux * s,
        uz * ux * C - uy * s, uz * uy * C + ux * s, c + uz * uz * C,
    ], dim=-1).reshape(*aa.shape[:-1], 3, 3)


def _heading(root):
    """compute_world2aligned_mat on (M, 3, 3) roots."""
    bx, by = -root[:, 0, 0], -root[:, 1, 0]
    h = torch.sqrt(torch.clamp(bx * bx + by * by, min=1e-12))
    deg = h < 1e-6
    c = torch.where(deg, torch.ones_like(bx), bx / (h + 1e-6))
    s = torch.where(deg, torch.zeros_like(by), by / (h + 1e-6))
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([c, s, zero, -s, c, zero, zero, zero, one],
                       dim=-1).reshape(-1, 3, 3)


def _mv(A, v):
    """A (M, 3, 3) applied to v (M, 3) or (M, J, 3)."""
    if v.dim() == 2:
        return torch.einsum("mij,mj->mi", A, v)
    return torch.einsum("mij,mkj->mki", A, v)


def _split_x(x):
    """State vector (M, 339+) -> trans, trans_vel, root (M,3,3), root_vel,
    pose (M,21,3,3), joints (M,22,3), joints_vel (M,22,3)."""
    M = x.shape[0]
    return (x[:, 0:3], x[:, 3:6], x[:, 6:15].reshape(M, 3, 3), x[:, 15:18],
            x[:, 18:207].reshape(M, 21, 3, 3), x[:, 207:273].reshape(M, 22, 3),
            x[:, 273:339].reshape(M, 22, 3))


def _split_carry(carry):
    """Carry (M, 351) -> the _split_x parts, g_rot (M,3,3), g_trans."""
    M = carry.shape[0]
    return _split_x(carry) + (carry[:, 339:348].reshape(M, 3, 3),
                              carry[:, 348:351])


class _TailState:
    """Forward quantities of one step's tail, shared by the plain forward
    and the hand VJP."""

    def __init__(self, carry, t2j, draw):
        M = carry.shape[0]
        (self.trans, self.tv, self.root, self.rv, self.pose, self.jnt,
         self.jv, self.g, self.gt) = _split_carry(carry)
        self.Rdr = _rodrigues(draw[:, 6:9])
        self.Rdp = _rodrigues(draw[:, 12:75].reshape(M, 21, 3))
        self.n_trans = self.trans + draw[:, 0:3]
        self.n_tv = self.tv + draw[:, 3:6]
        self.n_rv = self.rv + draw[:, 9:12]
        self.n_root = self.Rdr @ self.root
        self.n_pose = self.Rdp @ self.pose
        self.n_jnt = self.jnt + draw[:, 75:141].reshape(M, 22, 3)
        self.n_jv = self.jv + draw[:, 141:207].reshape(M, 22, 3)
        self.W = _heading(self.n_root)
        zero = torch.zeros_like(self.n_trans[:, :1])
        self.f = torch.cat([-self.n_trans[:, :2], zero], dim=-1)
        self.t2j = t2j


def tail_forward(carry, t2j, draw, phead):
    """One step's tail: delta composition, world un-canonicalization,
    re-canonicalization. Returns (out (M, 444), next carry (M, 351))."""
    M = carry.shape[0]
    s = _TailState(carry, t2j, draw)
    gT = s.g.transpose(1, 2)
    t2 = t2j[:, None]
    w_root = gT @ s.n_root
    w_trans = _mv(gT, s.n_trans) - s.gt
    w_jnt = _mv(gT, s.n_jnt + t2) - t2 - s.gt[:, None]
    W = s.W
    l_root = W @ s.n_root
    l_trans = _mv(W, s.n_trans + s.f)
    l_jnt = _mv(W, s.n_jnt + s.f[:, None] + t2) - t2
    zero = torch.zeros_like(w_trans[:, :1])
    out = torch.cat([
        w_trans, _mv(gT, s.n_tv), w_root.reshape(M, 9), _mv(gT, s.n_rv),
        s.n_pose.reshape(M, 189), w_jnt.reshape(M, 66),
        _mv(gT, s.n_jv).reshape(M, 66), draw[:, 207:216],
        phead[:, :LATENT], torch.exp(phead[:, LATENT:])], dim=-1)
    nxt = torch.cat([
        l_trans, _mv(W, s.n_tv), l_root.reshape(M, 9), _mv(W, s.n_rv),
        s.n_pose.reshape(M, 189), l_jnt.reshape(M, 66),
        _mv(W, s.n_jv).reshape(M, 66), (s.g @ W).reshape(M, 9),
        -w_trans[:, :2], zero], dim=-1)
    return out, nxt


def step_forward(w: RolloutWeights, carry, z, t2j):
    phead, _ = _mlp(w.prior, carry[:, :D_X])
    draw, _ = _mlp(w.decoder, carry[:, :D_X], z)
    return tail_forward(carry, t2j, draw, phead)


def rollout_forward_plain(w: RolloutWeights, carry0, z, t2j):
    """carry0 (M, 351), z (T, M, 48), t2j (M, 3) -> (out (T, M, 444),
    saved entry carries (T, M, 351))."""
    outs, saved = [], []
    carry = carry0
    for t in range(z.shape[0]):
        saved.append(carry)
        out, carry = step_forward(w, carry, z[t], t2j)
        outs.append(out)
    return torch.stack(outs), torch.stack(saved)


# ---------------------------------------------------------------------------
# Plain PyTorch backward: the VJP written out by hand (no autograd)
# ---------------------------------------------------------------------------

def _outer_sum(a, b):
    """sum_k a_k b_k^T for (M, [J,] 3) vectors -> (M, 3, 3)."""
    if a.dim() == 2:
        return a[:, :, None] * b[:, None, :]
    return torch.einsum("mka,mkb->mab", a, b)


def _clamp_grad(x, lo):
    """d max(x, lo)/dx as JAX differentiates it (0.5 at a tie)."""
    one = torch.ones_like(x)
    return torch.where(x > lo, one, torch.where(x == lo, 0.5 * one,
                                                torch.zeros_like(x)))


def _rodrigues_vjp(aa, dR):
    """Cotangent of _rodrigues: aa (..., 3), dR (..., 3, 3) -> (..., 3)."""
    v = aa + 1e-8
    sq = (v * v).sum(-1)
    angle = torch.sqrt(torch.clamp(sq, min=1e-16))
    u = v / angle[..., None]
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    d = dR.reshape(*dR.shape[:-2], 9)
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    dc = d[..., 0] + d[..., 4] + d[..., 8]
    dC = torch.einsum("...i,...ij,...j->...", u, dR, u)
    ds = (-d[..., 1] * uz + d[..., 2] * uy + d[..., 3] * uz
          - d[..., 5] * ux - d[..., 6] * uy + d[..., 7] * ux)
    du = C[..., None] * ((dR + dR.transpose(-1, -2)) @ u[..., None])[..., 0]
    du = du + s[..., None] * torch.stack(
        [d[..., 7] - d[..., 5], d[..., 2] - d[..., 6], d[..., 3] - d[..., 1]],
        dim=-1)
    dangle = (-s * (dc - dC) + c * ds
              - (du * v).sum(-1) / (angle * angle))
    dv = du / angle[..., None]
    dsq = dangle / (2.0 * angle) * _clamp_grad(sq, 1e-16)
    return dv + 2.0 * v * dsq[..., None]


def _heading_vjp(root, dW):
    """Cotangent of _heading w.r.t. root (M, 3, 3) given dW (M, 3, 3)."""
    bx, by = -root[:, 0, 0], -root[:, 1, 0]
    hsq = bx * bx + by * by
    h = torch.sqrt(torch.clamp(hsq, min=1e-12))
    deg = h < 1e-6
    hp = h + 1e-6
    dc = dW[:, 0, 0] + dW[:, 1, 1]
    ds = dW[:, 0, 1] - dW[:, 1, 0]
    zero = torch.zeros_like(bx)
    dbx = torch.where(deg, zero, dc / hp)
    dby = torch.where(deg, zero, ds / hp)
    dh = torch.where(deg, zero, -(dc * bx + ds * by) / (hp * hp))
    dhsq = dh / (2.0 * h) * _clamp_grad(hsq, 1e-12)
    dbx = dbx + 2.0 * bx * dhsq
    dby = dby + 2.0 * by * dhsq
    droot = torch.zeros_like(root)
    droot[:, 0, 0] = -dbx
    droot[:, 1, 0] = -dby
    return droot


def tail_vjp(carry, t2j, draw, phead, dout, dnext):
    """Hand-derived VJP of tail_forward. Returns (d carry (M, 351),
    d draw (M, 216), d phead (M, 96), d t2j (M, 3))."""
    M = carry.shape[0]
    s = _TailState(carry, t2j, draw)
    W, g = s.W, s.g
    WT = W.transpose(1, 2)
    t2 = t2j[:, None]
    (dl_trans, dl_tv, dl_root, dl_rv, dl_pose, dl_jnt, dl_jv, dG,
     dgt_next) = _split_carry(dnext)
    dw_trans, dw_tv, dw_root, dw_rv, dw_pose, dw_jnt, dw_jv = _split_x(dout)
    zero = torch.zeros_like(dgt_next[:, :1])
    dw_trans = dw_trans - torch.cat([dgt_next[:, :2], zero], dim=-1)

    # local (re-canonicalized) outputs and the new global rotation g @ W
    dg = dG @ WT
    dW = g.transpose(1, 2) @ dG
    dW = dW + _outer_sum(dl_jv, s.n_jv) + _outer_sum(dl_tv, s.n_tv) \
        + _outer_sum(dl_rv, s.n_rv)
    dn_jv = _mv(WT, dl_jv)
    dn_tv = _mv(WT, dl_tv)
    dn_rv = _mv(WT, dl_rv)
    q = s.n_jnt + s.f[:, None] + t2
    dW = dW + _outer_sum(dl_jnt, q)
    dq = _mv(WT, dl_jnt)
    dn_jnt = dq
    df = dq.sum(1)
    dt2j = dq.sum(1) - dl_jnt.sum(1)
    qt = s.n_trans + s.f
    dW = dW + _outer_sum(dl_trans, qt)
    dqt = _mv(WT, dl_trans)
    dn_trans = dqt
    df = df + dqt
    dW = dW + dl_root @ s.n_root.transpose(1, 2)
    dn_root = WT @ dl_root
    dn_trans = dn_trans - torch.cat([df[:, :2], zero], dim=-1)
    dn_root = dn_root + _heading_vjp(s.n_root, dW)

    # world outputs under g^T
    dgT = _outer_sum(dw_jv, s.n_jv) + _outer_sum(dw_tv, s.n_tv) \
        + _outer_sum(dw_rv, s.n_rv)
    dn_jv = dn_jv + _mv(g, dw_jv)
    dn_tv = dn_tv + _mv(g, dw_tv)
    dn_rv = dn_rv + _mv(g, dw_rv)
    dgT = dgT + _outer_sum(dw_jnt, s.n_jnt + t2)
    dqw = _mv(g, dw_jnt)
    dn_jnt = dn_jnt + dqw
    dt2j = dt2j + dqw.sum(1) - dw_jnt.sum(1)
    dgt = -dw_jnt.sum(1) - dw_trans
    dgT = dgT + _outer_sum(dw_trans, s.n_trans)
    dn_trans = dn_trans + _mv(g, dw_trans)
    dgT = dgT + dw_root @ s.n_root.transpose(1, 2)
    dn_root = dn_root + g @ dw_root
    dg = dg + dgT.transpose(1, 2)

    # delta composition
    dn_pose = dw_pose + dl_pose
    dRdr = dn_root @ s.root.transpose(1, 2)
    droot = s.Rdr.transpose(1, 2) @ dn_root
    dRdp = dn_pose @ s.pose.transpose(-1, -2)
    dpose = s.Rdp.transpose(-1, -2) @ dn_pose
    ddraw = torch.cat([
        dn_trans, dn_tv, _rodrigues_vjp(draw[:, 6:9], dRdr), dn_rv,
        _rodrigues_vjp(draw[:, 12:75].reshape(M, 21, 3), dRdp).reshape(M, 63),
        dn_jnt.reshape(M, 66), dn_jv.reshape(M, 66), dout[:, 339:348]],
        dim=-1)
    dphead = torch.cat([dout[:, 348:396],
                        dout[:, 396:444] * torch.exp(phead[:, LATENT:])],
                       dim=-1)
    dcarry = torch.cat([
        dn_trans, dn_tv, droot.reshape(M, 9), dn_rv, dpose.reshape(M, 189),
        dn_jnt.reshape(M, 66), dn_jv.reshape(M, 66), dg.reshape(M, 9), dgt],
        dim=-1)
    return dcarry, ddraw, dphead, dt2j


def _gn_relu_vjp(da, h, gs, gb):
    """Cotangent of relu(GroupNorm(h)) w.r.t. h, JAX's derivative of
    cent * rsqrt(var + eps) * scale + bias (relu'(0) = 0)."""
    M, N = h.shape
    n = N // GN_GROUPS
    hg = h.reshape(M, GN_GROUPS, n)
    cent = hg - hg.mean(-1, keepdim=True)
    r = torch.rsqrt((cent * cent).mean(-1, keepdim=True) + GN_EPS)
    y = (cent * r).reshape(M, N) * gs + gb
    gg = (torch.where(y > 0, da, torch.zeros_like(da)) * gs).reshape(
        M, GN_GROUPS, n)
    dcent = r * gg - r * r * r * cent * (gg * cent).mean(-1, keepdim=True)
    return (dcent - dcent.mean(-1, keepdim=True)).reshape(M, N)


def _mlp_vjp(layers, hs, dhead, z_width=0):
    """Back through an MLP from its head cotangent: returns (d input,
    d z summed over layers or None)."""
    ws, bs, gss, gbs = layers
    dh = dhead
    dz = None
    for i in range(len(ws) - 1, -1, -1):
        dinp = dh @ ws[i].t()
        if z_width:
            part = dinp[:, -z_width:]
            dz = part if dz is None else dz + part
            dinp = dinp[:, :-z_width]
        if i == 0:
            return dinp, dz
        dh = _gn_relu_vjp(dinp, hs[i - 1], gss[i], gbs[i])


def relu_margins(w: RolloutWeights, saved, z):
    """Per row, the smallest |ReLU input| over its layer's mean |ReLU
    input|, over every step and hidden layer of both MLPs, recomputed
    from the saved entry carries (T, M, 351) in the weights' precision.
    Where it is near float32's resolution, two float32 evaluations can
    take the ReLU's two branches, and the row's cotangents differ by that
    unit's whole term (a tie, not an error)."""
    margin = torch.full((saved.shape[1],), float("inf"), dtype=saved.dtype,
                        device=saved.device)
    for t in range(saved.shape[0]):
        x = saved[t][:, :D_X]
        for layers, zt in ((w.prior, None), (w.decoder, z[t])):
            _, hs = _mlp(layers, x, zt)
            for i, h in enumerate(hs):
                y = _gn(h, layers[2][i + 1], layers[3][i + 1]).abs()
                rel = y / y.mean(dim=1, keepdim=True)
                margin = torch.minimum(margin, rel.min(dim=1).values)
    return margin


def rollout_backward_plain(w: RolloutWeights, saved, z, t2j, dout):
    """Hand-written VJP of rollout_forward_plain: recompute each step's
    activations from its saved entry carry, then back through the tail
    and both MLPs. Returns (d carry0 (M, 351), dz (T, M, 48), d t2j)."""
    T = z.shape[0]
    dcarry = torch.zeros_like(saved[0])
    dt2j = torch.zeros_like(t2j)
    dz = torch.empty_like(z)
    for t in range(T - 1, -1, -1):
        carry = saved[t]
        x = carry[:, :D_X]
        phead, hs_p = _mlp(w.prior, x)
        draw, hs_d = _mlp(w.decoder, x, z[t])
        dcur, ddraw, dphead, dt = tail_vjp(carry, t2j, draw, phead,
                                           dout[t], dcarry)
        dx_d, dz[t] = _mlp_vjp(w.decoder, hs_d, ddraw, z_width=LATENT)
        dx_p, _ = _mlp_vjp(w.prior, hs_p, dphead)
        dcarry = dcur + torch.cat(
            [dx_d + dx_p, torch.zeros_like(dcur[:, D_X:])], dim=-1)
        dt2j = dt2j + dt
    return dcarry, dz, dt2j


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _check_inputs(w: RolloutWeights, tensors):
    for name, t in tensors.items():
        if t.device != w.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on "
                             f"{w.device}, got {t.dtype} on {t.device}")


def _lib(name):
    """The kernel library, its entry's ctypes signature declared."""
    lib = cuda_build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fwd = name == "rollout_fwd"
        ptrs = 6 if fwd else 8
        fn.argtypes = ([ctypes.POINTER(_WeightsStruct)] + [_P] * ptrs
                       + [ctypes.c_int, ctypes.c_int, _P])
        fn.restype = ctypes.c_int
        scratch = getattr(lib, name + "_scratch_floats")
        # the forward's scratch holds the running carry of every step
        scratch.argtypes = [ctypes.c_int] * (2 if fwd else 1)
        scratch.restype = ctypes.c_longlong
    return lib


def _design(name) -> Dict[str, int]:
    lib = _lib(name)
    blocks = getattr(lib, name + "_grid_blocks")()
    if blocks <= 0:
        cuda_build.check(lib, -blocks, name + " grid query")
    return {"grid_blocks": blocks,
            "barriers_per_call": getattr(lib, name + "_barriers_per_call")()}


def forward_design() -> Dict[str, int]:
    """The forward kernel's launch on this device: blocks of its grid and
    grid-wide barriers a call (loads and builds it; needs a GPU)."""
    return _design("rollout_fwd")


def backward_design() -> Dict[str, int]:
    """The backward kernel's launch on this device: blocks of its grid and
    grid-wide barriers a call (loads and builds it; needs a GPU)."""
    return _design("rollout_bwd")


def _count_waits(scratch):
    """While profiling records, adds the call's ready-waits and the ones
    that spun (the first two int32 of its scratch) to the counters
    `rollout.waits` and `rollout.waits_stalled`: a read of the card, so a
    sync. Reads nothing otherwise."""
    if not profiling.active():
        return
    waits, stalled = scratch[:2].view(torch.int32).tolist()
    profiling.count("rollout.waits", waits)
    profiling.count("rollout.waits_stalled", stalled)


def _forward_cuda(w: RolloutWeights, carry0, z, t2j):
    T, M = z.shape[:2]
    _check_inputs(w, {"carry0": carry0, "z": z, "t2j": t2j})
    if carry0.shape != (M, CW) or z.shape[2] != LATENT \
            or t2j.shape != (M, 3):
        raise ValueError("rollout_fwd: bad shapes")
    lib = _lib("rollout_fwd")
    out = torch.empty(T, M, OUT_W, device=w.device)
    saved = torch.empty(T, M, CW, device=w.device)
    scratch = torch.empty(lib.rollout_fwd_scratch_floats(M, T),
                          device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = lib.rollout_fwd(ctypes.byref(w.struct()), carry0.data_ptr(),
                         z.data_ptr(), t2j.data_ptr(), out.data_ptr(),
                         saved.data_ptr(), scratch.data_ptr(), M, T, stream)
    cuda_build.check(lib, rc, "rollout_fwd")
    launches["rollout_fwd"] += 1
    _count_waits(scratch)
    return out, saved


def _backward_cuda(w: RolloutWeights, saved, z, t2j, dout):
    T, M = z.shape[:2]
    _check_inputs(w, {"saved": saved, "z": z, "t2j": t2j, "dout": dout})
    if saved.shape != (T, M, CW) or dout.shape != (T, M, OUT_W) \
            or z.shape[2] != LATENT or t2j.shape != (M, 3):
        raise ValueError("rollout_bwd: bad shapes")
    lib = _lib("rollout_bwd")
    dcarry0 = torch.empty(M, CW, device=w.device)
    dz = torch.empty_like(z)
    dt2j = torch.empty_like(t2j)
    scratch = torch.empty(lib.rollout_bwd_scratch_floats(M), device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = lib.rollout_bwd(ctypes.byref(w.struct()), saved.data_ptr(),
                         z.data_ptr(), t2j.data_ptr(), dout.data_ptr(),
                         dcarry0.data_ptr(), dz.data_ptr(), dt2j.data_ptr(),
                         scratch.data_ptr(), M, T, stream)
    cuda_build.check(lib, rc, "rollout_bwd")
    launches["rollout_bwd"] += 1
    _count_waits(scratch)
    return dcarry0, dz, dt2j


def rollout_forward(w: RolloutWeights, carry0, z, t2j):
    """Forward kernel on CUDA tensors, plain version on CPU tensors."""
    if carry0.device.type == "cpu":
        return rollout_forward_plain(w, carry0, z, t2j)
    return _forward_cuda(w, carry0, z, t2j)


def rollout_backward(w: RolloutWeights, saved, z, t2j, dout):
    """Backward kernel on CUDA tensors, plain VJP on CPU tensors."""
    if saved.device.type == "cpu":
        return rollout_backward_plain(w, saved, z, t2j, dout)
    return _backward_cuda(w, saved, z, t2j, dout)


class RolloutFunction(torch.autograd.Function):
    """carry0 (M, 351), z (T, M, 48), t2j (M, 3) -> out (T, M, 444);
    gradients flow to carry0, z and t2j (weights frozen)."""

    @staticmethod
    def forward(ctx, carry0, z, t2j, w):
        out, saved = rollout_forward(w, carry0.contiguous(), z.contiguous(),
                                     t2j.contiguous())
        ctx.save_for_backward(saved, z, t2j)
        ctx.weights = w
        return out

    @staticmethod
    def backward(ctx, dout):
        saved, z, t2j = ctx.saved_tensors
        dcarry0, dz, dt2j = rollout_backward(
            ctx.weights, saved, z.contiguous(), t2j.contiguous(),
            dout.contiguous())
        return dcarry0, dz, dt2j, None


# ---------------------------------------------------------------------------
# Entry: the canonicalized rollout the TTO runs
# ---------------------------------------------------------------------------

def world_to_dict(out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(T, M, 444) -> humor.rollout's world dict, each (M, T, D)."""
    o = out.transpose(0, 1)
    return {"trans": o[..., 0:3], "trans_vel": o[..., 3:6],
            "root_orient": o[..., 6:15], "root_orient_vel": o[..., 15:18],
            "pose_body": o[..., 18:207], "joints": o[..., 207:273],
            "joints_vel": o[..., 273:339], "contacts": o[..., 339:348]}


def rollout(w: RolloutWeights, init_state: Dict[str, torch.Tensor],
            z_seq: torch.Tensor):
    """humor.rollout(z_seq=..., canonicalize_input=True,
    uncanonicalize_output=True) through the fused kernels.

    The initial world state (matrix rotations, components (M, D)) is
    canonicalized here in torch; the carry starts at the canonical state
    with the global transform set to that frame, and trans2joint comes
    from the canonical joints. Autograd carries the gradient through this
    prologue, so the kernel's d(g_rot), d(g_trans) and d(t2j) all count.
    Returns (world dict (M, T, D), (prior mean, prior var) (M, T, 48))."""
    frame = frame_from_state(init_state)
    local = apply_world2local(frame, {k: init_state[k] for k in IN_NAMES})
    M = local["trans"].shape[0]
    t2j = torch.cat([-local["joints"][:, :2],
                     torch.zeros_like(local["joints"][:, :1])], dim=-1)
    carry0 = torch.cat([local[k] for k in IN_NAMES]
                       + [frame.rot.reshape(M, 9), frame.trans], dim=-1)
    out = RolloutFunction.apply(carry0, z_seq.transpose(0, 1), t2j, w)
    world = world_to_dict(out)
    o = out.transpose(0, 1)
    return world, (o[..., 348:396], o[..., 396:444])
