"""The skinning op (humor_torch/ops/skinning.py) on the CPU: its plain
version against the einsum pipeline `smpl.lbs` ran before, a replay of
the CUDA kernels' arithmetic (csrc/skinning.cu) in their summation order,
with Skin.backward's sums, against the plain forward and autograd's
gradients, and `lbs` on the CPU unchanged. The kernels themselves run in tests/test_torch_cuda_kernels.py
(on a card) and in chip_smoke.py."""

import numpy as np
import pytest
import torch

from humor_torch.body_model import smpl as SM
from humor_torch.ops import skinning as SK
from humor_torch.ops import transforms as TT

# (rows N, vertices V, joints J): one of each, no vertex, the fit's 43
# keypoint vertices, a row of more than one tile of vertices, and rows whose
# vertices run past one launch of the plain path's batched GEMV
SHAPES = [(1, 1, 1), (3, 0, 22), (5, 43, 22), (7, 257, 22), (10, 6890, 22)]
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _einsum_pipeline(weights, Rw, t_rel, v_posed, trans, out_dtype):
    """The blend and apply as smpl.lbs wrote them before the op."""
    R_v = torch.einsum("vj,bjik->bvik", weights, Rw)
    t_v = torch.einsum("vj,bji->bvi", weights, t_rel)
    v_out = torch.einsum("bvik,bvk->bvi", R_v, v_posed) + t_v
    return v_out.to(out_dtype) + trans[:, None, :]


def _inputs(shape, dtype, seed=0):
    n, v, j = shape
    rng = np.random.RandomState(seed)
    w = rng.rand(v, j)
    w /= np.maximum(w.sum(1, keepdims=True), 1e-12)
    f = lambda a: torch.tensor(a, dtype=torch.float64)
    Rw = TT.aa_to_rotmat(f(rng.randn(n, j, 3)))
    return [t.to(dtype) for t in (f(w), Rw, f(0.3 * rng.randn(n, j, 3)),
                                  f(rng.randn(n, v, 3)),
                                  f(rng.randn(n, 3)))]


def _replay_forward(w, Rw, t_rel, vp, trans):
    """skin_fwd_kernel's arithmetic: each vertex's 12 floats blended in
    joint order; R x summed as the plain path's batched GEMV sums it, (p0
    + p1) + p2 in its launches of GEMV_BATCH matrices, (p0 + p2) + p1 in
    the last, partial one; + t, + trans."""
    B, J = Rw.shape[:2]
    V = vp.shape[1]
    T = torch.cat([Rw.reshape(B, J, 9), t_rel], dim=-1)
    acc = torch.zeros(B, V, 12, dtype=vp.dtype)
    for j in range(J):
        acc = acc + w[None, :, j, None] * T[:, None, j, :]
    n = B * V
    tail = n - n % SK.design()["GEMV_BATCH"]
    full = (torch.arange(n) < tail).reshape(B, V)
    out = []
    for i in range(3):
        p = [acc[..., 3 * i + k] * vp[..., k] for k in range(3)]
        s = torch.where(full, (p[0] + p[1]) + p[2], (p[0] + p[2]) + p[1])
        out.append((s + acc[..., 9 + i]) + trans[:, None, i])
    return torch.stack(out, dim=-1)


def _replay_backward(w, Rw, vp, g):
    """skin_bwd_kernel's arithmetic, grad_v_posed = R_v^T g from the
    re-blended rotation summed as (p0 + p1) + p2, and its products
    g (x) v_posed; then Skin.backward's sums of them (the plain version's
    einsums and sum)."""
    B, J = Rw.shape[:2]
    V = vp.shape[1]
    rot = torch.zeros(B, V, 9, dtype=vp.dtype)
    for j in range(J):
        rot = rot + w[None, :, j, None] * Rw.reshape(B, J, 9)[:, None, j, :]
    g_vp = torch.stack([(rot[..., k] * g[..., 0] + rot[..., 3 + k] * g[..., 1])
                        + rot[..., 6 + k] * g[..., 2] for k in range(3)], -1)
    prod = g[..., :, None] * vp[..., None, :]
    return (torch.einsum("vj,bvik->bjik", w, prod),
            torch.einsum("vj,bvi->bji", w, g), g_vp, g.sum(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_einsum_pipeline(dtype):
    """The plain version is the einsums lbs ran before, bit for bit, in
    float32 and in the bf16 policy's dtype (vertices back in trans's
    float32)."""
    w, Rw, t_rel, vp, trans = _inputs((5, 43, 22), torch.float32, seed=1)
    args = [a.to(dtype) for a in (w, Rw, t_rel, vp)]
    assert torch.equal(SK.skin_plain(*args, trans),
                       _einsum_pipeline(*args, trans, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_arithmetic_matches_plain(shape, dtype):
    """The kernels' replay against the plain forward and autograd's
    gradients of Rw, t_rel, v_posed and trans (float64 to 1e-10, float32
    to 1e-5: the same sums in another order)."""
    w, Rw, t_rel, vp, trans = _inputs(shape, dtype, seed=sum(shape))
    leaves = [t.clone().requires_grad_() for t in (Rw, t_rel, vp, trans)]
    out = SK.skin_plain(w, *leaves)
    g = torch.tensor(np.random.RandomState(7).randn(*out.shape), dtype=dtype)
    grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip(leaves, grads)]
    tol = TOL[dtype]
    torch.testing.assert_close(_replay_forward(w, Rw, t_rel, vp, trans),
                               out.detach(), rtol=tol, atol=tol)
    for name, a, b in zip(("Rw", "t_rel", "v_posed", "trans"),
                          _replay_backward(w, Rw, vp, g), grads):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("mode", ["full", "vert_ids", "bf16"])
def test_lbs_on_cpu_unchanged(monkeypatch, mode):
    """smpl.lbs on the CPU gives the vertices, joints and gradients it
    gave with the einsums inline."""
    body = SM.synthetic_smpl_model(seed=3, num_verts=300)
    rng = np.random.RandomState(4)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    kw = {"vert_ids": np.arange(0, 300, 7)} if mode == "vert_ids" else {}
    if mode == "bf16":
        kw["compute_dtype"] = torch.bfloat16

    def run():
        mats = TT.aa_to_rotmat(f(0.4 * rng.randn(4, 22, 3))).requires_grad_()
        trans = f(rng.randn(4, 3)).requires_grad_()
        out = SM.lbs(body, f(rng.randn(4, 16)), mats, trans, **kw)
        loss = (out.v ** 2).sum() + (out.Jtr ** 3).sum()
        return (out.v, out.Jtr, *torch.autograd.grad(loss, [mats, trans]))

    state = rng.get_state()
    new = run()
    rng.set_state(state)
    monkeypatch.setattr(SM.skinning, "skin", lambda *a: _einsum_pipeline(
        *a, torch.float32))
    old = run()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_max_joints_is_the_kernels():
    """The wrapper's joint limit is the one the kernels' source states."""
    assert SK.design()["MAX_JOINTS"] == SK.MAX_JOINTS
