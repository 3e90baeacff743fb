"""Camera / floor geometry of humor_torch (fitting/geometry.py) against
humor_tpu/fitting/geometry.py on the CPU: every function's values and
the gradient of a seeded random projection of its outputs, both sign
branches of parse_floor_plane, the near-parallel guard of the plane
intersection and the z guard of the projection, and the apply_cam2prior
forward/inverse round trip.

Tolerances: values rtol 1e-5, atol 1e-5; gradients 1e-4 of their max
(float32; rotmat_to_aa and the cross products run in another operation
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.fitting import geometry as JG

from humor_torch.fitting import geometry as TG


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5, err_msg=err_msg)


def _check(jfn, tfn, args, seed=0):
    """Values of jfn/tfn on the same float32 numpy args (tuples of
    outputs allowed), and the gradients of sum(c * outputs) for seeded
    random c with respect to every arg."""
    rng = np.random.RandomState(seed)
    jout = jfn(*[jnp.asarray(a) for a in args])
    jout = jout if isinstance(jout, (tuple, list)) else (jout,)
    cs = [rng.randn(*np.shape(o)).astype(np.float32) for o in jout]

    def jscalar(*a):
        o = jfn(*a)
        o = o if isinstance(o, (tuple, list)) else (o,)
        return sum(jnp.sum(jnp.asarray(c) * x) for c, x in zip(cs, o))

    jgrads = jax.grad(jscalar, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    tout = tout if isinstance(tout, (tuple, list)) else (tout,)
    for i, (a, b) in enumerate(zip(tout, jout)):
        _close(a.detach().numpy(), b, f"output {i}")
    sum((torch.tensor(c) * x).sum() for c, x in zip(cs, tout)).backward()
    for i, (t, g) in enumerate(zip(targs, jgrads)):
        g = np.asarray(g)
        tg = np.zeros_like(g) if t.grad is None else t.grad.numpy()
        scale = np.abs(g).max() + 1e-12
        np.testing.assert_allclose(tg / scale, g / scale,
                                   atol=1e-4, err_msg=f"grad of arg {i}")


def _plane(rng, n, flip):
    normal = rng.randn(n, 3)
    normal[:, 1] = np.abs(normal[:, 1]) * (1 if flip else -1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    off = rng.rand(n, 1) + 0.5
    return np.concatenate([normal, off], -1).astype(np.float32)


def test_bdot():
    rng = np.random.RandomState(0)
    a, b = (rng.randn(4, 5, 3).astype(np.float32) for _ in range(2))
    _check(lambda x, y: JG.bdot(x, y, keepdims=True),
           lambda x, y: TG.bdot(x, y, keepdim=True), (a, b))


def test_compute_plane_intersection():
    """Random rays; then a ray exactly parallel to its plane (the 1e-12
    guard, values only: its gradients are 1e12-scale in both)."""
    rng = np.random.RandomState(1)
    plane = _plane(rng, 6, flip=False)
    point = rng.randn(6, 3).astype(np.float32)
    direction = rng.randn(6, 3).astype(np.float32)
    _check(JG.compute_plane_intersection, TG.compute_plane_intersection,
           (point, direction, plane))
    plane[0, :3] = [0.0, -1.0, 0.0]
    direction[0] = [1.0, 0.0, 0.5]
    ref = JG.compute_plane_intersection(*[jnp.asarray(a) for a in (
        point, direction, plane)])
    out = TG.compute_plane_intersection(*[torch.tensor(a) for a in (
        point, direction, plane)])
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert abs(float(out[1][0])) > 1e11


@pytest.mark.parametrize("flip", [False, True])
def test_parse_and_make_floor_plane(flip):
    """Both sign branches: a normal with positive camera y is flipped."""
    rng = np.random.RandomState(2)
    p4 = _plane(rng, 5, flip)
    fp3 = (p4[:, :3] * p4[:, 3:]).astype(np.float32)
    _check(JG.parse_floor_plane, TG.parse_floor_plane, (fp3,))
    out = TG.parse_floor_plane(torch.tensor(fp3))
    assert np.all(out[:, 1].numpy() <= 0.0)
    assert np.all((out[:, 3].numpy() < 0) == flip)
    _check(JG.make_floor_plane_3d, TG.make_floor_plane_3d,
           (p4[:, :3].copy(), p4[:, 3].copy()))
    back = TG.make_floor_plane_3d(out[:, :3], out[:, 3])
    _close(back.numpy(), fp3)


def _c2p_inputs(seed):
    rng = np.random.RandomState(seed)
    fp = np.asarray([[0.0, 1.5, 0.0], [0.1, -1.2, 0.2], [-0.2, 1.0, 0.1]],
                    np.float32)
    trans = (rng.randn(3, 3) * 0.3 + [0.0, 0.3, 2.5]).astype(np.float32)
    root = (rng.randn(3, 3) * 0.5).astype(np.float32)
    joints = (rng.randn(3, 22, 3) * 0.3 + trans[:, None]).astype(np.float32)
    return fp, trans, root, joints


def test_compute_cam2prior():
    _check(JG.compute_cam2prior, TG.compute_cam2prior, _c2p_inputs(3))


def _root_z(lib):
    """A body-free stand-in for the SMPL root-joint pass."""
    return lambda tr, ro: tr[..., 2] + 0.1 * lib.sin(ro[..., 0]) \
        + 0.05 * ro[..., 1] * ro[..., 2]


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_cam2prior(inverse):
    rng = np.random.RandomState(4)
    B, T = 3, 5
    trans = (rng.randn(B, T, 3) + [0.0, 0.3, 2.5]).astype(np.float32)
    ro = (rng.randn(B, T, 3) * 0.6).astype(np.float32)
    R, t, rh = (np.asarray(a) for a in JG.compute_cam2prior(
        *[jnp.asarray(a) for a in _c2p_inputs(5)]))
    key = np.asarray([0, 2, 4], np.int32)

    def jfn(tr, o, R_, t_, h):
        out = JG.apply_cam2prior(tr, o, R_, t_, h, jnp.asarray(key),
                                 None if inverse else _root_z(jnp),
                                 inverse=inverse)
        return out["trans"], out["root_orient"]

    def tfn(tr, o, R_, t_, h):
        out = TG.apply_cam2prior(tr, o, R_, t_, h, torch.tensor(key),
                                 None if inverse else _root_z(torch),
                                 inverse=inverse)
        return out["trans"], out["root_orient"]

    _check(jfn, tfn, (trans, ro, R, t, rh))


def test_apply_cam2prior_round_trip():
    """Camera -> prior (with the height offset) -> camera returns the
    camera-frame parameters when the map is the one compute_cam2prior
    gives at the key frame (t = -trans at frame 0), as in the fit."""
    rng = np.random.RandomState(6)
    B, T = 3, 4
    fp, _, _, joints = _c2p_inputs(7)
    trans = (rng.randn(B, T, 3) + [0.0, 0.3, 2.5]).astype(np.float32)
    ro = (rng.randn(B, T, 3) * 0.6).astype(np.float32)
    R, t, rh = TG.compute_cam2prior(torch.tensor(fp), torch.tensor(trans[:, 0]),
                                    torch.tensor(ro[:, 0]),
                                    torch.tensor(joints))
    key = torch.zeros(B, dtype=torch.long)
    fwd = TG.apply_cam2prior(torch.tensor(trans), torch.tensor(ro), R, t, rh,
                             key, _root_z(torch))
    back = TG.apply_cam2prior(fwd["trans"], fwd["root_orient"], R, t, rh, key,
                              inverse=True)
    _close(back["trans"].numpy(), trans)
    Rin = TG.transforms.aa_to_rotmat(torch.tensor(ro))
    Rout = TG.transforms.aa_to_rotmat(back["root_orient"])
    _close(Rout.numpy(), Rin.numpy())


def test_rigid_transform_smpl_params():
    rng = np.random.RandomState(8)
    B, T = 2, 4
    trans = rng.randn(B, T, 3).astype(np.float32)
    ro = (rng.randn(B, T, 3) * 0.6).astype(np.float32)
    j0 = rng.randn(B, 3).astype(np.float32)
    R = np.asarray(JG.transforms.aa_to_rotmat(
        jnp.asarray(rng.randn(B, 3).astype(np.float32))))
    t = rng.randn(B, 3).astype(np.float32)
    _check(JG.rigid_transform_smpl_params, TG.rigid_transform_smpl_params,
           (trans, ro, j0, R, t))
    # unbatched R, t
    a, b = TG.rigid_transform_smpl_params(*[torch.tensor(x) for x in (
        trans, ro, j0, R[0], t[0])])
    ra, rb = JG.rigid_transform_smpl_params(*[jnp.asarray(x) for x in (
        trans, ro, j0, R[0], t[0])])
    _close(a.numpy(), ra)
    _close(b.numpy(), rb)


def test_perspective_projection():
    """Random points in front of a random camera, one at z = 0 (the
    1e-9 guard; its value only is compared: the guard's gradient is
    1/1e-9-scale in both)."""
    rng = np.random.RandomState(9)
    B, N = 3, 7
    pts = (rng.randn(B, N, 3) + [0.0, 0.0, 3.0]).astype(np.float32)
    R = np.asarray(JG.transforms.aa_to_rotmat(
        jnp.asarray(rng.randn(B, 3).astype(np.float32) * 0.1)))
    t = (rng.randn(B, 3) * 0.1).astype(np.float32)
    f = np.tile([[500.0, 510.0]], (B, 1)).astype(np.float32)
    c = np.tile([[320.0, 240.0]], (B, 1)).astype(np.float32)
    _check(JG.perspective_projection, TG.perspective_projection,
           (pts, R, t, f, c))
    eye = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    zero = np.zeros((B, 3), np.float32)
    flat = pts.copy()
    flat[0, 0, 2] = 0.0
    ref = JG.perspective_projection(*[jnp.asarray(a) for a in (
        flat, eye, zero, f, c)])
    out = TG.perspective_projection(*[torch.tensor(a) for a in (
        flat, eye, zero, f, c)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
