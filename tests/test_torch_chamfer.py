"""Nearest-neighbour distance of humor_torch (ops/chamfer.py) against
humor_tpu/ops/chamfer.py on the CPU: the plain version against JAX's
`nn_distance` (the XLA form) and the Pallas kernel in interpret mode, at
sizes off every tile multiple, with 1e6-padded queries and duplicated
points; the custom gradient against `jax.grad` through JAX's custom VJP.
The CUDA kernel against the plain version is in
test_torch_cuda_kernels.py, which imports no JAX and so also runs on a
machine with a GPU and no JAX; here the kernel's order of operations,
reproduced in float32 torch, is held against the plain version under the
rule chip_smoke.py applies on the card.

Tolerances: distances rtol 1e-4, atol 1e-5 (the JAX tests' own; the two
sum the 3-term cross product in different orders); indices exact on
visible queries (random clouds have no near-ties at this size); padded
queries' neighbours are rounding noise in both packages and are not
compared. Gradients rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from humor_tpu.ops import chamfer as JC

from humor_torch.ops import chamfer as TC


def _clouds(b, n, m, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


def _plain(x, y):
    d, i = TC.nn_distance_plain(torch.tensor(x), torch.tensor(y))
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("shape", [(2, 300, 1100), (3, 57, 2500)])
def test_plain_matches_jax(shape):
    x, y = _clouds(*shape, seed=2)
    d_ref, i_ref = JC.nn_distance(jnp.asarray(x), jnp.asarray(y))
    d, i = _plain(x, y)
    np.testing.assert_allclose(d, np.asarray(d_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(i, np.asarray(i_ref))


def test_plain_matches_pallas_interpret():
    x, y = _clouds(2, 300, 1100, seed=3)
    d_ref, i_ref = JC._nn_pallas(jnp.asarray(x), jnp.asarray(y),
                                 interpret=True)
    d, i = _plain(x, y)
    np.testing.assert_allclose(d, np.asarray(d_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(i, np.asarray(i_ref))


def test_padded_queries():
    """Queries at 1e6 (how the point-cloud energy hides missing points):
    the visible ones agree with JAX in distance and index."""
    x, y = _clouds(2, 200, 700, seed=4)
    x[:, 150:] = 1e6
    d_ref, i_ref = JC.nn_distance(jnp.asarray(x), jnp.asarray(y))
    d, i = _plain(x, y)
    np.testing.assert_allclose(d[:, :150], np.asarray(d_ref)[:, :150],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(i[:, :150], np.asarray(i_ref)[:, :150])
    assert np.all(np.isfinite(d)) and np.all((i >= 0) & (i < 700))


def test_duplicates_take_first_index(monkeypatch):
    """Duplicated points: the lowest index wins, within a chunk and across
    the plain version's chunks of M and of clouds (chunks made small)."""
    x, y = _clouds(3, 40, 900, seed=5)
    for b in range(3):
        for n in range(0, 40, 4):
            k = 3 + 7 * n
            y[b, k] = x[b, n] + 1e-3
            y[b, k + 300] = y[b, k]        # next chunk of M
            y[b, k + 1] = y[b, k]          # same chunk
    monkeypatch.setattr(TC, "_CHUNK_M", 256)
    monkeypatch.setattr(TC, "_PLAIN_CHUNK_ELEMS", 40 * 256)
    d, i = _plain(x, y)
    d_ref, i_ref = JC.nn_distance(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(d, np.asarray(d_ref), rtol=1e-4, atol=1e-5)
    for n in range(0, 40, 4):
        assert np.all(i[:, n] == 3 + 7 * n)


def test_gradients_match_jax():
    """d sum(w * dist) / d(xyz1, xyz2) through the autograd Function vs
    jax.grad through the custom VJP."""
    x, y = _clouds(2, 120, 90, seed=6)
    w = np.random.RandomState(7).rand(2, 120).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jnp.asarray(w) * JC.nn_distance(a, b)[0])

    gx_ref, gy_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(y))
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    d, idx = TC.nn_distance(tx, ty)
    assert not idx.requires_grad
    (torch.tensor(w) * d).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy_ref),
                               rtol=1e-4, atol=1e-5)


def test_chamfer_distance_matches_jax():
    x, y = _clouds(2, 80, 130, seed=8)
    r1, r2 = JC.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
    d1, d2 = TC.chamfer_distance(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(d1.numpy(), np.asarray(r1), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(r2), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["float64", "rank", "batch", "strided"])
def test_wrapper_checks_inputs(bad):
    """The wrapper refuses what the kernel does not take instead of
    converting it."""
    x, y = (torch.tensor(a) for a in _clouds(2, 10, 12, seed=9))
    if bad == "float64":
        x = x.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "batch":
        y = y[:1]
    else:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        TC.nn_forward(x, y)


# The CUDA kernel's arithmetic (csrc/nn_distance.cu), reproduced in float32
# torch on the CPU, against the plain version under chip_smoke.py's rule.
_KERNEL_CHUNK = chip_smoke.nn_design()["C"]


def _fma(a, b, c):
    """float32 fused multiply-add: the product is exact in float64 and the
    sum is rounded once to float32 (it equals the FMA unless float64 had to
    round the sum too, which these magnitudes do not reach)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order(x, y):
    """nn_distance.cu's order of operations: points staged as
    (-2y, |y|^2 = fma(y0, y0, fma(y1, y1, y2*y2))), d' = fma(x0, a,
    fma(x1, b, fma(x2, c, w))), the min of each 32-point chunk, the first
    chunk strictly below the running best, the first point of that chunk
    whose d' equals the best, then |x|^2 + best clamped at 0. Returns
    (dist, idx, d') with d' (B, N, M)."""
    B, N, _ = x.shape
    M = y.shape[1]
    a = (-2.0 * y)[:, None]
    w = _fma(y[..., 0], y[..., 0], _fma(y[..., 1], y[..., 1],
                                        y[..., 2] * y[..., 2]))[:, None]
    xs = [x[..., k, None] for k in range(3)]
    dp = _fma(xs[0], a[..., 0], _fma(xs[1], a[..., 1],
                                     _fma(xs[2], a[..., 2], w)))
    pad = -M % _KERNEL_CHUNK
    chunks = torch.cat([dp, torch.full((B, N, pad), float("inf"))], -1
                       ).reshape(B, N, -1, _KERNEL_CHUNK)
    cm = chunks.amin(-1)
    best = torch.full((B, N), float("inf"))
    best_chunk = torch.zeros(B, N, dtype=torch.long)
    for k in range(cm.shape[-1]):
        take = cm[..., k] < best
        best = torch.where(take, cm[..., k], best)
        best_chunk = torch.where(take, k, best_chunk)
    rescan = torch.gather(chunks, 2, best_chunk[..., None, None].expand(
        -1, -1, 1, _KERNEL_CHUNK))[:, :, 0]
    first = (rescan == best[..., None]).int().argmax(-1)
    idx = best_chunk * _KERNEL_CHUNK + first
    sqx = _fma(xs[0][..., 0], xs[0][..., 0],
               _fma(xs[1][..., 0], xs[1][..., 0],
                    xs[2][..., 0] * xs[2][..., 0]))
    return torch.clamp(sqx + best, min=0.0), idx, dp


@pytest.mark.parametrize("shape", [(2, 300, 700), (1, 129, 33),
                                   (3, 100, 1000)])
def test_kernel_arithmetic_matches_plain(shape):
    """Fit-like clouds: a body-sized cloud ~2.5 m from the camera, queries
    its points with 1 cm noise, 10% of them at 1e6, points duplicated in
    one chunk and across chunks with queries 1 mm from them. Distances
    within 1e-5 on visible queries, index mismatches only at float64
    near-ties within 1e-5, the first index on the duplicates, and the
    chunked argmin equal to the first argmin of d' everywhere."""
    b, n, m = shape
    rng = np.random.RandomState(11 + m)
    y = rng.randn(b, m, 3) * [0.25, 0.5, 0.15] + [0.0, 0.3, 2.5]
    x = np.take_along_axis(y, rng.randint(0, m, (b, n, 1)), 1) \
        + rng.randn(b, n, 3) * 0.01
    dup = [(j, k) for j, k in ((3, 4), (5, m - 1), (9, m // 2)) if k > j]
    for q, (j, k) in enumerate(dup):
        y[:, k] = y[:, j]
        x[:, q] = y[:, j] + 1e-3
    n_vis = n - n // 10
    x[:, n_vis:] = 1e6
    xt = torch.tensor(x, dtype=torch.float32)
    yt = torch.tensor(y, dtype=torch.float32)
    d_k, i_k, dp = _kernel_order(xt, yt)
    d_p, i_p = TC.nn_distance_plain(xt, yt)
    np.testing.assert_array_equal(i_k.numpy(), dp.argmin(-1).numpy())
    np.testing.assert_allclose(d_k[:, :n_vis].numpy(), d_p[:, :n_vis].numpy(),
                               rtol=0, atol=1e-5)
    q64, y64 = xt[:, :n_vis].double(), yt.double()

    def d64(i):
        nn = torch.gather(y64, 1, i[:, :n_vis, None].long().expand(-1, -1, 3))
        return ((q64 - nn) ** 2).sum(-1)

    differ = i_k[:, :n_vis] != i_p[:, :n_vis].long()
    gap = (d64(i_k) - d64(i_p)).abs()[differ]
    assert gap.numel() == 0 or float(gap.max()) <= 1e-5
    for q, (j, _) in enumerate(dup):
        assert np.all(i_k[:, q].numpy() == j)
        assert np.all(i_p[:, q].numpy() == j)
    assert bool(torch.isfinite(d_k).all())
    assert bool(((i_k >= 0) & (i_k < m)).all())
