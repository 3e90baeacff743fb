"""Nearest-neighbour distance of humor_torch (ops/chamfer.py) against
humor_tpu/ops/chamfer.py on the CPU: the plain version against JAX's
`nn_distance` (the XLA form) and the Pallas kernel in interpret mode, at
sizes off every tile multiple, with 1e6-padded queries and duplicated
points; the custom gradient against `jax.grad` through JAX's custom VJP.
The CUDA kernel against the plain version is in
test_torch_cuda_kernels.py, which imports no JAX and so also runs on a
machine with a GPU and no JAX.

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
