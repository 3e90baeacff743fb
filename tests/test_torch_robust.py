"""Robust weighting of humor_torch (fitting/robust.py) against
humor_tpu/fitting/robust.py on the CPU: the masked median (odd, even,
empty and tied rows), the MAD scale, bisquare weights at and past the
cut, the weighting with no gradient through the weights, and GMoF.

Tolerances: values rtol 1e-6, atol 1e-7 (the same float32 operations in
the same order; the median picks the same sorted entries); gradients
rtol 1e-5 (XLA fuses GMoF's derivative into another operation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.fitting import robust as JR

from humor_torch.fitting import robust as TR

TOL = dict(rtol=1e-6, atol=1e-7)


def _rows():
    """Rows of 6: an odd count, an even count, an empty row, ties."""
    x = np.asarray([[3.0, -1.0, 7.0, 2.0, 9.0, 4.0],
                    [0.5, 8.0, -2.0, 6.0, 1.0, 3.0],
                    [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
                    [2.0, 2.0, 5.0, 2.0, 2.0, 7.0]], np.float32)
    m = np.asarray([[1, 1, 1, 0, 1, 1],     # 5 valid
                    [1, 1, 1, 1, 0, 0],     # 4 valid: interpolated middle
                    [0, 0, 0, 0, 0, 0],     # none: 0
                    [1, 1, 1, 1, 1, 1]], bool)
    return x, m


def test_masked_median_matches_jax():
    x, m = _rows()
    ref = JR.masked_median(jnp.asarray(x), jnp.asarray(m))
    out = TR.masked_median(torch.tensor(x), torch.tensor(m))
    assert out.shape == (4, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[:, 0], [4.0, 3.25, 0.0, 2.0])


@pytest.mark.parametrize("masked", [False, True])
def test_robust_std_matches_jax(masked):
    rng = np.random.RandomState(0)
    res = rng.randn(3, 50).astype(np.float32)
    mask = rng.rand(3, 50) > 0.3 if masked else None
    ref = JR.robust_std(jnp.asarray(res),
                        None if mask is None else jnp.asarray(mask))
    out = TR.robust_std(torch.tensor(res),
                        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bisquare_weights_at_and_past_the_cut():
    """Inliers get (1 - u^2)^2, the outliers past the cut exactly 0, a
    residual at the cut 0 (norm_res >= 1). The at-cut residual sits in a
    masked-out slot, which gets a weight but does not move the scale."""
    rng = np.random.RandomState(1)
    res = np.abs(rng.randn(2, 40)).astype(np.float32) * 0.01
    res[:, :3] = [5.0, -7.0, 3.0]               # outliers
    mask = np.ones_like(res, bool)
    mask[1, 30:] = False
    scale = (TR.robust_std(torch.tensor(res), torch.tensor(mask))
             * TR.BISQUARE_TUNE_CONST).numpy()
    res[1, 35] = scale[1, 0]                     # at the cut
    ref = JR.bisquare_robust_weights(jnp.asarray(res), mask=jnp.asarray(mask))
    out = TR.bisquare_robust_weights(torch.tensor(res),
                                     mask=torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out.numpy()[:, :3] == 0.0)
    assert out.numpy()[1, 35] == 0.0
    assert np.all(out.numpy()[:, 3:30] > 0.0)


@pytest.mark.parametrize("kind", ["bisquare", "none"])
def test_apply_robust_weighting_matches_jax(kind):
    """Values, weights, and a gradient that treats the weights as
    constants (2 w res)."""
    rng = np.random.RandomState(2)
    res = rng.randn(2, 30).astype(np.float32)
    res[0, 0] = 20.0
    mask = rng.rand(2, 30) > 0.2

    def jfn(r):
        wr, _ = JR.apply_robust_weighting(r, kind, mask=jnp.asarray(mask))
        return jnp.sum(wr)

    (wr_ref, w_ref) = JR.apply_robust_weighting(jnp.asarray(res), kind,
                                                mask=jnp.asarray(mask))
    g_ref = jax.grad(jfn)(jnp.asarray(res))
    t = torch.tensor(res, requires_grad=True)
    wr, w = TR.apply_robust_weighting(t, kind, mask=torch.tensor(mask))
    assert not w.requires_grad
    wr.sum().backward()
    np.testing.assert_allclose(wr.detach().numpy(), np.asarray(wr_ref), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), 2.0 * w.numpy() * res,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        TR.apply_robust_weighting(t, "huber")


def test_gmof_matches_jax():
    rng = np.random.RandomState(3)
    res = (rng.randn(4, 25, 2) * 150.0).astype(np.float32)
    ref = JR.gmof(jnp.asarray(res), 100.0)
    g_ref = jax.grad(lambda r: jnp.sum(JR.gmof(r, 100.0)))(jnp.asarray(res))
    t = torch.tensor(res, requires_grad=True)
    out = TR.gmof(t, 100.0)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-7)
