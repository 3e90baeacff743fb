"""humor_torch.fitting.lbfgs's zoom line search, its convergence early
exit and the runner's hybrid polish against humor_tpu's, on the problems
of tests/test_torch_lbfgs.py:

  * zoom on the quadratic, plain and with a gradient mask: per-iteration
    losses within 1e-5 relative while they move (past convergence both
    sit in the monotone safeguard's band), end points within 1e-4;
  * zoom on Rosenbrock from (-1.2, 1): both reach the same optimum within
    1e-3. Float32 rounding of a different dot order parts the paths after
    a few iterations (the cubic and quadratic steps compare nearly equal
    numbers), so the path is held in float64, where the two packages take
    the same branches and their histories agree within 1e-5 over the
    first 30 iterations (the chain amplifies float64 rounding to ~2e-6);
  * the early exit (tol_grad; tol_change with stall_patience): the same
    trip count, the unreached tail filled with the final value, and a NaN
    loss kept in the history;
  * the hybrid polish: the zoom iterations the runner gives a stage, for
    stage budgets {0, 4, 5, 30, 70}, read from both runners' L-BFGS calls.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.fitting import lbfgs as JL
from humor_tpu.fitting import optimizer as JO

from humor_torch.fitting import lbfgs as TL
from humor_torch.fitting import optimizer as TO

from test_torch_lbfgs import (masked_j, masked_t, quad_j, quad_t, rosen_j,
                              rosen_t)
from test_torch_tto import models  # noqa: F401

torch.set_num_threads(2)

ROSEN0 = np.array([-1.2, 1.0], np.float32)


def _run_both(fj, ft, init, iters, mask=None, **kw):
    rj = JL.run_lbfgs(fj, {k: jnp.asarray(v) for k, v in init.items()},
                      num_iters=iters, linesearch="zoom",
                      mask=None if mask is None else
                      JL.make_mask(init, lambda k: mask[k] > 0), **kw)
    rt = TL.run_lbfgs(ft, {k: torch.tensor(v) for k, v in init.items()},
                      iters, mask=mask, linesearch="zoom", **kw)
    return rj, rt


@pytest.mark.parametrize("problem", ["quadratic", "masked"])
def test_zoom_matches_jax(problem):
    if problem == "quadratic":
        fj, ft, init, mask = quad_j, quad_t, {"x": np.zeros(3)}, None
    else:
        fj, ft, mask = masked_j, masked_t, {"a": 1.0, "b": 0.0}
        init = {"a": np.zeros(2), "b": np.zeros(2)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    rj, rt = _run_both(fj, ft, init, 20, mask)
    hj, ht = np.asarray(rj.loss_history), rt.loss_history.numpy()
    opt = float(hj.min())
    band = 1e-4 * abs(opt) + 1e-6
    moving = hj > opt + band
    assert moving.sum() >= 2
    np.testing.assert_allclose(ht[moving], hj[moving], rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(ht[~moving] - opt) <= 2 * band)
    for k in init:
        np.testing.assert_allclose(rt.params[k].numpy(),
                                   np.asarray(rj.params[k]), atol=1e-4)
    if mask is not None:
        np.testing.assert_array_equal(rt.params["b"].numpy(), 0.0)


def test_zoom_rosenbrock_same_optimum():
    rj, rt = _run_both(rosen_j, rosen_t, {"xy": ROSEN0}, 60)
    np.testing.assert_allclose(rt.params["xy"].numpy(),
                               np.asarray(rj.params["xy"]), atol=1e-3)
    np.testing.assert_allclose(rt.params["xy"].numpy(), [1.0, 1.0],
                               atol=1e-3)


def test_zoom_rosenbrock_path_float64():
    """The same problem in float64: the zoom's interval search, cubic,
    quadratic and bisection branches and the approximate-Wolfe switch
    take the same decisions in both packages."""
    init = ROSEN0.astype(np.float64)
    with jax.enable_x64(True):
        rj = JL.run_lbfgs(rosen_j, {"xy": jnp.asarray(init)}, num_iters=30,
                          linesearch="zoom")
        hj = np.asarray(rj.loss_history)
    assert hj.dtype == np.float64
    rt = TL.run_lbfgs(rosen_t, {"xy": torch.tensor(init)}, 30,
                      linesearch="zoom")
    np.testing.assert_allclose(rt.loss_history.numpy(), hj, rtol=1e-5)


def _trip(hist: np.ndarray) -> int:
    """Iterations run: the history's length less its tail of copies of
    the final value."""
    n = len(hist)
    while n > 1 and hist[n - 1] == hist[-1] and hist[n - 2] == hist[-1]:
        n -= 1
    return n


@pytest.mark.parametrize("tols", [
    dict(tol_grad=1e-2),
    dict(tol_change=1e-3, stall_patience=2),
    dict(tol_grad=0.5, tol_change=1e-4, stall_patience=1)])
@pytest.mark.parametrize("linesearch", ["zoom", "parallel"])
def test_early_exit_matches_jax(tols, linesearch):
    """The quadratic stops at the same iteration in both packages and
    fills the rest of its history with the final value."""
    init = np.zeros(3, np.float32)
    rj = JL.run_lbfgs(quad_j, {"x": jnp.asarray(init)}, num_iters=25,
                      linesearch=linesearch, **tols)
    rt = TL.run_lbfgs(quad_t, {"x": torch.tensor(init)}, 25,
                      linesearch=linesearch, **tols)
    hj, ht = np.asarray(rj.loss_history), rt.loss_history.numpy()
    assert ht.shape == (25,)
    n = _trip(hj)
    assert 1 < n < 24, hj
    assert _trip(ht) == n
    np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ht[n:], ht[-1])
    np.testing.assert_allclose(rt.params["x"].numpy(),
                               np.asarray(rj.params["x"]), atol=1e-4)


def test_early_exit_keeps_nan():
    """A loss that is NaN from the start: every step is rejected, the
    stall counter fires after `stall_patience` iterations, and the NaN
    stays in the history as in JAX's."""
    def fj(p):
        return jnp.sum(jnp.sqrt(p["x"] - 1.0))

    def ft(p):
        return torch.sqrt(p["x"] - 1.0).sum(-1)

    init = np.zeros(2, np.float32)
    kw = dict(tol_change=1e-6, stall_patience=2)
    rj = JL.run_lbfgs(fj, {"x": jnp.asarray(init)}, num_iters=6,
                      linesearch="zoom", **kw)
    rt = TL.run_lbfgs(ft, {"x": torch.tensor(init)}, 6, linesearch="zoom",
                      **kw)
    hj, ht = np.asarray(rj.loss_history), rt.loss_history.numpy()
    assert np.isnan(hj).all()
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(rt.params["x"].numpy(), init)


def _closure_fn(fn, name, seen=None):
    """The function called `name` among those `fn` closes over (through
    jit wrappers), depth first."""
    seen = set() if seen is None else seen
    for f in (fn, getattr(fn, "__wrapped__", None)):
        if f is None or id(f) in seen:
            continue
        seen.add(id(f))
        if getattr(f, "__name__", "") == name:
            return f
        for cell in getattr(f, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if callable(v):
                found = _closure_fn(v, name, seen)
                if found is not None:
                    return found
    return None


@pytest.mark.parametrize("iters", [0, 4, 5, 30, 70])
def test_hybrid_polish_matches_jax(iters, models, monkeypatch):
    """Each runner's stage L-BFGS with lbfgs_linesearch="hybrid", with
    its run_lbfgs replaced by a recorder: the same (search, iterations)
    calls in both, the histories joined."""
    calls = {"jax": [], "torch": []}

    def fake_j(loss_fn, v, n, *a, linesearch="parallel", **kw):
        calls["jax"].append((linesearch, n))
        return JL.LbfgsResult(v, jnp.zeros(()), jnp.full((n,), len(
            calls["jax"]), jnp.float32), None)

    def fake_t(loss_fn, v, n, linesearch="parallel", **kw):
        calls["torch"].append((linesearch, n))
        return TL.LbfgsResult(v, torch.zeros(()), torch.full(
            (n,), float(len(calls["torch"]))))

    monkeypatch.setattr(JO, "run_lbfgs", fake_j)
    monkeypatch.setattr(TO, "run_lbfgs", fake_t)
    jm, tm = models
    kw = dict(seq_len=4, lbfgs_linesearch="hybrid", lbfgs_polish_frac=0.08)
    jrun = JO.make_runner(JO.TTOConfig(**kw), jm, fuse=True)
    jl = _closure_fn(jrun, "_lbfgs")
    assert jl is not None
    obs_j = {"joints3d": jnp.zeros((2, 4, 22, 3))}
    hj = jl(lambda v, o: 0.0, {"x": jnp.zeros(3)}, iters, obs_j).loss_history
    trun = TO.make_runner(TO.TTOConfig(**kw), tm, device="cpu")
    tl = _closure_fn(trun, "_lbfgs")
    obs_t = {"joints3d": torch.zeros(2, 4, 22, 3)}
    _, ht = tl(lambda v, o: v["x"].sum(-1), {"x": torch.zeros(2, 3)}, iters,
               obs_t, lambda k: True, 0)
    if iters == 0:   # the port skips a stage without iterations
        assert calls["torch"] == [] and ht.numel() == 0
        assert calls["jax"] == [("parallel", 0)]
        return
    assert calls["torch"] == calls["jax"]
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    polish = TO.hybrid_polish_iters(iters, 0.08)
    assert sum(n for ls, n in calls["torch"] if ls == "zoom") == polish
    assert math.isclose(sum(n for _, n in calls["torch"]), iters)
