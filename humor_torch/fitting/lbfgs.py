"""L-BFGS for test-time optimization (port of
humor_tpu/fitting/lbfgs.py: the "parallel", "armijo" and "zoom" line
searches and the convergence early exit).

The variables are a dict of tensors, flattened into one vector for the
optimizer. The L-BFGS direction is the two-loop recursion of
optax.scale_by_lbfgs (same memory layout, same initial scaling: a capped
1/|g| on the first step, then s.y / y.y).

`loss_fn` is evaluated for K candidate points at once: it receives the
variables with a leading candidate axis (every leaf (K, ...)) and
returns the K losses. One backward of their sum gives every candidate's
gradient, since candidates share nothing. This is how the TTO folds the
line-search grid into its window batch (JAX vmaps the closure).

  * "parallel": one value+grad evaluation of a log-spaced step grid per
    iteration, recentered on the last accepted step; the largest
    strong-Wolfe candidate is taken, else the best finite point.
  * "armijo": the grid is evaluated for values only, the largest Armijo
    candidate is taken, then one value+grad at the accepted point.
  * "zoom": optax's sequential strong-Wolfe zoom search
    (scale_by_zoom_linesearch with initial guess 1, optax 0.2.6): each
    probe is one value+grad evaluation at K=1; the accepted probe's value
    and gradient feed the next iteration.

All keep the best-iterate return, the monotone safeguard with a restart
of the curvature memory, and gradient masks; the parallel and armijo
searches keep the memory only after a step that passed the curvature
condition.

With `tol_grad` or `tol_change` the iterations stop early, as JAX's
while loop does: once the masked gradient's inf-norm is <= tol_grad, or
after `stall_patience` consecutive iterations that each moved the
variables by <= tol_change (inf-norm). The unreached tail of the loss
history is filled with the final value.

With `reduce` (a parallel.mesh.Mesh) the variables are split over ranks
(the windows-sharded fit): each rank holds its shard of the flat vector,
and `loss_fn` returns its share of each candidate's loss. Every quantity
the search branches on or scales by is then reduced over ranks: the
candidate losses (sum), every dot product and norm of the two-loop
recursion and of the line searches' slopes (sum), and the early exit's
inf-norms (max). So every rank takes the same branch at each host
decision (`_select_memory`'s count, the zoom search's), as a rank that
decided from its own shard would deadlock or diverge. Without `reduce`
the arithmetic is the single-device one, unchanged.

Spans (utils/profiling, recorded only inside `profiling.recording()`):
"lbfgs.iter" an iteration, in three parts, "lbfgs.direction" (the best
iterate and the two-loop direction), "lbfgs.search" and "lbfgs.update"
(the safeguard, the memory's selection and the early exit's reads);
"lbfgs.forward" and "lbfgs.backward" around each evaluation's `loss_fn`
and gradient. Counters: "lbfgs.evaluations", "lbfgs.points" (candidate
rows evaluated) and "lbfgs.zoom_probes".
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from humor_torch.parallel import mesh as P
from humor_torch.utils import profiling as PR

_C1, _C2 = 1e-4, 0.9


class LbfgsResult(NamedTuple):
    params: Dict[str, torch.Tensor]
    loss: torch.Tensor          # loss at the returned params
    loss_history: torch.Tensor  # (num_iters,) loss at the start of each iter


def candidate_multipliers(num: int) -> List[float]:
    """Log-spaced multipliers from 8 down to 0.008 (jnp.geomspace)."""
    if num == 1:
        return [8.0]
    lo, hi = math.log10(0.008), math.log10(8.0)
    return [10.0 ** (hi + (lo - hi) * i / (num - 1)) for i in range(num)]


def make_mask(params: Dict[str, torch.Tensor],
              trainable: Callable[[str], bool]) -> Dict[str, float]:
    return {k: 1.0 if trainable(k) else 0.0 for k in params}


class _Flat:
    """Dict of tensors <-> one flat vector."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.keys = list(params)
        self.shapes = [params[k].shape for k in self.keys]
        self.sizes = [params[k].numel() for k in self.keys]

    def flat(self, params) -> torch.Tensor:
        return torch.cat([params[k].reshape(-1) for k in self.keys])

    def unflat(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """vec (..., P) -> dict of (..., *shape)."""
        lead = vec.shape[:-1]
        out, o = {}, 0
        for k, shp, n in zip(self.keys, self.shapes, self.sizes):
            out[k] = vec[..., o:o + n].reshape(*lead, *shp)
            o += n
        return out

    def mask(self, mask, like: torch.Tensor) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return torch.cat([torch.full((n,), float(mask[k]), dtype=like.dtype,
                                     device=like.device)
                          for k, n in zip(self.keys, self.sizes)])


class _LbfgsMemory:
    """State of optax.scale_by_lbfgs on flat vectors."""

    def __init__(self, like: torch.Tensor, m: int):
        self.m = m
        P = like.shape[0]
        self.count = 0
        self.params = torch.zeros_like(like)
        self.updates = torch.zeros_like(like)
        self.dparams = torch.zeros(m, P, dtype=like.dtype, device=like.device)
        self.dupdates = torch.zeros_like(self.dparams)
        self.rho = torch.zeros(m, dtype=like.dtype, device=like.device)

    def copy(self) -> "_LbfgsMemory":
        new = object.__new__(_LbfgsMemory)
        new.__dict__.update(self.__dict__)
        return new

    def direction(self, g: torch.Tensor, params: torch.Tensor,
                  dot: Callable = torch.dot, norm: Callable =
                  torch.linalg.vector_norm
                  ) -> Tuple[torch.Tensor, "_LbfgsMemory"]:
        """(-H g, updated memory); the memory is updated with the
        (params, g) pair before preconditioning, as optax does. `dot` and
        `norm` are reduced over ranks for a sharded vector."""
        m = self.m
        new = self.copy()
        idx = self.count % m
        prev = (self.count - 1) % m
        dp = params - self.params
        du = g - self.updates
        vd = dot(du, dp)
        rho = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        if self.count == 0:
            dp, du, rho = (torch.zeros_like(dp), torch.zeros_like(du),
                           torch.zeros_like(rho))
        new.dparams = self.dparams.clone()
        new.dupdates = self.dupdates.clone()
        new.rho = self.rho.clone()
        new.dparams[prev] = dp
        new.dupdates[prev] = du
        new.rho[prev] = rho
        if self.count > 0:
            den = dot(du, du)
            gamma = torch.where(den > 0.0, dot(du, dp) / den,
                                torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / norm(g), max=1.0)
        order = [(idx + i) % m for i in range(m)]
        vec = g
        alphas = {}
        for i in reversed(order):
            a = new.rho[i] * dot(new.dparams[i], vec)
            vec = vec - a * new.dupdates[i]
            alphas[i] = a
        vec = gamma * vec
        for i in order:
            b = new.rho[i] * dot(new.dupdates[i], vec)
            vec = vec + (alphas[i] - b) * new.dparams[i]
        new.count = self.count + 1
        new.params = params
        new.updates = g
        return -vec, new


def _select(ok: torch.Tensor, a, b):
    return torch.where(ok, a, b)


def _select_memory(ok: torch.Tensor, a: _LbfgsMemory, b: _LbfgsMemory
                   ) -> _LbfgsMemory:
    """Elementwise where over two memories; `count` is a host integer, so
    the choice of count syncs on `ok` (one host sync an iteration)."""
    new = a.copy()
    for k in ("params", "updates", "dparams", "dupdates", "rho"):
        setattr(new, k, torch.where(ok, getattr(a, k), getattr(b, k)))
    new.count = a.count if bool(ok) else b.count
    return new


# ---------------------------------------------------------------------------
# The zoom line search (optax/_src/linesearch.py, zoom_linesearch)
# ---------------------------------------------------------------------------

_INTERVAL_THRESHOLD = 1e-5   # scale_by_zoom_linesearch's stepsize_precision
_APPROX_DEC_RTOL = 1e-6
_INCREASE_FACTOR = 2.0


class _Zoom(NamedTuple):
    """optax's ZoomLinesearchState, without the fixed params/direction.
    Every field is a 0-d tensor but `count` and the gradients."""
    count: int
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when it has none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's error, or Hager-Zhang's approximate decrease near a
    minimum, whichever is smaller; 0 when met, inf for NaN."""
    err = value - value_init - _C1 * stepsize * slope_init
    approx = torch.maximum(
        slope - (2 * _C1 - 1.0) * slope_init,
        value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init))
    err = torch.clamp(torch.minimum(approx, err), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(torch.abs(slope) - _C2 * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def zoom_linesearch(probe: Callable, value: torch.Tensor, grad: torch.Tensor,
                    direction: torch.Tensor, max_steps: int,
                    dot: Callable = torch.dot
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step size along `direction` from the point where the loss is
    `value` with gradient `grad` -> (stepsize, value, gradient at the
    accepted probe). `probe(stepsize) -> (value, grad)` evaluates the
    loss. The initial interval search doubles the step from 1 until it
    brackets a strong-Wolfe point; the zoom then takes the cubic, else
    the quadratic, else the bisection point of the interval. It stops at
    a point meeting both conditions, after `max_steps` probes, or once
    the interval is under 1e-5 with a sufficient decrease found; a search
    that fails returns its safe point (the best probe with sufficient
    decrease, the start point when there is none), or its last probe.
    The slopes are `dot`s, reduced over ranks for a sharded vector."""
    W = torch.where
    slope = dot(direction, grad)
    zero = torch.zeros_like(value)
    inf = torch.full_like(value, math.inf)
    false = torch.zeros((), dtype=torch.bool, device=value.device)
    s = _Zoom(count=0, stepsize=zero, value=value, grad=grad, slope=slope,
              decrease_error=inf, curvature_error=inf, interval_found=false,
              done=false, failed=false, low=zero, value_low=value,
              slope_low=slope, high=zero, value_high=value, slope_high=slope,
              cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero,
              safe_value=value, safe_grad=grad)
    value_init, slope_init = value, slope

    def on_line(step):
        PR.count("lbfgs.zoom_probes")
        v, g = probe(step)
        return v, g, dot(g, direction)

    def search_interval(s: _Zoom) -> _Zoom:
        new = (torch.ones_like(value) if s.count == 0
               else _INCREASE_FACTOR * s.stepsize)
        v, g, sl = on_line(new)
        dec = _decrease_error(new, v, sl, value_init, slope_init)
        curv = _curvature_error(sl, slope_init)
        err = torch.maximum(dec, curv)
        safe = dec <= 0.0
        set_high = (dec > 0.0) | ((v >= s.value) & (s.count > 0))
        set_low = (sl >= 0.0) & ~set_high
        found = set_high | set_low | (err <= 0.0)
        done = err <= 0.0
        return s._replace(
            count=s.count + 1, stepsize=new, value=v, grad=g, slope=sl,
            decrease_error=dec, curvature_error=curv, interval_found=found,
            done=done, failed=(s.count + 1 >= max_steps) & ~done,
            low=W(set_low, new, s.stepsize),
            value_low=W(set_low, v, s.value),
            slope_low=W(set_low, sl, s.slope),
            high=W(set_low, s.stepsize, new),
            value_high=W(set_low, s.value, v),
            slope_high=W(set_low, s.slope, sl),
            cubic_ref=W(set_low, new, s.stepsize),
            value_cubic_ref=W(set_low, v, s.value),
            safe_stepsize=W(safe, new, s.safe_stepsize),
            safe_value=W(safe, v, s.safe_value),
            safe_grad=W(safe, g, s.safe_grad))

    def zoom_into_interval(s: _Zoom) -> _Zoom:
        low, high = s.low, s.high
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high,
                          s.cubic_ref, s.value_cubic_ref)
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right
                                                    - 0.2 * delta)
        quad = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (
            quad < right - 0.1 * delta)
        middle = W(use_cubic, cubic, s.cubic_ref)
        middle = W(use_quad, quad, middle)
        middle = W(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        v, g, sl = on_line(middle)
        dec = _decrease_error(middle, v, sl, value_init, slope_init)
        curv = _curvature_error(sl, slope_init)
        done = torch.maximum(dec, curv) <= 0.0
        upd_safe = (dec <= 0.0) & (v < s.safe_value)
        safe_stepsize = W(upd_safe, middle, s.safe_stepsize)
        high_to_mid = (dec > 0.0) | (v >= s.value_low)
        high_to_low = (sl * (high - low) >= 0.0) & ~high_to_mid
        low_to_mid = ~high_to_mid
        nh = W(high_to_mid, middle, high)
        nvh = W(high_to_mid, v, s.value_high)
        nsh = W(high_to_mid, sl, s.slope_high)
        moved_high = high_to_mid | high_to_low
        failed = ((s.count + 1 >= max_steps)
                  | ((delta <= _INTERVAL_THRESHOLD) & (safe_stepsize > 0.0))
                  ) & ~done
        return s._replace(
            count=s.count + 1, stepsize=middle, value=v, grad=g, slope=sl,
            decrease_error=dec, curvature_error=curv, done=done,
            failed=failed,
            low=W(low_to_mid, middle, low),
            value_low=W(low_to_mid, v, s.value_low),
            slope_low=W(low_to_mid, sl, s.slope_low),
            high=W(high_to_low, low, nh),
            value_high=W(high_to_low, s.value_low, nvh),
            slope_high=W(high_to_low, s.slope_low, nsh),
            cubic_ref=W(moved_high, high, low),
            value_cubic_ref=W(moved_high, s.value_high, s.value_low),
            safe_stepsize=safe_stepsize,
            safe_value=W(upd_safe, v, s.safe_value),
            safe_grad=W(upd_safe, g, s.safe_grad))

    # host syncs: the interval_found branch and the done|failed test, one
    # each a probe
    while True:
        s = zoom_into_interval(s) if bool(s.interval_found) \
            else search_interval(s)
        if bool(s.failed):
            take_safe = (s.safe_stepsize > 0.0) | torch.isinf(
                s.decrease_error)
            return (W(take_safe, s.safe_stepsize, s.stepsize),
                    W(take_safe, s.safe_value, s.value),
                    W(take_safe, s.safe_grad, s.grad))
        if bool(s.done):
            return s.stepsize, s.value, s.grad


# ---------------------------------------------------------------------------
# The iteration loop
# ---------------------------------------------------------------------------

def run_lbfgs(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
              init_params: Dict[str, torch.Tensor], num_iters: int,
              mask: Optional[Dict[str, float]] = None,
              history_size: int = 10, linesearch: str = "parallel",
              num_candidates: int = 8, max_linesearch_steps: int = 20,
              tol_grad: Optional[float] = None,
              tol_change: Optional[float] = None,
              stall_patience: int = 3,
              reduce: Optional[P.Mesh] = None) -> LbfgsResult:
    """Minimize `loss_fn` (see the module docstring for its batched
    signature) from `init_params` for `num_iters` iterations, fewer when
    a tolerance stops it early. `max_linesearch_steps` is the zoom
    search's probe budget, `num_candidates` the parallel and armijo
    searches' grid. With `reduce`, the params are this rank's shard and
    the losses and returned history are the sums over ranks (see the
    module docstring)."""
    if linesearch not in ("parallel", "armijo", "zoom"):
        raise ValueError(f"unknown linesearch {linesearch!r}")
    fl = _Flat(init_params)
    x0 = fl.flat({k: v.detach() for k, v in init_params.items()})
    mvec = fl.mask(mask, x0)
    dev, dt = x0.device, x0.dtype

    def masked(g):
        return g if mvec is None else g * mvec

    if reduce is None:
        dot, norm = torch.dot, torch.linalg.vector_norm
        total = inf_norm = lambda t: t
    else:
        total = lambda t: P.all_reduce_sum(reduce, t.detach())
        dot = lambda a, b: total(torch.dot(a, b))
        norm = lambda a: torch.sqrt(dot(a, a))
        inf_norm = lambda t: P.all_reduce_max(reduce, t)

    def value_and_grad(xs: torch.Tensor):
        """xs (K, P) -> (values (K,), grads (K, P)); each rank
        differentiates its own share of the loss, whose collectives
        carry the cross-rank terms' cotangents."""
        evaluated(xs)
        xs = xs.detach().requires_grad_(True)
        with torch.enable_grad():
            with PR.span("lbfgs.forward"):
                vals = loss_fn(fl.unflat(xs))
            with PR.span("lbfgs.backward"):
                g, = torch.autograd.grad(vals.sum(), xs)
        return total(vals.detach()), g

    def values(xs: torch.Tensor) -> torch.Tensor:
        evaluated(xs)
        with torch.no_grad(), PR.span("lbfgs.forward"):
            return total(loss_fn(fl.unflat(xs)))

    def evaluated(xs: torch.Tensor):
        PR.count("lbfgs.evaluations")
        PR.count("lbfgs.points", xs.shape[0])

    def value_and_grad1(x: torch.Tensor):
        v, g = value_and_grad(x[None])
        return v[0], g[0]

    mults = torch.tensor(candidate_multipliers(max(num_candidates - 1, 2)),
                         dtype=dt, device=dev)
    x, value, grads = x0, *value_and_grad1(x0)
    grads = masked(grads)
    mem = _LbfgsMemory(x0, history_size)
    best_x, best_val = x0, torch.tensor(float("inf"), dtype=dt, device=dev)
    alpha_prev = torch.tensor(1.0, dtype=dt, device=dev)
    one = torch.ones(1, dtype=dt, device=dev)
    early = tol_grad is not None or tol_change is not None
    tol_grad = 0.0 if tol_grad is None else tol_grad
    tol_change = 0.0 if tol_change is None else tol_change
    stall = 0
    history = []

    for _ in range(num_iters):
        if early and stall >= stall_patience:
            break
        with PR.span("lbfgs.iter"):
            with PR.span("lbfgs.direction"):
                history.append(value)
                x_old = x
                better = torch.isfinite(value) & (value < best_val)
                best_x = _select(better, x, best_x)
                best_val = _select(better, value, best_val)

                direction, new_mem = mem.direction(grads, x, dot, norm)
                direction = masked(direction)
                g0d = dot(grads, direction)

            with PR.span("lbfgs.search"):
                if linesearch == "zoom":
                    a_sel, new_value, new_grads = zoom_linesearch(
                        lambda a: value_and_grad1(x + a * direction), value,
                        grads, direction, max_linesearch_steps, dot)
                    new_x = x + a_sel * direction
                    if not bool(torch.isfinite(new_value)):   # host sync
                        # value_and_grad_from_state: the search's value is
                        # not finite, so evaluate at the accepted point
                        new_value, new_grads = value_and_grad1(new_x)
                    new_grads = masked(new_grads)
                    keep = torch.ones((), dtype=torch.bool, device=dev)
                else:
                    alphas = torch.cat(
                        [torch.clamp(alpha_prev * mults, 1e-8, 1e4), one])
                    alphas = torch.sort(alphas, descending=True).values
                    cand = x[None] + alphas[:, None] * direction[None]
                    if linesearch == "parallel":
                        vals, grads_k = value_and_grad(cand)
                        finite = torch.isfinite(vals)
                        armijo = vals <= value + _C1 * alphas * g0d
                        curvature = torch.abs(total(grads_k @ direction)) \
                            <= _C2 * torch.abs(g0d)
                        accept = finite & armijo & curvature
                    else:
                        vals = values(cand)
                        finite = torch.isfinite(vals)
                        accept = finite & (vals
                                           <= value + _C1 * alphas * g0d)
                    idx_first = torch.argmax(accept.to(torch.int8))
                    idx_desc = torch.argmin(torch.where(
                        finite, vals, torch.full_like(vals, math.inf)))
                    found = accept.any()
                    idx = torch.where(found, idx_first, idx_desc)
                    a_sel = alphas[idx]
                    new_x = x + a_sel * direction
                    if linesearch == "parallel":
                        new_value = vals[idx]
                        new_grads = masked(grads_k[idx])
                        keep = found
                    else:
                        new_value, new_grads = value_and_grad1(new_x)
                        new_grads = masked(new_grads)
                        keep = found & (torch.abs(dot(new_grads, direction))
                                        <= _C2 * torch.abs(g0d))

            with PR.span("lbfgs.update"):
                tol = 1e-4 * torch.abs(value) + 1e-8
                ok = (torch.isfinite(new_value) & (new_value <= value + tol)
                      & torch.isfinite(norm(direction)))
                fresh = _LbfgsMemory(x0, history_size)
                # monotone safeguard: reject a non-descent step and restart
                # the memory; the parallel and armijo searches keep the step
                # but drop its curvature pair unless it passed the curvature
                # test (a y.s <= 0 pair would make the inverse-Hessian
                # estimate indefinite)
                new_x = _select(ok, new_x, x)
                new_value = _select(ok, new_value, value)
                new_grads = _select(ok, new_grads, grads)
                mem = _select_memory(ok & keep, new_mem, fresh)
                alpha_prev = _select(ok, a_sel, torch.ones_like(a_sel))
                x, value, grads = new_x, new_value, new_grads

                if early:
                    # two host syncs
                    change = float(inf_norm(torch.max(torch.abs(x - x_old))))
                    gnorm = float(inf_norm(torch.max(torch.abs(grads))))
                    stall = stall + 1 if change <= tol_change else 0
                    if gnorm <= tol_grad:
                        stall = stall_patience

    # the unreached tail holds the final value; a NaN the loop recorded
    # stays
    history += [value] * (num_iters - len(history))
    better = torch.isfinite(value) & (value < best_val)
    x_out = _select(better, x, best_x)
    loss_out = _select(better, value, best_val)
    params = {k: v.detach() for k, v in fl.unflat(x_out).items()}
    hist = torch.stack(history) if history else torch.zeros(0, dtype=dt,
                                                            device=dev)
    return LbfgsResult(params=params, loss=loss_out, loss_history=hist)
