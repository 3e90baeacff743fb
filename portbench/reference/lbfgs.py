"""Frozen copy of humor_torch/fitting/lbfgs.py, part of the benchmark's plain
reference; it imports nothing of humor_torch. Only the path the
benchmark's cells run is kept: the "parallel" line search on one device,
for a fixed number of iterations.

L-BFGS for test-time optimization (port of
humor_tpu/fitting/lbfgs.py).

The variables are a dict of tensors, flattened into one vector for the
optimizer. The L-BFGS direction is the two-loop recursion of
optax.scale_by_lbfgs (same memory layout, same initial scaling: a capped
1/|g| on the first step, then s.y / y.y).

`loss_fn` is evaluated for K candidate points at once: it receives the
variables with a leading candidate axis (every leaf (K, ...)) and
returns the K losses. One backward of their sum gives every candidate's
gradient, since candidates share nothing. This is how the TTO folds the
line-search grid into its window batch (JAX vmaps the closure).

The "parallel" search makes one value+grad evaluation of a log-spaced
step grid per iteration, recentered on the last accepted step; the
largest strong-Wolfe candidate is taken, else the best finite point. It
keeps the best-iterate return, the monotone safeguard with a restart of
the curvature memory, and gradient masks, and keeps the memory only
after a step that passed the curvature condition.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

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
        (params, g) pair before preconditioning, as optax does."""
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


def run_lbfgs(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
              init_params: Dict[str, torch.Tensor], num_iters: int,
              mask: Optional[Dict[str, float]] = None,
              history_size: int = 10, linesearch: str = "parallel",
              num_candidates: int = 8) -> LbfgsResult:
    """Minimize `loss_fn` (see the module docstring for its batched
    signature) from `init_params` for `num_iters` iterations, with the
    parallel search over a grid of `num_candidates`."""
    if linesearch != "parallel":
        raise ValueError(f"the reference runs the parallel search only, "
                         f"not {linesearch!r}")
    fl = _Flat(init_params)
    x0 = fl.flat({k: v.detach() for k, v in init_params.items()})
    mvec = fl.mask(mask, x0)
    dev, dt = x0.device, x0.dtype
    dot, norm = torch.dot, torch.linalg.vector_norm

    def masked(g):
        return g if mvec is None else g * mvec

    def value_and_grad(xs: torch.Tensor):
        """xs (K, P) -> (values (K,), grads (K, P))."""
        xs = xs.detach().requires_grad_(True)
        with torch.enable_grad():
            vals = loss_fn(fl.unflat(xs))
            g, = torch.autograd.grad(vals.sum(), xs)
        return vals.detach(), g

    mults = torch.tensor(candidate_multipliers(max(num_candidates - 1, 2)),
                         dtype=dt, device=dev)
    v0, g0 = value_and_grad(x0[None])
    x, value, grads = x0, v0[0], masked(g0[0])
    mem = _LbfgsMemory(x0, history_size)
    best_x, best_val = x0, torch.tensor(float("inf"), dtype=dt, device=dev)
    alpha_prev = torch.tensor(1.0, dtype=dt, device=dev)
    one = torch.ones(1, dtype=dt, device=dev)
    history = []

    for _ in range(num_iters):
        history.append(value)
        better = torch.isfinite(value) & (value < best_val)
        best_x = _select(better, x, best_x)
        best_val = _select(better, value, best_val)

        direction, new_mem = mem.direction(grads, x, dot, norm)
        direction = masked(direction)
        g0d = dot(grads, direction)

        alphas = torch.cat([torch.clamp(alpha_prev * mults, 1e-8, 1e4), one])
        alphas = torch.sort(alphas, descending=True).values
        cand = x[None] + alphas[:, None] * direction[None]
        vals, grads_k = value_and_grad(cand)
        finite = torch.isfinite(vals)
        armijo = vals <= value + _C1 * alphas * g0d
        curvature = torch.abs(grads_k @ direction) <= _C2 * torch.abs(g0d)
        accept = finite & armijo & curvature
        idx_first = torch.argmax(accept.to(torch.int8))
        idx_desc = torch.argmin(torch.where(
            finite, vals, torch.full_like(vals, math.inf)))
        found = accept.any()
        idx = torch.where(found, idx_first, idx_desc)
        a_sel = alphas[idx]
        new_x = x + a_sel * direction
        new_value, new_grads = vals[idx], masked(grads_k[idx])
        keep = found

        tol = 1e-4 * torch.abs(value) + 1e-8
        ok = (torch.isfinite(new_value) & (new_value <= value + tol)
              & torch.isfinite(norm(direction)))
        fresh = _LbfgsMemory(x0, history_size)
        # monotone safeguard: reject a non-descent step and restart the
        # memory; keep the step but drop its curvature pair unless it
        # passed the curvature test (a y.s <= 0 pair would make the
        # inverse-Hessian estimate indefinite)
        new_x = _select(ok, new_x, x)
        new_value = _select(ok, new_value, value)
        new_grads = _select(ok, new_grads, grads)
        mem = _select_memory(ok & keep, new_mem, fresh)
        alpha_prev = _select(ok, a_sel, torch.ones_like(a_sel))
        x, value, grads = new_x, new_value, new_grads

    better = torch.isfinite(value) & (value < best_val)
    x_out = _select(better, x, best_x)
    loss_out = _select(better, value, best_val)
    params = {k: v.detach() for k, v in fl.unflat(x_out).items()}
    hist = torch.stack(history) if history else torch.zeros(0, dtype=dt,
                                                            device=dev)
    return LbfgsResult(params=params, loss=loss_out, loss_history=hist)
