"""The rollout backward kernel's dataflow (humor_torch/csrc/rollout_bwd.cu
on rollout_persistent.cuh) replayed in torch on the CPU against
rollout_backward_plain, at full width, T=3 and M in {1, 5, 16}.

The replay follows the kernel's partitioning and its declared waits, not
its thread layout: the recompute's and the backward's product tasks for
every held tile (layer, K-slice of TK rows, column tile of TK columns, TK
read from the source; the transposed products read rows of w, no
transposed copy) and step, a finishing job for every output tile (or
slice) and row tile of RT rows, a tail task for every row, on buffers
kept as the kernel keeps them (one buffer of partials, one output and one
d(input) a layer, the pre-GroupNorm h in two copies by step parity, the
heads' cotangents once, the carry cotangent's tail part by parity), each
task waiting on the kernel's counters for what it reads and for the
readers of what it overwrites (tests/rollout_flow.py). A product's output
is finished from its partials summed in slice order (bias + GroupNorm +
ReLU, or its VJP at the stored h); dz is written from decoder layer 3's z
columns and layers 2, 1, 0 are added to it in that order; the carry
cotangent entering a tail is the next tail's part + (decoder + prior
layer-0 parts). In the kernel's own order (every block's walk) no task
waits on a later one; in orders the waits allow and no barrier would (the
recompute up to two steps ahead, the prior chains behind the decoder's)
the result is the same; without the prior chain's output guard or the
partials' guard, some order gives another. Float64 agrees with the plain
VJP to 1e-10 max-scaled (only summation order differs), float32 to 1e-5.
"""

import re
from functools import partial
from pathlib import Path

import pytest
import torch

import chip_smoke
import rollout_flow as RF
from humor_torch.models import humor as H
from humor_torch.ops import rollout_kernel as RK
from humor_torch.ops.mlp import GN_EPS, GN_GROUPS

torch.set_num_threads(2)

SRC = (Path(RK.__file__).resolve().parents[1] / "csrc"
       / "rollout_persistent.cuh")
KS = int(re.search(r"constexpr int TK = (\d+);", SRC.read_text()).group(1))
RT = int(re.search(r"constexpr int RT = (\d+);", SRC.read_text()).group(1))
T = 3


def _gn_bwd(da, h, gs, gb, g):
    """d h of one tile from d relu(GroupNorm(h)) and the stored h (the
    tile covers whole groups of g columns)."""
    x = h.reshape(h.shape[0], -1, g)
    cent = x - x.mean(-1, keepdim=True)
    r = 1.0 / torch.sqrt((cent * cent).mean(-1, keepdim=True) + GN_EPS)
    y = (cent * r).reshape(da.shape) * gs + gb
    gg = (torch.where(y > 0, da, torch.zeros_like(da)) * gs).reshape(x.shape)
    dcent = r * gg - r * r * r * cent * (gg * cent).mean(-1, keepdim=True)
    return (dcent - dcent.mean(-1, keepdim=True)).reshape(da.shape)


def backward_schedule(w, saved, z, t2j, dout, strategy="walk", seed=0,
                      drop=()):
    """rollout_backward_plain's result computed task by task as the
    kernel computes it, on buffers kept as the kernel keeps them (one
    buffer of partials, one output and one d(input) a layer, h in two
    copies by step parity, the tail's cotangents once, the carry
    cotangent's tail part by parity; NaN until written), each task run
    when the strategy picks it among those whose declared waits are met
    (rollout_flow.Flow). `drop` leaves out guards: "prior_out" the wait of
    a prior layer's recompute finish for the next layer's readers of the
    step before, "partials" a product's wait for its output's previous
    finish. Returns (dcarry0, dz, dt2j)."""
    pw, pb, pgs, pgb = w.prior
    dw, db, dgs, dgb = w.decoder
    T_, M = z.shape[:2]
    R = -(-M // RT)
    # layers: prior 0-4, decoder 0-3 (as the kernel numbers them)
    lw = list(pw) + list(dw)
    bias = list(pb) + list(db)
    gs = [pgs[i + 1] for i in range(4)] + [None] + \
        [dgs[i + 1] for i in range(3)] + [None]
    gb = [pgb[i + 1] for i in range(4)] + [None] + \
        [dgb[i + 1] for i in range(3)] + [None]
    n = [x.shape[1] for x in lw]
    kz = [0] * 5 + [RK.LATENT] * 4
    ka = [x.shape[0] - k for x, k in zip(lw, kz)]
    act = [-(-k // KS) for k in ka]
    S = [a + (k > 0) for a, k in zip(act, kz)]
    C = [-(-x // KS) for x in n]
    first = (0, 5)
    nan = float("nan")

    def full(*shape):
        return torch.full(shape, nan, dtype=z.dtype)

    part_f = [full(S[l], M, n[l]) for l in range(9)]
    part_b = [full(C[l], M, ka[l] + kz[l]) for l in range(9)]
    lout = [full(M, n[l]) for l in range(9)]
    hbuf = [full(2, M, n[l]) for l in range(9)]
    dh_out = [full(M, ka[l]) for l in range(9)]
    dz = full(*z.shape)
    ddraw, dp = full(M, 216), full(M, 96)
    dcur = full(2, M, RK.CW)
    dt2j = torch.zeros_like(t2j)

    def rows(r):
        return slice(r * RT, min(M, (r + 1) * RT))

    def nrows(r):
        return len(range(M)[rows(r)])

    def wrows(l, s):
        return (slice(ka[l], ka[l] + kz[l]) if s == act[l]
                else slice(s * KS, min((s + 1) * KS, ka[l])))

    def recompute(l, s, nn, t):
        cols = slice(nn * KS, (nn + 1) * KS)
        if s == act[l]:
            x = z[t]
        elif l in first:
            x = saved[t][:, wrows(l, s)]
        else:
            x = lout[l - 1][:, wrows(l, s)]
        part_f[l][s][:, cols] = x @ lw[l][wrows(l, s), cols]

    def finish_f(l, nn, r, t):
        rs, cols = rows(r), slice(nn * KS, (nn + 1) * KS)
        h = part_f[l][0][rs, cols]
        for s in range(1, S[l]):
            h = h + part_f[l][s][rs, cols]
        h = h + bias[l][cols]
        if gs[l] is None:
            lout[l][rs, cols] = h
            return
        hbuf[l][t % 2][rs, cols] = h
        x = h.reshape(h.shape[0], -1, n[l] // GN_GROUPS)
        cent = x - x.mean(-1, keepdim=True)
        rstd = 1.0 / torch.sqrt((cent * cent).mean(-1, keepdim=True) + GN_EPS)
        y = (cent * rstd).reshape(h.shape) * gs[l][cols] + gb[l][cols]
        lout[l][rs, cols] = torch.relu(y)

    def transposed(l, s, nn, t):
        cols = slice(nn * KS, (nn + 1) * KS)
        dh = dp if l == 4 else ddraw if l == 8 else dh_out[l + 1]
        wr = wrows(l, s)
        part_b[l][nn][:, wr] = dh[:, cols] @ lw[l][wr, cols].t()

    def finish_b(l, s, r, t):
        rs, wr = rows(r), wrows(l, s)
        v = part_b[l][0][rs, wr]
        for nn in range(1, C[l]):
            v = v + part_b[l][nn][rs, wr]
        if s == act[l]:
            dz[t, rs] = v if l == 8 else dz[t, rs] + v
        elif l in first:
            dh_out[l][rs, wr] = v
        else:
            dh_out[l][rs, wr] = _gn_bwd(v, hbuf[l - 1][t % 2][rs, wr],
                                        gs[l - 1][wr], gb[l - 1][wr],
                                        n[l - 1] // GN_GROUPS)

    def carry_cot(dc, row):
        dx = dh_out[5][row] + dh_out[0][row]
        return dc + torch.cat([dx, torch.zeros_like(dc[RK.D_X:])])

    def tail(row, t):
        sl = slice(row, row + 1)
        dnext = (torch.zeros_like(saved[t][sl]) if t == T_ - 1 else
                 carry_cot(dcur[(t + 1) % 2][row], row)[None])
        dc, dd, dph, dt = RK.tail_vjp(saved[t][sl], t2j[sl], lout[8][sl],
                                      lout[4][sl], dout[t][sl], dnext)
        dcur[t % 2][row] = dc[0]
        ddraw[row], dp[row] = dd[0], dph[0]
        dt2j[row] = dt2j[row] + dt[0]

    flow = RF.Flow()
    for t in range(T_ - 1, -1, -1):
        u = T_ - t
        for l in range(9):
            chain = "prior" if l < 5 else "decoder"
            # F_k(t) runs in iteration t, B_k(t) in iteration t - 1: the
            # walk order's first key counts iterations as they run
            kf, kb = (l, 4 - l) if l < 5 else (l - 5, 8 - l)
            # the recompute of step t
            for s in range(S[l]):
                for nn in range(C[l]):
                    waits = []
                    for r in range(R):
                        if s < act[l] and l not in first:
                            waits.append((("rdy_f", l - 1, s, r), u))
                        if "partials" not in drop:
                            waits.append((("rdy_f", l, nn, r), u - 1))
                    flow.add({"kind": "product", "chain": chain, "layer": l,
                              "order": (T_ - 1 - t, kf, 0, 0, l, s, nn)},
                             waits, partial(recompute, l, s, nn, t),
                             [("cnt_f", l, nn)])
            for nn in range(C[l]):
                for r in range(R):
                    waits = [(("cnt_f", l, nn), S[l] * u)]
                    if gs[l] is not None:
                        if not (l < 4 and "prior_out" in drop):
                            waits += [(("cnt_f", l + 1, j),
                                       S[l + 1] * (u - 1))
                                      for j in range(C[l + 1])]
                        waits.append((("rdy_b", l + 1, nn, r), u - 2))
                    else:
                        waits.append((("tail", r), nrows(r) * (u - 1)))
                    flow.add({"kind": "finish", "chain": chain, "layer": l,
                              "order": (T_ - 1 - t, kf, 1, 0, l, nn, r)},
                             waits, partial(finish_f, l, nn, r, t),
                             [("rdy_f", l, nn, r)])
            # the backward of step t
            for s in range(S[l]):
                for nn in range(C[l]):
                    waits = []
                    for r in range(R):
                        waits.append(
                            (("tail", r), nrows(r) * u) if gs[l] is None else
                            (("rdy_b", l + 1, nn, r), u))
                        if "partials" not in drop:
                            waits.append((("rdy_b", l, s, r), u - 1))
                    flow.add({"kind": "product", "chain": chain, "layer": l,
                              "order": (T_ - t, kb, 0, 1, l, s, nn)},
                             waits, partial(transposed, l, s, nn, t),
                             [("cnt_b", l, s)])
            for s in range(S[l]):
                for r in range(R):
                    waits = [(("cnt_b", l, s), C[l] * u)]
                    if s == act[l]:
                        if l < 8:
                            waits.append((("rdy_b", l + 1, S[l + 1] - 1, r),
                                          u))
                    elif l in first:
                        waits.append((("tail", r), nrows(r) * u))
                    else:
                        waits.append((("rdy_f", l - 1, s, r), u))
                        waits += [(("cnt_b", l - 1, j), C[l - 1] * (u - 1))
                                  for j in range(S[l - 1])]
                    flow.add({"kind": "finish", "chain": chain, "layer": l,
                              "order": (T_ - t, kb, 1, 1, l, s, r)},
                             waits, partial(finish_b, l, s, r, t),
                             [("rdy_b", l, s, r)])
        for row in range(M):
            r = row // RT
            waits = ([(("rdy_f", 8, nn, r), u) for nn in range(C[8])]
                     + [(("rdy_f", 4, nn, r), u) for nn in range(C[4])]
                     + [(("rdy_b", 0, s, r), u - 1) for s in range(S[0])]
                     + [(("rdy_b", 5, s, r), u - 1) for s in range(S[5])])
            flow.add({"kind": "tail", "chain": "tail", "layer": 9,
                      "order": (T_ - 1 - t, 5, 0, 0, row)},
                     waits, partial(tail, row, t), [("tail", r)])
    flow.run(strategy, seed)
    dcarry0 = torch.stack([carry_cot(dcur[0][row], row) for row in range(M)])
    return dcarry0, dz, dt2j


def _errors(got, want):
    """Max-scaled errors of dcarry0, dz and dt2j, NaN where the schedule
    left a value unwritten or read one unwritten."""
    return {name: ((a - b).abs().max() / b.abs().max()).item()
            if bool(torch.isfinite(a).all()) else float("nan")
            for name, a, b in zip(("dcarry0", "dz", "dt2j"), got, want)}


def _inputs(params, M, dtype):
    w = RK.RolloutWeights(params, "cpu", dtype=dtype)
    carry0, z, t2j, dout = (a.to(dtype) for a in chip_smoke.rollout_inputs(
        M, T, seed=M, device="cpu"))
    _, saved = RK.rollout_forward_plain(w, carry0, z, t2j)
    return w, saved, z, t2j, dout


@pytest.fixture(scope="module")
def params():
    return H.init_params(H.HumorConfig(), torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_schedule_matches_plain_vjp(params, M, dtype, tol):
    """The kernel's own order (every block's walk, run one task at a
    time): no task waits on a later one, and the result is the plain
    VJP's."""
    w, saved, z, t2j, dout = _inputs(params, M, dtype)
    with torch.no_grad():
        got = backward_schedule(w, saved, z, t2j, dout)
        want = RK.rollout_backward_plain(w, saved, z, t2j, dout)
    for name, err in _errors(got, want).items():
        assert err <= tol, f"{name}: max-scaled {err:.3e} > {tol}"


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("strategy", RF.STRATEGIES)
def test_dataflow_orders_match_plain_vjp(params, strategy, M, dtype, tol):
    """Orders the declared waits allow and the barriers did not (the
    recompute a step ahead of the backward, the prior chains behind the
    decoder's): the result is the plain VJP's."""
    w, saved, z, t2j, dout = _inputs(params, M, dtype)
    with torch.no_grad():
        got = backward_schedule(w, saved, z, t2j, dout, strategy, seed=M)
        want = RK.rollout_backward_plain(w, saved, z, t2j, dout)
    for name, err in _errors(got, want).items():
        assert err <= tol, f"{name}: max-scaled {err:.3e} > {tol}"


@pytest.mark.parametrize("guard", ["prior_out", "partials"])
def test_dropped_guard_changes_vjp(params, guard):
    """Without the prior chain's output guard, or the partials' guard,
    some order the remaining waits allow gives another result: the
    guards are needed, not just present."""
    w, saved, z, t2j, dout = _inputs(params, 5, torch.float64)
    with torch.no_grad():
        want = RK.rollout_backward_plain(w, saved, z, t2j, dout)
        worst = {}
        for strategy in RF.STRATEGIES:
            got = backward_schedule(w, saved, z, t2j, dout, strategy,
                                    seed=5, drop=(guard,))
            errs = _errors(got, want).values()
            worst[strategy] = max(float("inf") if e != e else e
                                  for e in errs)
    assert max(worst.values()) > 1e-6, worst
