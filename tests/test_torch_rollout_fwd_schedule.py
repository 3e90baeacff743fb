"""The rollout forward kernel's dataflow (humor_torch/csrc/rollout_fwd.cu
on rollout_persistent.cuh) replayed in torch on the CPU against
rollout_forward_plain, at full width, T=3 and M in {1, 5, 16}.

The replay follows the kernel's partitioning and its declared waits, not
its thread layout: a product task for every held tile (layer, K-slice of
TK rows, column tile of TK columns, TK read from the source) and step, a
finishing job for every output tile and row tile of RT rows, a tail task
for every row, on buffers kept as the kernel keeps them (one buffer of
partials and one output a layer, the running carry in rows padded to 16
bytes as far as layer 0's 339 input columns, the prior head's finish
writing the latent mean and exp(log-variance) straight into the step's
output), each task waiting on the kernel's counters (arrivals, finished
tiles, tail rows) for what it reads and for the readers of what it
overwrites (tests/rollout_flow.py). A product's output is finished from
its partials summed in slice order: bias + GroupNorm + ReLU over whole
groups, or a head. In the kernel's own order (every block's walk) no task
waits on a later one; in orders the waits allow and no barrier would (the
prior chain a step behind the decoder's, a layer into the next step
early) the result is the same; without the prior chain's output guard or
the partials' guard, some order gives another. Float64 agrees with the
plain forward to 1e-10 max-scaled (only summation order differs),
float32 to 1e-5.
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
CWP = -(-RK.CW // 4) * 4          # the running carry's padded row
OUT_X = RK.D_X + 9                # out: world x | contacts, then pm, pv
PV = OUT_X + RK.LATENT
T = 3


def forward_schedule(w, carry0, z, t2j, strategy="walk", seed=0, drop=()):
    """rollout_forward_plain's result computed task by task as the kernel
    computes it, on buffers kept as the kernel keeps them (one buffer of
    partials and one output a layer, NaN until written), each task run
    when the strategy picks it among those whose declared waits are met
    (rollout_flow.Flow). `drop` leaves out guards: "prior_out" the wait of
    a prior layer's finish for the next layer's readers of the previous
    step, "partials" a product's wait for its output tile's previous
    finish. Returns (out, saved)."""
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
    nan = float("nan")
    part = [torch.full((S[l], M, n[l]), nan, dtype=z.dtype) for l in range(9)]
    lout = [torch.full((M, n[l]), nan, dtype=z.dtype) for l in range(9)]
    # the running carries, rows padded (the pad is never read); saved and
    # out are outputs only
    pcarry = torch.full((T_, M, CWP), nan, dtype=z.dtype)
    pcarry[0, :, :RK.CW] = carry0
    pcarry[0, :, RK.CW:] = 0.0
    saved = torch.full((T_, M, RK.CW), nan, dtype=z.dtype)
    saved[0] = carry0
    out = torch.full((T_, M, RK.OUT_W), nan, dtype=z.dtype)
    dummy = torch.zeros(1, 2 * RK.LATENT, dtype=z.dtype)

    def rows(r):
        return slice(r * RT, min(M, (r + 1) * RT))

    def product(l, s, nn, t):
        cols = slice(nn * KS, (nn + 1) * KS)
        if s == act[l]:
            x, wr = z[t], lw[l][ka[l]:]
        else:
            k = slice(s * KS, min((s + 1) * KS, ka[l]))
            x = pcarry[t][:, k] if l in (0, 5) else lout[l - 1][:, k]
            wr = lw[l][k]
        part[l][s][:, cols] = x @ wr[:, cols]

    def finish(l, nn, r, t):
        rs, cols = rows(r), slice(nn * KS, (nn + 1) * KS)
        h = part[l][0][rs, cols]
        for s in range(1, S[l]):
            h = h + part[l][s][rs, cols]
        h = h + bias[l][cols]
        if gs[l] is not None:
            x = h.reshape(h.shape[0], -1, n[l] // GN_GROUPS)
            cent = x - x.mean(-1, keepdim=True)
            rstd = 1.0 / torch.sqrt((cent * cent).mean(-1, keepdim=True)
                                    + GN_EPS)
            y = (cent * rstd).reshape(h.shape) * gs[l][cols] + gb[l][cols]
            lout[l][rs, cols] = torch.relu(y)
        elif l == 4:
            # the latent mean, then exp(log-variance) from column 48 on,
            # straight into out[t]
            c0 = nn * KS
            ex = torch.arange(c0, c0 + h.shape[1]) >= RK.LATENT
            out[t, rs, OUT_X + c0:OUT_X + c0 + h.shape[1]] = torch.where(
                ex, torch.exp(h), h)
        else:
            lout[l][rs, cols] = h

    def tail(row, t):
        o_t, nxt = RK.tail_forward(pcarry[t][row:row + 1, :RK.CW],
                                   t2j[row:row + 1],
                                   lout[8][row:row + 1], dummy)
        out[t, row, :OUT_X] = o_t[0, :OUT_X]
        if t + 1 < T_:
            pcarry[t + 1, row, :RK.CW] = nxt[0]
            pcarry[t + 1, row, RK.CW:] = 0.0
            saved[t + 1, row] = nxt[0]

    flow = RF.Flow()
    for t in range(T_):
        use = t + 1
        for l in range(9):
            chain = "prior" if l < 5 else "decoder"
            # phase k of step t runs prior layer k and decoder layer k, and
            # in phase 0 the prior head of step t - 1
            it, k = (t + 1, 0) if l == 4 else (t, l % 5)
            for s in range(S[l]):
                for nn in range(C[l]):
                    waits = []
                    for r in range(R):
                        if s < act[l]:
                            waits.append(
                                (("tail", r), len(range(M)[rows(r)]) * t)
                                if l in (0, 5) else
                                (("rdy_f", l - 1, s, r), use))
                        if "partials" not in drop:
                            waits.append((("rdy_f", l, nn, r), use - 1))
                    flow.add({"kind": "product", "chain": chain, "layer": l,
                              "order": (it, k, 0, l, s, nn)},
                             waits, partial(product, l, s, nn, t),
                             [("cnt_f", l, nn)])
            for nn in range(C[l]):
                for r in range(R):
                    waits = [(("cnt_f", l, nn), S[l] * use)]
                    if gs[l] is not None:
                        if not (l < 4 and "prior_out" in drop):
                            waits += [(("cnt_f", l + 1, j),
                                       S[l + 1] * (use - 1))
                                      for j in range(C[l + 1])]
                    elif l == 8:
                        waits.append((("tail", r),
                                      len(range(M)[rows(r)]) * (use - 1)))
                    flow.add({"kind": "finish", "chain": chain, "layer": l,
                              "order": (it, k, 1, l, nn, r)},
                             waits, partial(finish, l, nn, r, t),
                             [("rdy_f", l, nn, r)])
        for row in range(M):
            r = row // RT
            flow.add({"kind": "tail", "chain": "tail", "layer": 9,
                      "order": (t, 4, 0, row)},
                     [(("rdy_f", 8, nn, r), use) for nn in range(C[8])],
                     partial(tail, row, t), [("tail", r)])
    flow.run(strategy, seed)
    return out, saved


def _errors(got, want):
    """Each part of the output on its own scale (exp(log-variance) may be
    far larger than the world state): max-scaled errors, NaN where the
    schedule left a value unwritten or read one unwritten."""
    parts = {"world_x_contacts": (got[0][..., :OUT_X], want[0][..., :OUT_X]),
             "prior_mean": (got[0][..., OUT_X:PV], want[0][..., OUT_X:PV]),
             "prior_var": (got[0][..., PV:], want[0][..., PV:]),
             "saved": (got[1], want[1])}
    return {name: ((a - b).abs().max() / b.abs().max()).item()
            if bool(torch.isfinite(a).all()) else float("nan")
            for name, (a, b) in parts.items()}


def _inputs(params, M, dtype):
    w = RK.RolloutWeights(params, "cpu", dtype=dtype)
    carry0, z, t2j, _ = (a.to(dtype) for a in chip_smoke.rollout_inputs(
        M, T, seed=M, device="cpu"))
    return w, carry0, z, t2j


@pytest.fixture(scope="module")
def params():
    return H.init_params(H.HumorConfig(), torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_schedule_matches_plain_forward(params, M, dtype, tol):
    """The kernel's own order (every block's walk, run one task at a
    time): no task waits on a later one, and the result is the plain
    forward's."""
    w, carry0, z, t2j = _inputs(params, M, dtype)
    with torch.no_grad():
        got = forward_schedule(w, carry0, z, t2j)
        want = RK.rollout_forward_plain(w, carry0, z, t2j)
    for name, err in _errors(got, want).items():
        assert err <= tol, f"{name}: max-scaled {err:.3e} > {tol}"


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("strategy", RF.STRATEGIES)
def test_dataflow_orders_match_plain_forward(params, strategy, M, dtype,
                                             tol):
    """Orders the declared waits allow and the barriers did not (the
    prior chain a step behind the decoder's, a layer run ahead into the
    next step): the result is the plain forward's."""
    w, carry0, z, t2j = _inputs(params, M, dtype)
    with torch.no_grad():
        got = forward_schedule(w, carry0, z, t2j, strategy, seed=M)
        want = RK.rollout_forward_plain(w, carry0, z, t2j)
    for name, err in _errors(got, want).items():
        assert err <= tol, f"{name}: max-scaled {err:.3e} > {tol}"


@pytest.mark.parametrize("guard", ["prior_out", "partials"])
def test_dropped_guard_changes_forward(params, guard):
    """Without the prior chain's output guard, or the partials' guard,
    some order the remaining waits allow gives another result: the
    guards are needed, not just present."""
    w, carry0, z, t2j = _inputs(params, 5, torch.float64)
    with torch.no_grad():
        want = RK.rollout_forward_plain(w, carry0, z, t2j)
        worst = {}
        for strategy in RF.STRATEGIES:
            got = forward_schedule(w, carry0, z, t2j, strategy, seed=5,
                                   drop=(guard,))
            errs = _errors(got, want).values()
            worst[strategy] = max(float("inf") if e != e else e
                                  for e in errs)
    assert max(worst.values()) > 1e-6, worst
