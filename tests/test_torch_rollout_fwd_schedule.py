"""The rollout forward kernel's schedule (humor_torch/csrc/rollout_fwd.cu)
replayed in torch on the CPU against rollout_forward_plain, at full
width, T=3 and M in {1, 5, 16}.

The replay follows the kernel's partitioning, not its thread layout: the
phases P_k|D_k (prior layer k beside decoder layer k, k = 0..3) and TL
(the tail), with the prior head of step t beside P0|D0 of step t + 1 (the
last step's in a phase of its own), on buffers kept as the kernel keeps
them. Layer 0 reads the running carry from a buffer whose rows are padded
to 16 bytes (352 floats), as far as its 339 input columns; every product
is split over K in slices of the kernels' tile size (TK, read from the
source), the z columns a slice of their own; a product's output is
finished from its partials summed in slice order, in column tiles of TK
that cover whole GroupNorm groups (bias + GroupNorm + ReLU, or a head; the
kernel finishes a tile 16 rows at a time, and rows are independent, so the
replay finishes all rows at once);
the prior head's finish writes the latent mean and exp(log-variance)
straight into the step's output, the tail the world state and contacts
beside it and the next carry into the padded buffer and `saved`. Float64
agrees with the plain forward to 1e-10 max-scaled (only summation order
differs), float32 to 1e-5.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from humor_torch.models import humor as H
from humor_torch.ops import rollout_kernel as RK
from humor_torch.ops.mlp import GN_EPS, GN_GROUPS

torch.set_num_threads(2)

SRC = (Path(RK.__file__).resolve().parents[1] / "csrc"
       / "rollout_persistent.cuh")
KS = int(re.search(r"constexpr int TK = (\d+);", SRC.read_text()).group(1))
CWP = -(-RK.CW // 4) * 4          # the running carry's padded row
OUT_X = RK.D_X + 9                # out: world x | contacts, then pm, pv
PV = OUT_X + RK.LATENT
T = 3


def _sum(parts):
    """Partials summed in slice order."""
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    return v


def _products(a, ka, w, z=None):
    """Partials of [a[:, :ka] | z] @ w: slices of KS columns of a, z its
    own."""
    parts = [a[:, k:min(k + KS, ka)] @ w[k:min(k + KS, ka)]
             for k in range(0, ka, KS)]
    if z is not None:
        parts.append(z @ w[ka:])
    return parts


def _finish(parts, bias, gs, gb):
    """The layer's output, each column tile of KS columns finished from
    the partials: a hidden layer's relu(GroupNorm(h)) (a tile covers whole
    groups), a head's h."""
    width = bias.shape[0]
    g = width // GN_GROUPS
    outs = []
    for c in range(0, width, KS):
        h = _sum([p[:, c:c + KS] for p in parts]) + bias[c:c + KS]
        if gs is None:
            outs.append(h)
            continue
        x = h.reshape(h.shape[0], -1, g)
        cent = x - x.mean(-1, keepdim=True)
        rstd = 1.0 / torch.sqrt((cent * cent).mean(-1, keepdim=True) + GN_EPS)
        y = (cent * rstd).reshape(h.shape) * gs[c:c + KS] + gb[c:c + KS]
        outs.append(torch.relu(y))
    return torch.cat(outs, 1)


def forward_schedule(w, carry0, z, t2j):
    """rollout_forward_plain's result computed in the kernel's phases, on
    buffers kept as the kernel keeps them: every phase reads the buffers as
    they stood before it and its writes land after it (the kernel's blocks
    run a phase's jobs at once), so a buffer read in the phase that writes
    it would give a wrong result. Returns (out, saved)."""
    pw, pb, pgs, pgb = w.prior
    dw, db, dgs, dgb = w.decoder
    T_, M = z.shape[:2]
    # layers: prior 0-4, decoder 0-3 (as the kernel numbers them)
    lw = list(pw) + list(dw)
    bias = list(pb) + list(db)
    gs = [pgs[i + 1] for i in range(4)] + [None] + \
        [dgs[i + 1] for i in range(3)] + [None]
    gb = [pgb[i + 1] for i in range(4)] + [None] + \
        [dgb[i + 1] for i in range(3)] + [None]
    # the running carries, rows padded (the pad is never read); saved and
    # out are outputs only
    pcarry = torch.full((T_, M, CWP), float("nan"), dtype=z.dtype)
    pcarry[0, :, :RK.CW] = carry0
    pcarry[0, :, RK.CW:] = 0.0
    saved = torch.full((T_, M, RK.CW), float("nan"), dtype=z.dtype)
    saved[0] = carry0
    out = torch.full((T_, M, RK.OUT_W), float("nan"), dtype=z.dtype)
    buf = {}

    def forward(l, t, o):
        """Layer l's product for step t, finished."""
        first, dec = l in (0, 5), l >= 5
        x = pcarry[t] if first else buf[("out", l - 1)]
        ka = RK.D_X if first else x.shape[1]
        parts = _products(x, ka, lw[l], z[t] if dec else None)
        y = _finish(parts, bias[l], gs[l], gb[l])
        if l == 4:
            # the prior head into out[t]: the mean, then exp(log-variance)
            # from column 48 on (in the tiles that hold those columns)
            o[("pm", t)] = torch.cat([y[:, :RK.LATENT],
                                      torch.exp(y[:, RK.LATENT:])], 1)
        else:
            o[("out", l)] = y

    def tail(t, o):
        """The world state and contacts of step t and the next carry."""
        dummy = torch.zeros(M, 2 * RK.LATENT, dtype=z.dtype)
        o_t, nxt = RK.tail_forward(pcarry[t][:, :RK.CW], t2j,
                                   buf[("out", 8)], dummy)
        o[("x", t)] = o_t[:, :OUT_X]
        if t + 1 < T_:
            o[("carry", t + 1)] = nxt

    def commit(o):
        for key, v in o.items():
            if key[0] == "pm":
                out[key[1], :, OUT_X:] = v
            elif key[0] == "x":
                out[key[1], :, :OUT_X] = v
            elif key[0] == "carry":
                pcarry[key[1], :, :RK.CW] = v
                pcarry[key[1], :, RK.CW:] = 0.0
                saved[key[1]] = v
            else:
                buf[key] = v

    # phase k < 4 of step t: prior layer k beside decoder layer k, and in
    # phase 0 the prior head of step t - 1; phase 4 the tail
    for t in range(T_ + 1):
        for k in range(5 if t < T_ else 1):
            o = {}
            if t < T_ and k < 4:
                forward(k, t, o)
                forward(5 + k, t, o)
            if k == 0 and t > 0:
                forward(4, t - 1, o)
            if k == 4:
                tail(t, o)
            commit(o)
    return out, saved


@pytest.fixture(scope="module")
def params():
    return H.init_params(H.HumorConfig(), torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_schedule_matches_plain_forward(params, M, dtype, tol):
    w = RK.RolloutWeights(params, "cpu", dtype=dtype)
    carry0, z, t2j, _ = (a.to(dtype) for a in chip_smoke.rollout_inputs(
        M, T, seed=M, device="cpu"))
    with torch.no_grad():
        got = forward_schedule(w, carry0, z, t2j)
        want = RK.rollout_forward_plain(w, carry0, z, t2j)
    # each part of the output on its own scale (exp(log-variance) may be
    # far larger than the world state)
    parts = {"world_x_contacts": (got[0][..., :OUT_X], want[0][..., :OUT_X]),
             "prior_mean": (got[0][..., OUT_X:PV], want[0][..., OUT_X:PV]),
             "prior_var": (got[0][..., PV:], want[0][..., PV:]),
             "saved": (got[1], want[1])}
    for name, (a, b) in parts.items():
        assert bool(torch.isfinite(a).all()), name
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= tol, f"{name}: max-scaled {err:.3e} > {tol}"
