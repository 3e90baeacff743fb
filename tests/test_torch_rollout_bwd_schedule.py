"""The rollout backward kernel's schedule (humor_torch/csrc/rollout_bwd.cu)
replayed in torch on the CPU against rollout_backward_plain, at full
width, T=3 and M in {1, 5, 16}.

The replay follows the kernel's partitioning, not its thread layout:
the recompute phases F0-F4 (prior layer i and decoder layer i together),
the tail, and B0-B4 (prior layer 4-i and decoder layer 3-i transposed),
with F_k of step t run beside B_k of step t + 1, on buffers kept as the
kernel keeps them (the pre-GroupNorm h in two copies by step parity, the
carry cotangent's tail part likewise). Every product is split over K in
slices of the kernels' tile size (TK, read from the source), the z
columns a slice of their own, and the transposed products read rows of w
(no transposed copy); a product's output is finished from its partials
summed in slice order, in column tiles of TK that cover whole GroupNorm
groups (bias + GroupNorm + ReLU, or its VJP at the stored h); dz is
written from decoder layer 3's z columns and layers 2, 1, 0 are added to
it in that order; the carry cotangent entering a tail is the next tail's
part + (decoder + prior layer-0 parts). Float64 agrees with the plain VJP
to 1e-10 max-scaled (only summation order differs), float32 to 1e-5.
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
T = 3


def _sum(parts):
    """Partials summed in slice order."""
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    return v


def _products(a, w, z=None):
    """Partials of [a | z] @ w: slices of KS columns of a, z its own."""
    ka = a.shape[1]
    parts = [a[:, k:k + KS] @ w[k:min(k + KS, ka)] for k in range(0, ka, KS)]
    if z is not None:
        parts.append(z @ w[ka:])
    return parts


def _products_t(dh, w):
    """Partials of dh @ w^T over slices of w's columns, reading rows of w."""
    return [dh[:, c:c + KS] @ w[:, c:c + KS].t()
            for c in range(0, dh.shape[1], KS)]


def _gn_fwd(parts, bias, gs, gb, width):
    """The consuming slices' inputs relu(GroupNorm(h)), each slice of KS
    columns built from the partials; returns (h, act)."""
    g = width // GN_GROUPS
    hs, acts = [], []
    for c in range(0, width, KS):
        h = _sum([p[:, c:c + KS] for p in parts]) + bias[c:c + KS]
        x = h.reshape(h.shape[0], -1, g)
        cent = x - x.mean(-1, keepdim=True)
        rstd = 1.0 / torch.sqrt((cent * cent).mean(-1, keepdim=True) + GN_EPS)
        y = (cent * rstd).reshape(h.shape) * gs[c:c + KS] + gb[c:c + KS]
        hs.append(h)
        acts.append(torch.relu(y))
    return torch.cat(hs, 1), torch.cat(acts, 1)


def _gn_bwd(parts, h, gs, gb):
    """The consuming slices' cotangents d h, each slice of KS columns
    built from the partials of d relu(GroupNorm(h)) and the stored h."""
    width = h.shape[1]
    g = width // GN_GROUPS
    out = []
    for c in range(0, width, KS):
        da = _sum([p[:, c:c + KS] for p in parts])
        x = h[:, c:c + KS].reshape(h.shape[0], -1, g)
        cent = x - x.mean(-1, keepdim=True)
        r = 1.0 / torch.sqrt((cent * cent).mean(-1, keepdim=True) + GN_EPS)
        y = (cent * r).reshape(da.shape) * gs[c:c + KS] + gb[c:c + KS]
        gg = (torch.where(y > 0, da, torch.zeros_like(da))
              * gs[c:c + KS]).reshape(x.shape)
        dcent = r * gg - r * r * r * cent * (gg * cent).mean(-1, keepdim=True)
        out.append((dcent - dcent.mean(-1, keepdim=True)).reshape(da.shape))
    return torch.cat(out, 1)


def backward_schedule(w, saved, z, t2j, dout):
    """rollout_backward_plain's result computed in the kernel's phases,
    on buffers kept as the kernel keeps them: every phase reads the
    buffers as they stood before it and its writes land after it (the
    kernel's blocks run a phase's jobs at once), so a buffer that the
    schedule overwrote too early would give a wrong result. A layer's
    product writes partials per K-slice; its output is finished in the
    same phase (partials in slice order, then bias and GroupNorm+ReLU, or
    the VJP), and the next phase reads the finished output."""
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
    buf = {"dz": torch.empty_like(z), "dt2j": torch.zeros_like(t2j),
           "dcur": [None, None], "h": {}}

    def recompute(l, t, out):
        """Layer l's product for step t, finished: h and relu(GN(h)), or a
        head's output."""
        first, dec = l in (0, 5), l >= 5
        x = saved[t][:, :RK.D_X] if first else buf[("out", l - 1)]
        parts = _products(x, lw[l], z[t] if dec else None)
        if gs[l] is None:
            out[("out", l)] = _sum(parts) + bias[l]
            return
        h, act = _gn_fwd(parts, bias[l], gs[l], gb[l], lw[l].shape[1])
        out[("h", l, t % 2)] = h
        out[("out", l)] = act

    def backward(l, t, out):
        """Layer l's transposed product for step t, finished: its z columns
        into dz[t], layer 0's into dx, a hidden layer's input through the
        GroupNorm+ReLU VJP at the stored h."""
        first, dec = l in (0, 5), l >= 5
        head = l in (4, 8)
        dh = (buf["dp"] if l == 4 else buf["ddraw"] if l == 8
              else buf[("dh", l + 1)])
        parts = _products_t(dh, lw[l])
        if dec:
            zcols = _sum([p[:, -RK.LATENT:] for p in parts])
            out[("dz", t)] = zcols if head else buf["dz"][t] + zcols
            parts = [p[:, :-RK.LATENT] for p in parts]
        if first:
            out[("dh", l)] = _sum(parts)
        else:
            out[("dh", l)] = _gn_bwd(parts, buf["h"][(l - 1, t % 2)],
                                     gs[l - 1], gb[l - 1])

    def carry_cot(dcur):
        dx = buf[("dh", 5)] + buf[("dh", 0)]
        return dcur + torch.cat([dx, torch.zeros_like(dcur[:, RK.D_X:])], 1)

    def tail(t, out):
        dnext = (torch.zeros_like(saved[t]) if t == T_ - 1
                 else carry_cot(buf["dcur"][(t + 1) % 2]))
        dcur, ddraw, dp, dt = RK.tail_vjp(saved[t], t2j, buf[("out", 8)],
                                          buf[("out", 4)], dout[t], dnext)
        out[("dcur", t % 2)] = dcur
        out["ddraw"], out["dp"] = ddraw, dp
        out["dt2j"] = buf["dt2j"] + dt

    def commit(out):
        for key, v in out.items():
            if key[0] == "dz":
                buf["dz"][key[1]] = v
            elif key[0] == "dcur":
                buf["dcur"][key[1]] = v
            elif key[0] == "h":
                buf["h"][key[1:]] = v
            else:
                buf[key] = v

    # iteration t: F_k(t) (prior layer k, decoder layer k) beside B_k(t + 1)
    # (prior layer 4 - k, decoder layer 3 - k) for k = 0..4, then TL(t)
    for t in range(T_ - 1, -2, -1):
        for k in range(5):
            out = {}
            if t >= 0:
                for l in (k, 5 + k)[:1 if k == 4 else 2]:
                    recompute(l, t, out)
            if t + 1 < T_:
                for l in (4 - k, 8 - k)[:1 if k == 4 else 2]:
                    backward(l, t + 1, out)
            commit(out)
        if t >= 0:
            out = {}
            tail(t, out)
            commit(out)
    return carry_cot(buf["dcur"][0]), buf["dz"], buf["dt2j"]


@pytest.fixture(scope="module")
def params():
    return H.init_params(H.HumorConfig(), torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_schedule_matches_plain_vjp(params, M, dtype, tol):
    w = RK.RolloutWeights(params, "cpu", dtype=dtype)
    carry0, z, t2j, dout = (a.to(dtype) for a in chip_smoke.rollout_inputs(
        M, T, seed=M, device="cpu"))
    with torch.no_grad():
        _, saved = RK.rollout_forward_plain(w, carry0, z, t2j)
        got = backward_schedule(w, saved, z, t2j, dout)
        want = RK.rollout_backward_plain(w, saved, z, t2j, dout)
    for name, a, b in zip(("dcarry0", "dz", "dt2j"), got, want):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= tol, f"{name}: max-scaled {err:.3e} > {tol}"
