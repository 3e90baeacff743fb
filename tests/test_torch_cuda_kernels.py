"""The CUDA kernels against their plain PyTorch versions: the fused
rollout (humor_torch/ops/rollout_kernel.py) at full width, M=3 rows, T=6
steps, both kernels also at the edge sizes of chip_smoke.py (rows off and
on their tiles, 1, 2 and 6 steps), twice on the same inputs
(bit-identical), as one device kernel a call and with their wait counters
read only under a recording; the nearest neighbour
(humor_torch/ops/chamfer.py) at sizes off and on the edges of its chunks,
tiles and blocks; and the skinning kernels (humor_torch/ops/skinning.py)
at the edges of their tiles and blocks and at a training step's shape.
The kernels have no CPU mode, so these tests skip without a GPU; this
file imports no JAX, so it also runs on a machine that has none (skip
tests/conftest.py there, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from humor_torch.models import humor as H
from humor_torch.ops import chamfer as CH
from humor_torch.ops import cuda_build
from humor_torch.ops import rollout_kernel as RK
from humor_torch.ops import skinning as SK
from humor_torch.ops import transforms as TT
from humor_torch.utils import profiling

M, T = 3, 6


@pytest.fixture(scope="module", autouse=True)
def kernels_built():
    """Every kernel library built before this file's first profile: a
    build after torch.profiler has traced in the process (nvcc runs as a
    child process) left the later traces without their kernels' records
    on the card."""
    if torch.cuda.is_available():
        cuda_build.build(["rollout_fwd", "rollout_bwd", "nn_distance",
                          "skinning"])


@pytest.fixture
def cuda_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    w = RK.RolloutWeights(H.init_params(H.HumorConfig(), g), dev)
    rng = np.random.RandomState(5)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    carry0 = torch.cat([
        f(0.3 * rng.randn(M, 18)),
        TT.aa_to_rotmat(f(0.3 * rng.randn(M, 21, 3))).reshape(M, 189),
        f(0.3 * rng.randn(M, 132)),
        TT.aa_to_rotmat(f(rng.randn(M, 3))).reshape(M, 9),
        f(rng.randn(M, 3))], dim=-1)
    carry0[:, 6:15] = TT.aa_to_rotmat(f(rng.randn(M, 3))).reshape(M, 9)
    z = f(0.5 * rng.randn(T, M, 48))
    t2j = f(0.05 * rng.randn(M, 3))
    dout = f(rng.randn(T, M, RK.OUT_W))
    return w, [t.to(dev).contiguous() for t in (carry0, z, t2j, dout)]


@pytest.mark.cuda
def test_forward_kernel_matches_plain(cuda_inputs):
    """Whole 6-step chain, 1e-4 abs (f32 summation order; the chain is
    well-conditioned over 6 steps)."""
    w, (carry0, z, t2j, _) = cuda_inputs
    n0 = RK.launches["rollout_fwd"]
    out_k, saved_k = RK.rollout_forward(w, carry0, z, t2j)
    assert RK.launches["rollout_fwd"] == n0 + 1
    out_p, saved_p = RK.rollout_forward_plain(w, carry0, z, t2j)
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(saved_k.cpu().numpy(), saved_p.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.cuda
def test_backward_kernel_matches_plain(cuda_inputs):
    """Hand VJP in CUDA against the hand VJP in torch on the same saved
    carries, max-scaled 1e-4."""
    w, (carry0, z, t2j, dout) = cuda_inputs
    _, saved = RK.rollout_forward_plain(w, carry0, z, t2j)
    gk = RK.rollout_backward(w, saved, z, t2j, dout)
    gp = RK.rollout_backward_plain(w, saved, z, t2j, dout)
    for name, a, b in zip(("dcarry0", "dz", "dt2j"), gk, gp):
        b = b.cpu().numpy()
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a.cpu().numpy() / scale, b / scale,
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def cuda_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    return RK.RolloutWeights(H.init_params(H.HumorConfig(), g),
                             torch.device("cuda"))


EDGE_SIZES = [(m, t) for m in chip_smoke.EDGE_M for t in chip_smoke.EDGE_T]


@pytest.mark.cuda
@pytest.mark.parametrize("size", EDGE_SIZES, ids=lambda s: "M%d-T%d" % s)
def test_forward_kernel_edge_sizes(cuda_weights, size):
    """The forward kernel against the plain forward at M rows and T steps,
    out and the saved carries within 1e-4 abs + 1e-4 rel as at M=3."""
    M, steps = size
    carry0, z, t2j, _ = chip_smoke.rollout_inputs(M, steps,
                                                  seed=200 + M + steps)
    out_k, saved_k = RK.rollout_forward(cuda_weights, carry0, z, t2j)
    out_p, saved_p = RK.rollout_forward_plain(cuda_weights, carry0, z, t2j)
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(saved_k.cpu().numpy(), saved_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("size", EDGE_SIZES, ids=lambda s: "M%d-T%d" % s)
def test_backward_kernel_edge_sizes(cuda_weights, size):
    """The backward kernel against the plain VJP at M rows and T steps:
    every row within 1e-4 max-scaled as at M=3, but for rows at a float32
    ReLU tie (chip_smoke.check_bwd_edges)."""
    M, steps = size
    carry0, z, t2j, dout = chip_smoke.rollout_inputs(M, steps,
                                                     seed=100 + M + steps)
    _, saved = RK.rollout_forward_plain(cuda_weights, carry0, z, t2j)
    gk = RK.rollout_backward(cuda_weights, saved, z, t2j, dout)
    gp = RK.rollout_backward_plain(cuda_weights, saved, z, t2j, dout)
    assert all(bool(torch.isfinite(a).all()) for a in gk)
    err = chip_smoke.row_errors(gk, gp)
    off = (err > 1e-4).nonzero().flatten()
    if len(off):
        w64 = RK.RolloutWeights(H.init_params(
            H.HumorConfig(), torch.Generator().manual_seed(0)),
            torch.device("cuda"), dtype=torch.float64)
        margin = RK.relu_margins(w64, saved.double(), z.double())[off]
        assert bool((margin < chip_smoke.RELU_TIE).all()), (off, margin)


@pytest.mark.cuda
def test_forward_kernel_is_deterministic(cuda_inputs):
    """Two forward calls on the same inputs give bit-identical outputs."""
    w, (carry0, z, t2j, _) = cuda_inputs
    f1 = RK.rollout_forward(w, carry0, z, t2j)
    f2 = RK.rollout_forward(w, carry0, z, t2j)
    for a, b in zip(f1, f2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda_inputs):
    """Two calls on the same inputs give bit-identical outputs: the split-K
    partials are summed in a fixed order, with no float atomics."""
    w, (carry0, z, t2j, dout) = cuda_inputs
    _, saved = RK.rollout_forward_plain(w, carry0, z, t2j)
    g1 = RK.rollout_backward(w, saved, z, t2j, dout)
    g2 = RK.rollout_backward(w, saved, z, t2j, dout)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def _device_kernels(fn):
    """Names of the device kernels one call of fn enqueues (after a warm-up
    call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
def test_forward_kernel_is_one_launch(cuda_inputs):
    """A forward call enqueues exactly one device kernel (carry0 is copied
    into the saved carries in the kernel, not by a memcpy): the persistent
    cooperative launch."""
    w, (carry0, z, t2j, _) = cuda_inputs
    names = _device_kernels(lambda: RK.rollout_forward(w, carry0, z, t2j))
    assert len(names) == 1 and "rollout_fwd_kernel" in names[0], names


@pytest.mark.cuda
def test_backward_kernel_is_one_launch(cuda_inputs):
    """A backward call enqueues exactly one device kernel (no memset, no
    copy): the persistent cooperative launch."""
    w, (carry0, z, t2j, dout) = cuda_inputs
    _, saved = RK.rollout_forward_plain(w, carry0, z, t2j)
    names = _device_kernels(
        lambda: RK.rollout_backward(w, saved, z, t2j, dout))
    assert len(names) == 1 and "rollout_bwd_kernel" in names[0], names


@pytest.mark.cuda
def test_autograd_function_uses_kernels(cuda_inputs):
    """RolloutFunction on CUDA tensors launches both kernels."""
    w, (carry0, z, t2j, dout) = cuda_inputs
    n_f, n_b = RK.launches["rollout_fwd"], RK.launches["rollout_bwd"]
    leaf = carry0.clone().requires_grad_()
    out = RK.RolloutFunction.apply(leaf, z, t2j, w)
    (out * dout).sum().backward()
    assert RK.launches["rollout_fwd"] == n_f + 1
    assert RK.launches["rollout_bwd"] == n_b + 1
    assert bool(torch.isfinite(leaf.grad).all())


@pytest.mark.cuda
def test_kernels_count_their_waits(cuda_weights):
    """At T=59, M=16, under a recording, each kernel call adds its
    ready-waits and the ones that found their input not yet ready to the
    counters rollout.waits and rollout.waits_stalled: more than 0, and
    stalled no more than waits. With recording off, a call reads nothing
    back (torch's sync debug mode at "error" would raise)."""
    carry0, z, t2j, dout = chip_smoke.rollout_inputs(16, 59, seed=21)
    _, saved = RK.rollout_forward(cuda_weights, carry0, z, t2j)
    calls = {"forward": lambda: RK.rollout_forward(cuda_weights, carry0, z,
                                                   t2j),
             "backward": lambda: RK.rollout_backward(cuda_weights, saved, z,
                                                     t2j, dout)}
    for name, call in calls.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        with profiling.recording() as rec:
            call()
        waits = rec.counters["rollout.waits"]
        stalled = rec.counters["rollout.waits_stalled"]
        assert waits > 0 and 0 <= stalled <= waits, (name, waits, stalled)


def test_kernel_wrapper_checks_inputs():
    """The kernel wrappers refuse what the kernels do not take (here a
    float64 tensor) instead of converting it."""
    g = torch.Generator().manual_seed(0)
    w = RK.RolloutWeights(H.init_params(H.HumorConfig(), g), "cpu")
    with pytest.raises(ValueError):
        RK._check_inputs(w, {"x": torch.zeros(2, dtype=torch.float64)})


def test_kernel_weights_must_be_aligned():
    """The kernels read weights as float4: a weight that starts 4 bytes
    into its storage is refused when the kernels' struct is made."""
    g = torch.Generator().manual_seed(0)
    params = H.init_params(H.HumorConfig(), g)
    b = params["prior"][0]["b"]
    shifted = torch.cat([b.new_zeros(1), b])[1:]
    params["prior"][0] = dict(params["prior"][0], b=shifted)
    w = RK.RolloutWeights(params, "cpu")
    with pytest.raises(ValueError):
        w.struct()


# (clouds, queries, points): prime sizes, then the edges of the kernel's
# chunks, tiles and blocks that chip_smoke.py also checks
NN_SIZES = [(5, 1031, 2053), *chip_smoke.nn_edge_sizes()]


@pytest.mark.cuda
@pytest.mark.parametrize("size", NN_SIZES, ids=lambda s: "x".join(map(str, s)))
def test_nn_kernel_matches_plain(size):
    """Nearest neighbour against the plain version, the last 31 queries at
    1e6, point 7 duplicated (at 1500, or the last point) with query 0
    1 mm from it. Distances within 1e-5 abs on visible queries; an index
    may differ only where the two chosen points' distances lie within 1e-5
    (a near-tie in float32); query 0 takes the first of the duplicates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, n, m = size
    rng = np.random.RandomState(10)
    x = rng.randn(b, n, 3).astype(np.float32)
    y = rng.randn(b, m, 3).astype(np.float32)
    n_vis = n - 31
    x[:, n_vis:] = 1e6
    if m > 8:
        y[:, min(1500, m - 1)] = y[:, 7]
        x[:, 0] = y[:, 7] + 1e-3
    xc, yc = torch.tensor(x).cuda(), torch.tensor(y).cuda()
    n0 = CH.launches["nn_distance"]
    d_k, i_k = CH.nn_forward(xc, yc)
    assert CH.launches["nn_distance"] == n0 + 1
    d_p, i_p = CH.nn_distance_plain(xc, yc)
    d_k, i_k, d_p, i_p = (t.cpu().numpy() for t in (d_k, i_k, d_p, i_p))
    np.testing.assert_allclose(d_k[:, :n_vis], d_p[:, :n_vis], atol=1e-5,
                               rtol=0)
    q = x[:, :n_vis].astype(np.float64)
    pick = lambda i: np.take_along_axis(y, i[..., None].astype(np.int64), 1)
    gap = np.abs(((q - pick(i_k[:, :n_vis])) ** 2).sum(-1)
                 - ((q - pick(i_p[:, :n_vis])) ** 2).sum(-1))
    assert np.all(gap <= 1e-5)
    assert np.all((i_k >= 0) & (i_k < m)) and np.all(np.isfinite(d_k))
    if m > 8:
        assert np.all(i_k[:, 0] == 7)


def test_nn_wrapper_checks_inputs():
    """The nearest-neighbour wrapper refuses a float64 cloud."""
    x = torch.zeros(1, 4, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        CH.nn_forward(x, torch.zeros(1, 5, 3))


# (rows, vertices, joints): the edges of the skinning kernels' tiles and
# blocks that chip_smoke.py also checks, and a training step's bodies
SKIN_SIZES = [*chip_smoke.skin_edge_sizes(), chip_smoke.SKIN_SHAPE]


def _skin_inputs(size, seed, column_major=False):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return chip_smoke.skin_inputs(size, seed, column_major=column_major)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["row-major", "column-major"])
@pytest.mark.parametrize("size", SKIN_SIZES,
                         ids=lambda s: "x".join(map(str, s)))
def test_skin_kernels_match_plain(size, layout):
    """The skinning Function (both kernels, and the plain version's sums
    over the vertices) against the plain einsums and their autograd, with
    the weights in either layout: the vertices and the gradients of Rw,
    t_rel, v_posed and trans within relative 1e-5 of each output's largest
    value, and bit for bit at a training step's shape, where the kernels
    round as the plain path's GEMM and batched GEMVs do."""
    args = _skin_inputs(size, seed=sum(size),
                        column_major=layout == "column-major")
    n0 = dict(SK.launches)
    kern = chip_smoke.skin_grads(SK.Skin.apply, *args)
    launched = size[0] * size[1] > 0
    assert SK.launches == {k: n + launched for k, n in n0.items()}
    plain = chip_smoke.skin_grads(SK.skin_plain, *args)
    for name, a, b in zip(("v", "Rw", "t_rel", "v_posed", "trans"), kern,
                          plain):
        assert a.shape == b.shape, name
        if b.numel():
            assert float((a - b).abs().max()) <= 1e-5 * float(
                b.abs().max()), name
        if size == chip_smoke.SKIN_SHAPE:
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_skin_kernels_are_deterministic():
    """Two calls on the same inputs give bit-identical vertices and
    gradients: the sums over vertices run in a fixed order, with no
    float atomics."""
    w, Rw, t_rel, vp, trans, g = _skin_inputs((40, 6890, 22), seed=3)
    assert torch.equal(SK.skin_forward(w, Rw, t_rel, vp, trans),
                       SK.skin_forward(w, Rw, t_rel, vp, trans))
    for a, b in zip(SK.skin_backward(w, Rw, vp, g),
                    SK.skin_backward(w, Rw, vp, g)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(9, 300, 22), (3, 0, 22)],
                         ids=["vertices", "no-vertex"])
def test_skin_kernels_are_one_launch(size):
    """A forward and a backward kernel call each enqueue one device kernel,
    of their own name; a call with no vertex launches none."""
    w, Rw, t_rel, vp, trans, g = _skin_inputs(size, seed=4)
    fwd = _device_kernels(lambda: SK.skin_forward(w, Rw, t_rel, vp, trans))
    bwd = _device_kernels(lambda: SK.skin_backward(w, Rw, vp, g))
    if size[1]:
        assert len(fwd) == 1 and "skin_fwd_kernel" in fwd[0], fwd
        assert len(bwd) == 1 and "skin_bwd_kernel" in bwd[0], bwd
    else:
        assert fwd == [] and bwd == [], (fwd, bwd)


@pytest.mark.cuda
def test_lbs_uses_skin_kernels():
    """smpl.lbs in float32 on the card skins through the kernels, forward
    and backward, and counts `smpl.skin_kernel` once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from humor_torch.body_model import smpl as SM
    from humor_torch.utils import profiling as PR

    body = SM.synthetic_smpl_model(seed=5, num_verts=6890, device="cuda")
    rng = np.random.RandomState(6)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    mats = TT.aa_to_rotmat(f(0.4 * rng.randn(16, 22, 3))).requires_grad_()
    n0 = dict(SK.launches)
    with PR.recording() as rec:
        out = SM.lbs(body, f(rng.randn(16, 16)), mats, f(rng.randn(16, 3)))
    (out.v ** 2).sum().backward()
    assert SK.launches == {"skin_fwd": n0["skin_fwd"] + 1,
                           "skin_bwd": n0["skin_bwd"] + 1}
    assert rec.counters["smpl.skin_kernel"] == 1
    assert bool(torch.isfinite(mats.grad).all())


def _skin_case(case):
    """CPU inputs for the wrapper's checks, all right but for `case`."""
    w, Rw, t_rel, vp, trans, _ = chip_smoke.skin_inputs((2, 5, 22), 0,
                                                        device="cpu")
    if case == "float64":
        vp = vp.double()
    elif case == "strided":
        vp = vp.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "shape":
        trans = trans[:1]
    elif case == "joints":
        w, Rw, t_rel = (torch.cat([t] * 3, dim=1) for t in (w, Rw, t_rel))
    return w, Rw, t_rel, vp, trans


@pytest.mark.parametrize("case, match", [
    ("float64", "float64"), ("strided", "strided"), ("shape", "must be"),
    ("joints", "joints"), ("cpu", "CUDA device")])
def test_skin_wrapper_checks_inputs(case, match):
    """The skinning wrappers refuse what the kernels do not take (another
    dtype, a strided tensor, a wrong shape, more joints than the kernels
    hold, tensors off the card) instead of converting it."""
    w, Rw, t_rel, vp, trans = _skin_case(case)
    with pytest.raises(ValueError, match=match):
        SK.skin_forward(w, Rw, t_rel, vp, trans)
    with pytest.raises(ValueError, match=match):
        SK.skin_backward(w, Rw, vp, vp if case != "shape" else vp[:, :1])
