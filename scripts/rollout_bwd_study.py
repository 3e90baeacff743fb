#!/usr/bin/env python3
"""Build sources of a rollout kernel and report, for each, what ptxas says
(registers, spills), its time on the card, and where a call's time goes
step by step.

    python3 scripts/rollout_bwd_study.py humor_torch/csrc/rollout_bwd.cu \
        _proof/rollout_bwd_other.cu
    python3 scripts/rollout_fwd_study.py humor_torch/csrc/rollout_fwd.cu \
        _proof/old/rollout_fwd.cu

Each source has the C interface of humor_torch/csrc/rollout_bwd.cu (this
script) or of rollout_fwd.cu (rollout_fwd_study.py, which runs this
script's `main` for the forward): an earlier version (`git show
REV:path`) or a copy with other sizes, kept in a directory .gitignore
lists. Each is built with the port's nvcc flags plus `-Xptxas -v` (with
the source's own directory, then humor_torch/csrc, on the include path,
so that an older source finds the headers it was written against where
they are put beside it) into build/rollout_study/, up to three times:
as it is; as a traced copy in which thread 0 of block 0 stores clock64()
at marks; and, where it has the current layout or the barrier layout
before it, as a copy in which thread 0 of every block adds up its cycles
by activity. The shared machinery (rollout_persistent.cuh, the source's
own where it lies beside it) is pasted into the copies, so that the marks
reach into it.

Times are CUDA events over 5 calls at T=59 and M = 16 and 128 (the damped
weights and inputs of chip_smoke.py), the sources in turns (a b ... b a).
The traced copy, run once at each M, gives:
  * for a source with grid barriers in its step loop (`<kind>_barriers_
    per_step`; before the ready counters), each phase's share of the call
    (the cycles from one barrier to the next, averaged over the steps: the
    backward's F0-F4 recompute, TL tail, B0-B4 backward, with F_k of step t
    beside B_k of step t + 1 where the source pipelines them; the
    forward's P_k|D_k, the previous step's P4 in phase 0, and TL) and,
    scaled by the untraced time, its microseconds a step;
  * for a source without them (`<kind>_barriers_per_call`: blocks flow
    from phase to phase on ready counters), block 0's cycles from the
    start of one step to the next, as microseconds a step (its mean and
    its largest over the steps), and the set-up before the first step.
A source that launches a kernel a layer gives instead the device time of
each of its kernels a step, from torch.profiler. The activity copy
(listing a phase's tasks; waiting for a unit's input, with the poll for
the next task's; the units' products; arriving; waiting for a finished
tile's K-slices and its guards; finishing it; the tail with its wait; the
grid barriers; the rest) gives each activity's microseconds a step, the
mean over blocks and the largest. Each source's wait tally (ready-waits
and the ones that spun, a call) is printed where it has one. Needs a GPU
and nvcc; prints one JSON line per source, then the card's name and power
limit.
"""

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS = 59
ROWS = (16, 128)
HEADER = "rollout_persistent.cuh"
# per kernel: its C entry's pointer arguments, the phases between two
# barriers by a barrier source's barriers a step, the phases after the
# last step's (a pipelined backward runs 5 more, the forward its last
# prior head), and the head of the step loop of a source without them
KINDS = {
    "rollout_bwd": {
        "ptrs": 8,
        "phases": {11: ("F0", "F1", "F2", "F3", "F4", "TL", "B0", "B1",
                        "B2", "B3", "B4"),
                   6: ("F0|B0", "F1|B1", "F2|B2", "F3|B3", "F4|B4", "TL")},
        "trailing": {11: 0, 6: 5},
        "step_loop": "  for (int t = P.T - 1; t >= -1; --t) {\n"},
    "rollout_fwd": {
        "ptrs": 6,
        "phases": {5: ("P0|D0|P4", "P1|D1", "P2|D2", "P3|D3", "TL")},
        "trailing": {5: 1},
        "step_loop": "  for (int t = 0; t <= P.T; ++t) {\n"},
}
# the end of a flowing source's kernel (after its last step)
FLOW_END = "  add_tally(bs, P.cnt.stats);\n"
COMMON = '#include "rollout_common.cuh"'
MARK_DEFS = """
__device__ long long humor_marks[1 << 16];
__device__ int humor_next;
__device__ __forceinline__ void humor_mark() {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    humor_marks[humor_next++] = clock64();
}
"""
# where a block's time goes, summed over a call: thread 0 of every block
# adds the clock64() cycles since its previous tick to a slot
SLOTS = ("other", "barrier", "input_wait", "product", "finish", "tail",
         "arrive", "finish_wait", "listing")
TICK_DEFS = """
__device__ long long humor_slots[1024][16];
__device__ long long humor_last[1024];
__device__ __forceinline__ void humor_tick(int slot) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    humor_slots[blockIdx.x][slot] += now - humor_last[blockIdx.x];
    humor_last[blockIdx.x] = now;
  }
}
"""
TICK_READ = """
extern "C" int humor_clear_slots(void) {
  static long long zero[1024 * 16];
  return (int)cudaMemcpyToSymbol(humor_slots, zero, sizeof(zero));
}
extern "C" int humor_read_slots(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, humor_slots,
                                   sizeof(long long) * 16384);
}
"""
# (anchors, text after it) of the ticks: the first anchor found once is
# used (the first ones are the current sources', with the header pasted
# in; then the barrier layout's before the ready counters; then the
# earlier single-file backward's)
TICK_AT = (
    (("cg::grid_group grid = cg::this_grid();",),
     "\n if (threadIdx.x == 0) humor_last[blockIdx.x] = clock64();"),
    (("    __syncthreads();   // unit x staged; unit x - 1's buffer free\n",),
     " humor_tick(2);\n"),
    (("                 tiles + u.slot * TILE);\n",), " humor_tick(3);\n"),
    (("    release_add(u.bwd ? L.cnt_b + u.s : L.cnt_f + u.nn);\n  }\n",
      "    atomicAdd(u.bwd ? L.cnt_b + u.s : L.cnt_f + u.nn, 1);\n  }\n"),
     " humor_tick(6);\n"),
    (("      return finish_dep(bs, bwd, l, o / R, o % R, use, j, p);\n"
      "    });\n",
      "    __syncthreads();   // the tile's K-slices have arrived\n",
      "      *cnt = 0;\n    }\n    __syncthreads();\n"), " humor_tick(7);\n"),
    (("    finish(bwd, l, o / R, sl.seg_step[sg], (o % R) * RT);\n",
      "    finish(bwd, l, tile, sl.seg_step[sg], row0);\n    __syncthreads();\n",
      "      finish_fwd(P, Ls, l, o, sl.seg_step[sg]);\n    __syncthreads();\n"),
     " humor_tick(4);\n"),
    (("tail_phase(P, bs, t, ring);\n", "      tail_phase(P, Ls, t, ring);\n"),
     " humor_tick(5);\n"),
    (("  __syncthreads();\n  const int n = sl.n;\n",), " humor_tick(8);\n"),
)
MARK_READ = """
extern "C" int humor_clear_marks(void) {
  static long long zero[1 << 16];
  const int first = 0;
  cudaError_t e = cudaMemcpyToSymbol(humor_next, &first, sizeof(first));
  if (e) return (int)e;
  return (int)cudaMemcpyToSymbol(humor_marks, zero, sizeof(zero));
}
extern "C" int humor_read_marks(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, humor_marks, sizeof(long long) * n);
}
"""


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def pasted(text, src_dir):
    """The source with the shared header's text in place of its include
    (the header beside the source, else the current one)."""
    inc = f'#include "{HEADER}"'
    if inc not in text:
        return text
    from humor_torch.ops import cuda_build

    header = src_dir / HEADER
    if not header.exists():
        header = cuda_build.CSRC / HEADER
    body = header.read_text().replace("#pragma once\n", "")
    return text.replace(inc, body)


def traced(text, kind):
    """The source with a clock mark at the start and after each barrier
    (a barrier source), or at the start, at each step and at the end (a
    flowing one); None where it has no grid barrier (a launch a layer)."""
    start = "cg::grid_group grid = cg::this_grid();"
    if start not in text or "grid.sync();" not in text:
        return None
    text = text.replace(COMMON, COMMON + "\n" + MARK_DEFS, 1)
    loop = KINDS[kind]["step_loop"]
    if FLOW_END in text and text.count(loop) == 1:
        text = text.replace(loop, loop + " humor_mark();\n")
        text = text.replace(FLOW_END, " humor_mark();\n" + FLOW_END)
    else:
        text = text.replace("grid.sync();", "grid.sync();\n humor_mark();")
    text = text.replace(start, start + "\n humor_mark();")
    return text + MARK_READ


def ticked(text):
    """The source with the slot ticks, or None where its layout differs."""
    found = []
    for anchors, after in TICK_AT:
        anchor = next((a for a in anchors if text.count(a) == 1), None)
        if anchor is None:
            return None
        found.append((anchor, after))
    for anchor, after in found:
        text = text.replace(anchor, anchor + after)
    text = text.replace("grid.sync();",
                        "humor_tick(0);\n grid.sync();\n humor_tick(1);")
    text = text.replace(COMMON, COMMON + "\n" + TICK_DEFS, 1)
    return text + TICK_READ


def build(src, out, src_dir, kind):
    from humor_torch.ops import cuda_build
    from humor_torch.ops import rollout_kernel as RK

    p = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-I", str(src_dir), "-I", str(cuda_build.CSRC),
                        "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, kind)
    fn.argtypes = ([ctypes.POINTER(RK._WeightsStruct)]
                   + [ctypes.c_void_p] * KINDS[kind]["ptrs"]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    return lib, ptxas


def scratch_floats(lib, kind, M):
    """The source's scratch query: the forward's takes the steps since the
    running carry of every step lives there; the earlier forward, a
    launch a layer, named it otherwise and took M only."""
    if kind == "rollout_bwd":
        fn, args = lib.rollout_bwd_scratch_floats, (M,)
    elif hasattr(lib, "rollout_fwd_scratch_floats"):
        fn, args = lib.rollout_fwd_scratch_floats, (M, STEPS)
    else:
        fn, args = lib.rollout_scratch_floats, (M,)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_longlong
    return fn(*args)


def kernel_us_a_step(call):
    """Device microseconds a step of each kernel one call enqueues."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    per = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[re.sub(r"\(.*", "", e.name)[:60]] += (
                e.time_range.elapsed_us() / STEPS)
    return dict(per)


def main(kind="rollout_bwd"):
    import torch

    import chip_smoke as CS
    from humor_torch.models import humor as H
    from humor_torch.ops import rollout_kernel as RK

    if not torch.cuda.is_available():
        sys.exit(f"{kind} study: no CUDA device")
    spec = KINDS[kind]
    out_dir = ROOT / "build" / "rollout_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    params = H.init_params(H.HumorConfig(), torch.Generator().manual_seed(1))
    w = RK.RolloutWeights(CS.damped(params, 0.1), dev)
    inputs = {}
    for M in ROWS:
        carry0, z, t2j, dout = CS.rollout_inputs(M, STEPS, seed=M)
        if kind == "rollout_bwd":
            _, saved = RK.rollout_forward(w, carry0, z, t2j)
            inputs[M] = (saved, z, t2j, dout)
        else:
            inputs[M] = (carry0, z, t2j)

    last_scratch = [None]   # the latest call's scratch (its wait tally)

    def run(lib, M):
        if kind == "rollout_bwd":
            saved, z, t2j, _ = inputs[M]
            out = (torch.empty(M, RK.CW, device=dev), torch.empty_like(z),
                   torch.empty_like(t2j))
        else:
            carry0, z, t2j = inputs[M]
            out = (torch.empty(STEPS, M, RK.OUT_W, device=dev),
                   torch.empty(STEPS, M, RK.CW, device=dev))
        scratch = torch.empty(scratch_floats(lib, kind, M), device=dev)
        last_scratch[0] = scratch
        rc = getattr(lib, kind)(
            ctypes.byref(w.struct()), *(t.data_ptr() for t in inputs[M]),
            *(o.data_ptr() for o in out), scratch.data_ptr(), M, STEPS,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kind} launch failed: CUDA error {rc}")
        return out

    libs, found = [], []
    for k, src in enumerate(sys.argv[1:]):
        src = Path(src).resolve()
        # each copy in a namespace of its own, so that no two libraries
        # share a C++ symbol (a function-local static of an inline
        # function is one object per process otherwise)
        text = pasted(f"#define humor humor_study{k}\n" + src.read_text(),
                      src.parent)
        made = {}
        for kind_of, body in (("", text), ("_traced", traced(text, kind)),
                              ("_ticked", ticked(text))):
            if body is None:
                made[kind_of] = None
                continue
            copy = out_dir / f"{kind}{k}{kind_of}.cu"
            copy.write_text(body)
            made[kind_of] = build(copy, out_dir / f"lib{kind}{k}{kind_of}.so",
                                  src.parent, kind)
        lib, ptxas = made[""]
        tlib = made["_traced"] and made["_traced"][0]
        plib = made["_ticked"] and made["_ticked"][0]
        if tlib is not None:
            tlib.humor_read_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if plib is not None:
            plib.humor_read_slots.argtypes = [ctypes.c_void_p]
        libs.append((lib, tlib, plib))
        found.append({"source": str(src.relative_to(ROOT)), "ptxas": ptxas,
                      "ms": {}, "phases": {}})
    order = list(range(len(libs)))
    for M in ROWS:
        for k in order + order[::-1]:
            found[k]["ms"].setdefault(f"M={M}", []).append(
                CS.cuda_ms(lambda: run(libs[k][0], M), 5))
        ref = run(libs[0][0], M)
        for k, (lib, tlib, plib) in enumerate(libs):
            got = run(lib, M)
            found[k].setdefault("equal_to_first", {})[f"M={M}"] = all(
                bool(torch.equal(a, b)) for a, b in zip(got, ref))
            # each output's largest difference over its largest magnitude
            found[k].setdefault("max_scaled_to_first", {})[f"M={M}"] = max(
                ((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, ref))
            ms = min(found[k]["ms"][f"M={M}"])
            if tlib is None:
                found[k].setdefault("kernels_us_a_step", {})[f"M={M}"] = (
                    kernel_us_a_step(lambda: run(lib, M)))
                continue
            torch.cuda.synchronize()
            if tlib.humor_clear_marks() != 0:
                raise RuntimeError("clearing the marks failed")
            run(tlib, M)
            torch.cuda.synchronize()
            n = 16 * STEPS
            marks = (ctypes.c_longlong * n)()
            rc = tlib.humor_read_marks(ctypes.addressof(marks), n)
            if rc != 0:
                raise RuntimeError(f"reading the marks failed: {rc}")
            used = next(i for i in range(1, n) if marks[i] == 0)
            cyc = [marks[i + 1] - marks[i] for i in range(used - 1)]
            us_cycle = 1e3 * ms / (marks[used - 1] - marks[0])
            per_step = getattr(lib, kind + "_barriers_per_step", None)
            if per_step is not None:
                per_step = per_step()
            if per_step is None:
                # flowing: start, each step's start, end; the loop's last
                # iteration (the forward's last prior head, the backward's
                # last step) is not a whole step
                steps = cyc[1:1 + STEPS]
                found[k]["barriers_per_call"] = getattr(
                    lib, kind + "_barriers_per_call")()
                found[k].setdefault("setup_us", {})[f"M={M}"] = (
                    us_cycle * cyc[0])
                found[k].setdefault("step_us", {})[f"M={M}"] = {
                    "mean": us_cycle * sum(steps) / len(steps),
                    "max": us_cycle * max(steps),
                    "last_iteration": us_cycle * sum(cyc[1 + STEPS:])}
                run(lib, M)
                torch.cuda.synchronize()
                found[k].setdefault("waits_a_call", {})[f"M={M}"] = dict(
                    zip(("waits", "stalled"),
                        last_scratch[0][:2].view(torch.int32).tolist()))
            else:
                names = spec["phases"][per_step]
                # a set-up phase before the steps (loading the weights),
                # and whole steps only
                lead = (len(cyc) - len(names) * STEPS
                        - spec["trailing"][per_step])
                setup = sum(cyc[:lead])
                cyc = cyc[lead:lead + len(names) * STEPS]
                per = [sum(cyc[i::len(names)]) / STEPS
                       for i in range(len(names))]
                total = sum(per)
                found[k]["barriers"] = used - 1
                found[k].setdefault("setup_us", {})[f"M={M}"] = (
                    us_cycle * setup)
                found[k]["phases"][f"M={M}"] = {
                    name: {"cycles": c, "share": c / total,
                           "us_a_step": 1e3 * ms * c / total / STEPS}
                    for name, c in zip(names, per)}
            if plib is not None:
                torch.cuda.synchronize()
                if plib.humor_clear_slots() != 0:
                    raise RuntimeError("clearing the slots failed")
                run(plib, M)
                torch.cuda.synchronize()
                slots = (ctypes.c_longlong * 16384)()
                if plib.humor_read_slots(ctypes.addressof(slots)) != 0:
                    raise RuntimeError("reading the slots failed")
                grid = getattr(lib, kind + "_grid_blocks")()
                per_block = [[slots[16 * b + i] for i in range(len(SLOTS))]
                             for b in range(grid)]
                found[k].setdefault("slots_us_a_step", {})[f"M={M}"] = {
                    name: {"mean": us_cycle / STEPS * sum(
                        b[i] for b in per_block) / grid,
                           "max": us_cycle / STEPS * max(
                               b[i] for b in per_block)}
                    for i, name in enumerate(SLOTS)}
    for f in found:
        print(json.dumps(f))
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
