#!/usr/bin/env python3
"""Build sources of the rollout backward kernel and report, for each, what
ptxas says (registers, spills), its time on the card, and where a call's
time goes phase by phase.

    python3 scripts/rollout_bwd_study.py humor_torch/csrc/rollout_bwd.cu \
        _proof/rollout_bwd_other.cu

Each source has the C interface of humor_torch/csrc/rollout_bwd.cu: an
earlier version (`git show REV:path`) or a copy with other sizes, kept in
a directory .gitignore lists. Each is built with the port's nvcc flags
plus `-Xptxas -v` (and humor_torch/csrc on the include path) into
build/rollout_bwd_study/, twice: as it is, and as
a traced copy in which thread 0 of block 0 stores clock64() after every
grid.sync(). Times are CUDA events over 5 calls at T=59 and M = 16 and
128 (the damped weights and inputs of chip_smoke.py), the sources in
turns (a b ... b a). The traced copy, run once at each M, gives each
phase's share of the call (F0-F4 recompute, TL tail, B0-B4 backward:
the cycles from one barrier to the next, averaged over the steps; with
F_k of step t beside B_k of step t + 1 where the source pipelines them)
and, scaled by the untraced time, its microseconds a step. Where the
source has the current layout, a third copy in which thread 0 of every
block adds up its cycles by activity (waiting for a unit's input, the
units' products, arriving, waiting for a finished tile's K-slices,
finishing it, the tail, the barriers, the rest) gives each activity's
microseconds a step, the mean over blocks and the largest. Needs a GPU and
nvcc; prints one JSON line per source, then the card's name and power
limit.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS = 59
STAGES = 5             # phases after the last tail of a pipelined source
ROWS = (16, 128)
# the phases between two barriers, by a source's barriers a step: one
# phase each (F0-F4, the tail, B0-B4), or F_k of step t beside B_k of step
# t + 1, then the tail of step t
PHASE_NAMES = {11: ("F0", "F1", "F2", "F3", "F4", "TL", "B0", "B1", "B2",
                    "B3", "B4"),
               6: ("F0|B0", "F1|B1", "F2|B2", "F3|B3", "F4|B4", "TL")}
MARK_DEFS = """
__device__ long long humor_marks[1 << 16];
__device__ __forceinline__ void humor_mark(long long i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) humor_marks[i] = clock64();
}
"""
# where a block's time goes, summed over a call: thread 0 of every block
# adds the clock64() cycles since its previous tick to a slot
SLOTS = ("other", "barrier", "input_wait", "product", "finish", "tail",
         "arrive", "finish_wait")
TICK_DEFS = """
__device__ long long humor_slots[1024][8];
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
  static long long zero[1024 * 8];
  return (int)cudaMemcpyToSymbol(humor_slots, zero, sizeof(zero));
}
extern "C" int humor_read_slots(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, humor_slots, sizeof(long long) * 8192);
}
"""
# (anchor, text after it) of the ticks in the current source's layout
TICK_AT = (
    ("cg::grid_group grid = cg::this_grid();",
     "\n if (threadIdx.x == 0) humor_last[blockIdx.x] = clock64();"),
    ("    __syncthreads();   // unit x staged; unit x - 1's buffer free\n",
     " humor_tick(2);\n"),
    ("                 tiles + u.slot * TILE);\n", " humor_tick(3);\n"),
    ("    atomicAdd(u.bwd ? L.cnt_b + u.s : L.cnt_f + u.nn, 1);\n  }\n",
     " humor_tick(6);\n"),
    ("      *cnt = 0;\n    }\n    __syncthreads();\n", " humor_tick(7);\n"),
    ("      finish_fwd(P, Ls, l, o, sl.seg_step[sg]);\n    __syncthreads();\n",
     " humor_tick(4);\n"),
    ("      tail_phase(P, Ls, t, ring);\n", " humor_tick(5);\n"),
)
MARK_READ = """
extern "C" int humor_clear_marks(void) {
  static long long zero[1 << 16];
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


def traced(text):
    """The source with a clock mark at the start and after each barrier."""
    start = "cg::grid_group grid = cg::this_grid();"
    if start not in text or "grid.sync();" not in text:
        raise ValueError("no grid.sync() to trace")
    text = text.replace('#include "rollout_common.cuh"',
                        '#include "rollout_common.cuh"\n' + MARK_DEFS)
    text = text.replace("grid.sync();", "grid.sync();\n humor_mark(mk_++);")
    text = text.replace(start,
                        start + "\n long long mk_ = 0; humor_mark(mk_++);")
    return text + MARK_READ


def ticked(text):
    """The source with the slot ticks, or None where its layout differs."""
    for anchor, _ in TICK_AT:
        if text.count(anchor) != 1:
            return None
    for anchor, after in TICK_AT:
        text = text.replace(anchor, anchor + after)
    text = text.replace("grid.sync();",
                        "humor_tick(0);\n grid.sync();\n humor_tick(1);")
    text = text.replace('#include "rollout_common.cuh"',
                        '#include "rollout_common.cuh"\n' + TICK_DEFS)
    return text + TICK_READ


def build(src, out):
    from humor_torch.ops import cuda_build

    p = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-I", str(cuda_build.CSRC), "-o", str(out),
                        str(src)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(out))
    from humor_torch.ops import rollout_kernel as RK

    fn = lib.rollout_bwd
    fn.argtypes = ([ctypes.POINTER(RK._WeightsStruct)] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.rollout_bwd_scratch_floats.argtypes = [ctypes.c_int]
    lib.rollout_bwd_scratch_floats.restype = ctypes.c_longlong
    ptxas = [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
             if "rollout_bwd_kernel" in ln or "registers" in ln
             or "spill" in ln]
    return lib, ptxas


def main():
    import torch

    import chip_smoke as CS
    from humor_torch.models import humor as H
    from humor_torch.ops import rollout_kernel as RK

    if not torch.cuda.is_available():
        sys.exit("rollout_bwd_study: no CUDA device")
    out_dir = ROOT / "build" / "rollout_bwd_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    params = H.init_params(H.HumorConfig(), torch.Generator().manual_seed(1))
    w = RK.RolloutWeights(CS.damped(params, 0.1), dev)
    inputs = {}
    for M in ROWS:
        carry0, z, t2j, dout = CS.rollout_inputs(M, STEPS, seed=M)
        _, saved = RK.rollout_forward(w, carry0, z, t2j)
        inputs[M] = (saved, z, t2j, dout)

    def run(lib, M):
        saved, z, t2j, dout = inputs[M]
        out = (torch.empty(M, RK.CW, device=dev), torch.empty_like(z),
               torch.empty_like(t2j))
        scratch = torch.empty(lib.rollout_bwd_scratch_floats(M), device=dev)
        rc = lib.rollout_bwd(ctypes.byref(w.struct()), saved.data_ptr(),
                             z.data_ptr(), t2j.data_ptr(), dout.data_ptr(),
                             *(o.data_ptr() for o in out), scratch.data_ptr(),
                             M, STEPS, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rollout_bwd launch failed: CUDA error {rc}")
        return out

    libs, found = [], []
    for k, src in enumerate(sys.argv[1:]):
        src = Path(src).resolve()
        # each copy in a namespace of its own, so that no two libraries
        # share a C++ symbol (a function-local static of an inline
        # function is one object per process otherwise)
        text = f"#define humor humor_study{k}\n" + src.read_text()
        copies = {}
        for kind, body in (("", text), ("_traced", traced(text))):
            copies[kind] = out_dir / f"bwd{k}{kind}.cu"
            copies[kind].write_text(body)
        lib, ptxas = build(copies[""], out_dir / f"libbwd{k}.so")
        tlib, _ = build(copies["_traced"], out_dir / f"libbwd{k}_traced.so")
        body = ticked(text)
        plib = None
        if body is not None:
            copies["_ticked"] = out_dir / f"bwd{k}_ticked.cu"
            copies["_ticked"].write_text(body)
            plib, _ = build(copies["_ticked"],
                            out_dir / f"libbwd{k}_ticked.so")
            plib.humor_read_slots.argtypes = [ctypes.c_void_p]
        tlib.humor_read_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rollout_bwd_barriers_per_step.restype = ctypes.c_int
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
            names = PHASE_NAMES[lib.rollout_bwd_barriers_per_step()]
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
            # a set-up phase before the steps (loading the weights), and
            # whole steps only (a pipelined source ends with 5 more phases)
            lead = len(cyc) - len(names) * STEPS - (
                STAGES if len(names) == 6 else 0)
            setup = sum(cyc[:lead])
            cyc = cyc[lead:lead + len(names) * STEPS]
            per = [sum(cyc[i::len(names)]) / STEPS for i in range(len(names))]
            total = sum(per)
            ms = min(found[k]["ms"][f"M={M}"])
            found[k]["barriers"] = used - 1
            found[k].setdefault("setup_us", {})[f"M={M}"] = (
                1e3 * ms * setup / (marks[used - 1] - marks[0]))
            if plib is not None:
                torch.cuda.synchronize()
                if plib.humor_clear_slots() != 0:
                    raise RuntimeError("clearing the slots failed")
                run(plib, M)
                torch.cuda.synchronize()
                slots = (ctypes.c_longlong * 8192)()
                if plib.humor_read_slots(ctypes.addressof(slots)) != 0:
                    raise RuntimeError("reading the slots failed")
                grid = lib.rollout_bwd_grid_blocks()
                per_block = [[slots[8 * b + i] for i in range(len(SLOTS))]
                             for b in range(grid)]
                us_cycle = 1e3 * ms / (marks[used - 1] - marks[0])
                found[k].setdefault("slots_us_a_step", {})[f"M={M}"] = {
                    name: {"mean": us_cycle / STEPS * sum(
                        b[i] for b in per_block) / grid,
                           "max": us_cycle / STEPS * max(
                               b[i] for b in per_block)}
                    for i, name in enumerate(SLOTS)}
            found[k]["phases"][f"M={M}"] = {
                name: {"cycles": c, "share": c / total,
                       "us_a_step": 1e3 * ms * c / total / STEPS}
                for name, c in zip(names, per)}
    for f in found:
        print(json.dumps(f))
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
