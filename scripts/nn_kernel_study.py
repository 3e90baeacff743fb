#!/usr/bin/env python3
"""Build sources of the nearest-neighbour kernel and report, for each, what
ptxas says (registers, spills), the SASS of its loops, and its time on the
card at the PROX fit's shapes.

    python3 scripts/nn_kernel_study.py humor_torch/csrc/nn_distance.cu \
        _proof/nn_distance_old.cu

Each source has the C entry point `nn_distance` of
humor_torch/csrc/nn_distance.cu: an earlier version (`git show REV:path`)
or a copy with other sizes, kept in a directory .gitignore lists. Each is
built with the port's nvcc flags plus `-Xptxas -v` into build/nn_study/.
The SASS (`cuobjdump -sass`) is cut into loops at its backward branches;
for each loop that holds FFMAs the script prints its instruction count,
its opcodes and the count per (query, point) pair, one pair for each
FMNMX (a min-only loop) or, where the loop has none, each FSETP (a
running argmin's compare). Times are CUDA events over 10 launches at
(960, 4096, 6890) and (240, 4096, 6890) on chip_smoke.py's inputs, the
sources in turns (a b ... b a); the SM clock and power are read by
nvidia-smi while 300 launches at the first shape are queued. Needs a GPU
and nvcc; prints one JSON line per source, then the card's name and power
limit.
"""

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ((960, 4096, 6890), (240, 4096, 6890))
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def build(k, src, out_dir):
    """The library and ptxas's register and spill lines."""
    from humor_torch.ops import cuda_build

    out = out_dir / f"libnn{k}.so"
    p = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    return out, [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]


def sass_loops(lib):
    """The loops (backward branches) of the library's SASS that hold
    FFMAs: address range, instruction count, count a pair, opcodes."""
    from humor_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    insns = [(int(m.group(1), 16), m.group(3), m.group(4))
             for m in _INSN.finditer(text)]
    loops = []
    for addr, op, args in insns:
        t = re.search(r"0x([0-9a-f]+)", args)
        if not op.startswith("BRA") or t is None or int(t.group(1), 16) > addr:
            continue
        start = int(t.group(1), 16)
        ops = Counter(o.split(".")[0] for a, o, _ in insns
                      if start <= a <= addr)
        pairs = ops["FMNMX"] or ops["FSETP"]
        if ops["FFMA"] and pairs:
            n = sum(ops.values())
            loops.append({"range": [hex(start), hex(addr)],
                          "instructions": n, "per_pair": n / pairs,
                          "opcodes": dict(ops.most_common())})
    return sorted(loops, key=lambda lp: lp["instructions"])


def main():
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        sys.exit("nn_kernel_study: no CUDA device")
    out_dir = ROOT / "build" / "nn_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    found, fns = [], []
    for k, src in enumerate(sys.argv[1:]):
        lib, ptxas = build(k, Path(src).resolve(), out_dir)
        fn = ctypes.CDLL(str(lib)).nn_distance
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
        fn.restype = ctypes.c_int
        fns.append(fn)
        found.append({"source": src, "ptxas": ptxas, "loops": sass_loops(lib),
                      "ms": {}})

    def run(fn, x, y):
        d = torch.empty(x.shape[:2], device=x.device)
        i = torch.empty(x.shape[:2], dtype=torch.int32, device=x.device)
        rc = fn(x.data_ptr(), y.data_ptr(), d.data_ptr(), i.data_ptr(),
                x.shape[0], x.shape[1], y.shape[1],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nn_distance launch failed: CUDA error {rc}")

    for shape in SHAPES:
        x, y, _ = CS.nn_inputs(*shape, seed=3)
        order = list(range(len(fns)))
        for k in order + order[::-1]:
            found[k]["ms"].setdefault(str(shape), []).append(
                CS.cuda_ms(lambda: run(fns[k], x, y), 10))
        if shape == SHAPES[0]:
            for k, fn in enumerate(fns):
                for _ in range(300):
                    run(fn, x, y)
                found[k]["sm_clock_power_under_load"] = [
                    smi("clocks.sm,power.draw") for _ in range(5)]
                torch.cuda.synchronize()
        del x, y
    for f in found:
        print(json.dumps(f))
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
