#!/usr/bin/env python3
"""Time one grid-wide barrier of a persistent cooperative launch.

    python3 scripts/grid_barrier_study.py

Builds scripts/grid_barrier_study.cu with the port's nvcc flags into
build/grid_barrier_study/ and times an empty kernel that passes 1,000
barriers, against one that passes none, at 256 threads a block and 1, 2,
3 and 4 blocks an SM (as far as the dynamic shared memory lets them be
co-resident), for cooperative_groups' grid.sync() and a hand-written
generation barrier. CUDA events over 5 launches a count, 3 rounds with the
kinds in turns; prints one JSON line per (kind, grid) with the microseconds
a barrier (median and least of the rounds), then the card's name and power
limit, and the time of a launch that passes no barrier. Needs a GPU and
nvcc.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

THREADS = 256
BARRIERS = 1000
KINDS = ("grid.sync", "generation")


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def build():
    from humor_torch.ops import cuda_build

    out_dir = ROOT / "build" / "grid_barrier_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libgrid_barrier.so"
    src = ROOT / "scripts" / "grid_barrier_study.cu"
    p = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out), str(src)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.barrier_max_blocks.argtypes = [ctypes.c_int] * 3
    lib.barrier_run.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    return lib


def main():
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        sys.exit("grid_barrier_study: no CUDA device")
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    state = torch.zeros(2, dtype=torch.int32, device="cuda")
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(kind, blocks, smem, n):
        rc = lib.barrier_run(kind, blocks, THREADS, smem, n, state.data_ptr(),
                             sink.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"barrier launch refused: CUDA error {rc}")

    for per_sm in (1, 2, 3, 4):
        # dynamic shared memory that leaves room for `per_sm` blocks an SM
        smem = min(227 * 1024, (228 * 1024) // per_sm - 1024 - 1024)
        found = {}
        for _ in range(3):
            for kind in range(len(KINDS)):
                blocks = lib.barrier_max_blocks(kind, THREADS, smem)
                if blocks != per_sm * sms:
                    raise RuntimeError(f"{per_sm} blocks an SM: occupancy "
                                       f"gives {blocks} blocks")
                t_n = CS.cuda_ms(lambda: run(kind, blocks, smem, BARRIERS), 5)
                t_0 = CS.cuda_ms(lambda: run(kind, blocks, smem, 0), 5)
                found.setdefault(kind, []).append(
                    (1e3 * (t_n - t_0) / BARRIERS, 1e3 * t_0))
        torch.cuda.synchronize()
        if int(state[0]) != 0:
            raise RuntimeError("generation barrier left its counter set")
        for kind, runs in found.items():
            us = [u for u, _ in runs]
            print(json.dumps({"barrier": KINDS[kind], "blocks": per_sm * sms,
                              "blocks_per_sm": per_sm, "threads": THREADS,
                              "smem_bytes": smem,
                              "us_per_barrier": statistics.median(us),
                              "us_per_barrier_min": min(us),
                              "empty_launch_us": statistics.median(
                                  t for _, t in runs)}))
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
