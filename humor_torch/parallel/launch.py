"""Run a function on W local processes joined in one process group.

    results = launch.spawn(fn, world=2, args=(...), backend="gloo")

starts W processes (the "spawn" start method, so CUDA is safe in them),
joins them through a file store in a fresh temporary directory (no
network port), calls `fn(mesh, *args)` on each rank and returns the W
results in rank order. A rank that raises, exits or outlasts `timeout`
fails the call: the other ranks are terminated rather than left waiting
in a collective. `fn` must be importable by name (a module-level
function), and its result something `torch.save` writes; tensors come
back on the CPU.
"""

from __future__ import annotations

import io
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _packed(tree) -> bytes:
    buf = io.BytesIO()
    torch.save(_to_cpu(tree), buf)
    return buf.getvalue()


def _rank_main(fn, rank, world, store, backend, device, threads, args,
               results):
    import torch.distributed as dist

    from humor_torch.parallel.mesh import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            out = fn(make_mesh(device=dev), *args)
            results.put((rank, "ok", _packed(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          backend: str = "gloo", device="cpu", timeout: float = 300.0,
          threads: Optional[int] = 1) -> List[Any]:
    """fn(mesh, *args) on `world` ranks over `backend`, each on `device`
    (several ranks may share one card under gloo) with `threads` torch
    threads; -> the ranks' results. Raises RuntimeError with the failing
    rank's traceback, or on timeout."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="humor_dist_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, store, backend, str(device),
                                   threads, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"{world} ranks of {fn.__name__} "
                                       f"timed out after {timeout} s "
                                       f"({sorted(out)} finished)")
                try:
                    rank, status, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        # let a rank that reported just before exiting in
                        time.sleep(0.5)
                        if results.empty():
                            raise RuntimeError(
                                f"rank(s) {dead} of {fn.__name__} exited "
                                f"with code(s) "
                                f"{[procs[r].exitcode for r in dead]}")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                       f"failed:\n{value}")
                out[rank] = torch.load(io.BytesIO(value),
                                       weights_only=False)
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(out) == world else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
