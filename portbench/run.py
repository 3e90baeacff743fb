#!/usr/bin/env python3
"""Run one cell of the humor_torch benchmark once, on the GPU this
process sees:

    python3 portbench/run.py --workload tto_rgb --seed 7 --seconds 51 \
        --trace 0

from the root of a checkout. Everything a cell is made of is found by
the names in BENCHMARK.json: its configuration's file (the entry's
"file"), its traffic mix `portbench/traffic/<traffic>.json` (whose
"kind" names the module that runs it, `portbench/<kind>_cell.py`), the limits of its
output check `portbench/limits/<workload>.json`, and one reader
`portbench/metrics/<metric>.py` for each per-layer metric it reports.

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics (with the device's busy seconds and a breakdown). Every run
checks the timed path's outputs against the plain reference under
portbench/reference and prints each compared number beside its limit:
as the last lines on standard error, and under "compared", the last key
of the result line, the last line of standard output.

Exits non-zero and prints no result without a CUDA device (or with fewer
than the cell asks for), or when JAX or the JAX package is loaded once
the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "humor_tpu")


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (humor_torch begins with humor_t)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Cell:
    """One workload of BENCHMARK.json and the files its names lead to."""

    def __init__(self, bench: dict, workload: str, root: str = ROOT):
        here = os.path.join(root, "portbench")
        self.here = here
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"portbench: no workload {workload!r} in "
                             "BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.load(open(os.path.join(root, cfg["file"])))
        self.traffic_name = self.entry["traffic"]
        self.traffic = json.load(open(os.path.join(
            here, "traffic", self.traffic_name + ".json")))
        self.limits = json.load(open(os.path.join(
            here, "limits", workload + ".json")))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def module(self):
        """The module that runs a cell of this traffic's kind."""
        return load_file(os.path.join(
            self.here, self.traffic["kind"] + "_cell.py"),
            "portbench_cell_" + self.traffic["kind"])

    def reader(self, metric: str):
        return load_file(os.path.join(self.here, "metrics", metric + ".py"),
                         "portbench_metric_" + metric.replace(".", "_"))


def set_env():
    """Build and kernel caches inside the checkout, at fixed paths; keep
    libraries from loading JAX on their own."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_env()
    sys.path.insert(0, ROOT)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = Cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result = run_cell(cell, args, T_START, device="cuda")
    if result is None:
        return 4
    print(json.dumps(result))
    return 0


def run_cell(cell: Cell, args, t_start: float, device="cuda"):
    """One run of `cell`: the result line's object, its compared numbers
    printed on standard error last; None when a forbidden module is
    loaded once the window has closed."""
    out = cell.module().run(cell, args, t_start, device=device)
    found = forbidden_modules()
    if found:
        print("portbench: loaded after the window: " + ", ".join(found),
              file=sys.stderr)
        return None
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    compared = out["compared"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["compared"] = compared
    print("portbench: window walls (s) " + json.dumps(out["walls"]),
          file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return result


if __name__ == "__main__":
    sys.exit(main())
