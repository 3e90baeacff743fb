"""What the benchmark loads: in a fresh process, no module whose
top-level name, compared whole, is jax, jaxlib, flax or humor_tpu, after
a whole small run; the reference alone loads nothing of humor_torch."""

import json
import subprocess
import sys

from helpers import ROOT

RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/portbench/tests")
import portbench.run as R
from helpers import run_small, small_cell
for name in ("tto_rgb", "train_supervised"):
    assert run_small(small_cell(name, frames=8))["correct"]
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = r"""
import json, pkgutil, importlib, sys
sys.path.insert(0, {root!r})
import portbench.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("portbench.reference." + m.name)
for m in ("portbench.weights", "portbench.fit_traffic",
          "portbench.train_traffic", "portbench.counts", "portbench.trace"):
    importlib.import_module(m)
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def top(names):
    return {n.split(".")[0] for n in names}


def test_a_run_loads_no_jax_nor_the_jax_package():
    from portbench.run import FORBIDDEN

    mods = top(loaded(RUN))
    assert "humor_torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = top(loaded(REFERENCE))
    assert not mods & {"humor_torch", "jax", "jaxlib", "flax", "humor_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run as R

    monkeypatch.setitem(sys.modules, "humor_tpu_like", sys)
    assert "humor_tpu_like" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "humor_tpu.x", sys)
    assert R.forbidden_modules() == ["humor_tpu.x"]
