"""Import hygiene of the port: importing every humor_torch module (and
chip_smoke.py) must pull in neither jax, optax, cv2 nor anything of
humor_tpu (the card's machine has no cv2). Runs in a fresh interpreter,
since this test process imports them."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.path.insert(0, ROOT)
import humor_torch
names = ["humor_torch"] + [m.name for m in pkgutil.walk_packages(
    humor_torch.__path__, "humor_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax",
                                    "humor_tpu", "cv2"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
for n in ("fitting.cli", "fitting.lbfgs", "eval.metrics", "eval.fitting_cli",
          "data.prox", "data.imapper", "utils.config", "utils.import_torch",
          "utils.video", "viz.utils", "viz.raster", "viz.fitting",
          "train.cli", "train.trainer", "train.step", "losses.elbo",
          "data.amass", "data.device_store", "utils.checkpoint",
          "data.fit_dataset", "data.process_amass", "data.cleanup_amass",
          "eval.humor_eval", "eval.cli", "train.gmm_cli",
          "utils.profiling", "testing"):
    assert "humor_torch." + n in names, n
"""


def test_humor_torch_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c",
                          f"ROOT = {ROOT!r}\n" + SCRIPT],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_lazy_imports_of_jax_or_cv2():
    """The same, for imports inside functions, which importing a module
    does not run: no import statement in humor_torch or chip_smoke.py
    names jax, optax, flax, cv2 or humor_tpu."""
    import ast
    import glob

    files = glob.glob(os.path.join(ROOT, "humor_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    banned = ("jax", "jaxlib", "optax", "flax", "cv2", "humor_tpu")
    bad = []
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            bad += [(f, m) for m in mods if m.split(".")[0] in banned]
    assert len(files) > 30 and not bad, bad
