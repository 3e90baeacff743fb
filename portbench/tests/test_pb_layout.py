"""Every name in BENCHMARK.json resolves to its file, and a
configuration, a cell and a per-layer metric added as new files are
found with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest

from helpers import ROOT, bench
from portbench import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                                 b["workloads"]]))
             for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= moves[m["moves"]], m["name"]
    for w in b["workloads"]:
        cell = R.Cell(b, w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_every_name_resolves(name):
    cell = R.Cell(bench(), name)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.module(), "run")
    for m in cell.per_layer:
        assert hasattr(cell.reader(m["name"]), "read")
        # a reader that finds nothing to read returns nothing
        assert cell.reader(m["name"]).read({}) is None
    checked = {"fit": {"stage1_gap", "stage2_gap"},
               "train": {"loss_gap", "grad_gap", "change_gap"}}
    assert set(cell.limits) >= checked[cell.traffic["kind"]]


def test_added_files_are_found_without_an_edit(tmp_path):
    """A later PR's configuration, traffic, cell and metric: new files
    and new entries only."""
    src = os.path.join(ROOT, "portbench")
    dst = tmp_path / "portbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", "reference"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    b = bench()
    cfg = json.loads((dst / "configs" / "humor_tto.json").read_text())
    (dst / "configs" / "humor_tto_b16.json").write_text(json.dumps(
        dict(cfg, name="humor_tto_b16", batch_windows=16)))
    tr = json.loads((dst / "traffic" / "rgb.json").read_text())
    (dst / "traffic" / "joints3d.json").write_text(json.dumps(
        dict(tr, observation=dict(tr["observation"], kind="joints3d"))))
    (dst / "limits" / "tto_joints3d_b16.json").write_text(
        (dst / "limits" / "tto_rgb.json").read_text())
    (dst / "metrics" / "stage2_s.py").write_text(
        "def read(record):\n    return record.get('stage2_s')\n")
    b["configs"].append(dict(b["configs"][0], name="humor_tto_b16",
                             file="portbench/configs/humor_tto_b16.json"))
    b["workloads"].append({"name": "tto_joints3d_b16",
                           "config": "humor_tto_b16", "traffic": "joints3d",
                           "chips": 1, "why": "a later cell"})
    b["end_to_end"][0]["workloads"].append("tto_joints3d_b16")
    b["per_layer"].append({"name": "stage2_s", "unit": "s",
                           "better": "lower", "source": "program_span",
                           "layer": "runner", "moves": "fit_device_s_per_window",
                           "workloads": ["tto_joints3d_b16"]})
    cell = R.Cell(b, "tto_joints3d_b16", root=str(tmp_path))
    assert cell.config["batch_windows"] == 16
    assert cell.traffic["observation"]["kind"] == "joints3d"
    assert [m["name"] for m in cell.per_layer] == ["stage2_s"]
    assert cell.reader("stage2_s").read({"stage2_s": 1.5}) == 1.5
    assert cell.module().__name__.endswith("fit")
    for p, data in before.items():
        assert p.read_bytes() == data, p
