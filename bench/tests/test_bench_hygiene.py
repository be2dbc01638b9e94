"""What the benchmark may import and open, and the shape of
``BENCHMARK.json`` against the files that carry its pieces."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _sources():
    for base, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


@pytest.mark.parametrize("path", [p for p in _sources() if os.sep +
                                  "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "repro_torch" not in tops and "bench" not in tops, tops


def test_no_fixed_paths_or_old_harness():
    """No file of the benchmark names the old harness's folder, shared
    memory or a fixed temporary path."""
    words = ("bench" + "marks/", "/dev/" + "shm", "/" + "tmp")
    for base, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith((".py", ".json")):
                continue
            text = open(os.path.join(base, f)).read()
            for w in words:
                assert w not in text, (f, w)


def test_benchmark_json_names_its_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    for c in b["configs"]:
        assert NAME.match(c["name"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = json.load(open(os.path.join(BENCH, "cells",
                                           f"{w['name']}.json")))
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")), m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_per_layer_metric_rides_with_what_it_moves():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
