"""``BENCHMARK.json`` against the benchmark's contract, and the imports
of every module under ``wbbench/``."""

import ast
import glob
import json
import os
import re

import pytest

from wbbench.harness import FORBIDDEN, ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert all(_one_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_one_line_fields():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("wbbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_bounds_and_metrics_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "wbbench", "metrics",
                                           m["name"] + ".py"))
    for cell in cells:
        assert any(cell in m.get("workloads", [cell])
                   for m in BENCH["per_layer"])


def test_every_cell_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cfg = json.load(open(os.path.join(ROOT,
                                          configs[w["config"]]["file"])))
        assert os.path.exists(os.path.join(ROOT, cfg["model"]))
        assert os.path.exists(os.path.join(ROOT, "wbbench", "workloads",
                                           w["traffic"] + ".json"))
        used.add(w["config"])
    assert used == set(configs)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES_PY = sorted(glob.glob(os.path.join(ROOT, "wbbench", "**", "*.py"),
                              recursive=True))


@pytest.mark.parametrize("path", SOURCES_PY,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES_PY])
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "wbbench", "reference",
                                       "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "functools", "math",
                        "random", "struct", "typing", "zlib", "numpy",
                        "torch"}, path
