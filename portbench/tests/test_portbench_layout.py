"""The benchmark's files are found by name and keep to the contract's shapes.

Run from the checkout's root: ``python3 -m pytest portbench/tests -q``.
"""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in _bench()[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_every_cell_has_its_files_and_is_one_chip():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "cells", f"{w['name']}.json")) as f:
            cell = json.load(f)
        assert cell["config"] == w["config"] and w["config"] in configs
        assert cell["chips"] == w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("name", sorted(f[:-len(".json")] for f in
                                        os.listdir(os.path.join(BENCH, "cells"))))
def test_every_cell_file_names_its_runner_config_and_limits(name):
    """Also the cells kept for a later benchmark, which BENCHMARK.json does
    not name yet."""
    from portbench.checks import LIMIT_KEYS

    assert NAME.match(name)
    with open(os.path.join(BENCH, "cells", f"{name}.json")) as f:
        cell = json.load(f)
    assert os.path.isfile(os.path.join(BENCH, "runners", f"{cell['runner']}.py"))
    with open(os.path.join(BENCH, "configs", f"{cell['config']}.json")) as f:
        model = json.load(f)["model"]
    kind = f"{model}_train" if cell["runner"].startswith("train") else f"{model}_serve"
    assert set(cell["traffic"]["limits"]) == set(LIMIT_KEYS[kind])


def test_every_config_file_is_its_own_and_under_paths():
    files = [c["file"] for c in _bench()["configs"]]
    assert len(files) == len(set(files))
    for c in _bench()["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
        assert c["reduced"] == []


def test_every_metric_has_a_reader_unit_and_cells():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in cells:  # each cell: setup_s, another end-to-end metric, a per-layer metric
        assert any(n != "setup_s" and cell in m.get("workloads", [cell])
                   for n, m in e2e.items())
        assert any(cell in m["workloads"] for m in b["per_layer"])


def test_metric_readers_return_nothing_without_readings():
    from portbench import run as R

    run = R.Run("x", {"traffic": {}}, {}, 0, 1, True, "cpu")
    for f in os.listdir(os.path.join(BENCH, "metrics")):  # those kept for later too
        assert R.load_metric(f[:-len(".py")]).read(run) is None


def test_benchmark_json_is_small_and_layers_are_named_alike():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    layers = {m["layer"] for m in _bench()["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
