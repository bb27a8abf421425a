"""The benchmark's GAN-DES cell, ``gandes.serve_n1``, on the CPU at the
small size of ``portbench/tests/small.py``: the port's serving path against
the plain reference (``portbench/reference/``), untraced and traced, the
readers of its per-layer metrics, ``BENCHMARK.json``'s entries for it, and
a reader file for every metric that ``BENCHMARK.json`` names.

The untraced run goes in a process of its own, so that the modules it loads
are its own (this file's neighbours import JAX).
"""

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import run as R
from portbench import spans
from portbench import trace as tr
from portbench.tests import small

ROOT = os.path.dirname(small.BENCH)
CELL = "gandes.serve_n1"
NEW_METRICS = ("synth_ms.serve", "wav_ms.serve", "mel_ms.serve", "k2_roofline_pct",
               "sim_budget_cut_pct.serve")
SERVING_METRICS = ("des_ms.serve", "midi_ms.serve", "http_overhead_ms.serve", "gen_mfu_pct",
                   "device_idle_pct.serve")
DEVICE_TRACE_ONLY = {"k2_roofline_pct"}  # reads the card's operations inside the mel


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_cell_runs_correct_and_loads_no_jax():
    code = (
        "import json\n"
        "from portbench.tests import small\n"
        "from portbench import run as R\n"
        f"run, result = small.run({CELL!r}, 2147483647 + 22)\n"
        "print(json.dumps({'result': result, 'forbidden': R.forbidden_modules(),\n"
        "                  'compared': run.facts['compared'],\n"
        "                  'p95': run.end_to_end['gen_latency_p95_s']}))\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    result = out["result"]
    assert out["forbidden"] == []
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"gen_latency_p95_s", "setup_s"}
    assert result["metrics"]["gen_latency_p95_s"]["value"] == out["p95"] < math.inf
    assert set(result["checks"]) == {"g_logit_gap", "g_max_gap", "wav_mismatch", "mel_rel_l2",
                                     "uncompared"}
    assert out["compared"] >= 1


def test_a_traced_run_reads_every_per_layer_metric_of_the_cell(monkeypatch, tmp_path):
    """The CPU has no card to synchronise or warm: the profiler traces the
    host alone, so the readers of the program's spans and counters read
    numbers, and K2's roofline, which needs the card's operations, None; so
    do the serving readers that the MM-GAN cell reports."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tr.Tracer, "warm", lambda self: None)
    R.fix_caches()
    run, result = R.run_cell(CELL, 2147483647 + 23, 1.0, True, require_cuda=False,
                             cell=small.cell(CELL), run_dir=str(tmp_path / "run"))
    assert result["correct"] is True
    for name in NEW_METRICS + SERVING_METRICS:
        value = R.load_metric(name).read(run)
        if name in DEVICE_TRACE_ONLY:
            assert value is None and name not in result["metrics"]
        else:
            assert isinstance(value, float) and math.isfinite(value) and value >= 0.0, name
            assert result["metrics"][name]["value"] == value
    assert R.load_metric("sim_budget_cut_pct.serve").read(run) <= 100.0


@pytest.mark.parametrize("name", sorted({m["name"] for m in _bench()["per_layer"]}
                                         | set(NEW_METRICS)))
def test_every_per_layer_metric_has_a_reader_that_reads_nothing_untraced(name):
    assert os.path.isfile(os.path.join(small.BENCH, "metrics", f"{name}.py"))
    run = R.Run("x", {"traffic": {}}, {}, 0, 1, True, "cpu")
    assert R.load_metric(name).read(run) is None


def test_the_benchmark_lists_the_cell_with_its_metrics():
    """The configuration and the one-chip cell, the end-to-end metrics it
    reports, the serving metrics it shares with ``mmgan.serve_n1`` and the
    five of its own, each of them only in this cell."""
    b = _bench()
    (config,) = [c for c in b["configs"] if c["name"] == "gandes"]
    assert config["file"] == "portbench/configs/gandes.json" and config["reduced"] == []
    (cell,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("gandes", "serve_n1", 1)
    metrics = {m["name"]: m for m in b["per_layer"] + b["end_to_end"]}
    assert metrics["gen_latency_p95_s"]["workloads"] == ["mmgan.serve_n1", CELL]
    assert "workloads" not in metrics["setup_s"]
    for name in SERVING_METRICS:
        assert metrics[name]["workloads"] == ["mmgan.serve_n1", CELL], name
    for name in NEW_METRICS:
        assert metrics[name]["workloads"] == [CELL], name
        assert metrics[name]["moves"] == "gen_latency_p95_s"


def test_every_cell_and_metric_of_the_benchmark_is_found_by_name():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"] + [{"name": CELL, "config": "gandes"}]:
        with open(os.path.join(small.BENCH, "cells", f"{w['name']}.json")) as f:
            assert json.load(f)["config"] == w["config"]
        assert os.path.isfile(os.path.join(small.BENCH, "configs", f"{w['config']}.json"))
    for m in b["per_layer"] + b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


# the readers on a synthetic traced stretch: [T0, T0 + 8 s] on perf_counter
T0 = 1000.0


def _span(name, start_s, ms, trace_id=None, **attrs):
    start = int((T0 + start_s) * 1e9)
    return SimpleNamespace(name=name, start_ns=start, end_ns=start + int(ms * 1e6),
                           trace_id=trace_id, attrs=attrs)


def _traced_run():
    run = R.Run("x", {"traffic": {}}, {}, 0, 1, True, "cpu")
    run.tracer = SimpleNamespace(t0=T0, trace=SimpleNamespace(window_s=8.0))
    return run


SPANS = [
    # a request that began before the stretch: its second wav span is left out
    _span("wav", -0.05, 9.0, trace_id=1), _span("request", -0.3, 400.0, trace_id=1),
    _span("wav", 0.05, 50.0, trace_id=1),
    _span("wav", 1.0, 10.0, trace_id=2), _span("wav", 1.1, 20.0, trace_id=2),
    _span("request", 0.9, 300.0, trace_id=2),
    _span("wav", 2.0, 5.0, trace_id=3), _span("wav", 2.1, 15.0, trace_id=3),
    _span("request", 1.9, 300.0, trace_id=3),
    _span("wav", 3.0, 8.0, trace_id=4), _span("wav", 3.1, 12.0, trace_id=4),
    _span("request", 2.9, 300.0, trace_id=4),
    _span("des", 1.2, 60.0, trace_id=2, budget_cut=0, timed_out=0),
    _span("des", 2.2, 500.0, trace_id=3, budget_cut=1, timed_out=0),
    _span("des", 3.2, 70.0, trace_id=4, budget_cut=0, timed_out=0),
    _span("des", 7.99, 70.0, trace_id=5, budget_cut=1, timed_out=0),  # ends after it
    _span("synth", 1.3, 30.0), _span("synth", 2.3, 10.0), _span("synth", 3.3, 20.0),
    _span("mel", 1.4, 3.0), _span("mel", 2.4, 1.0), _span("mel", 3.4, 2.0),
]


@pytest.mark.parametrize("name,expected", [
    ("wav_ms.serve", 20.0),  # requests 2, 3, 4 sum 30, 20, 20 ms
    ("sim_budget_cut_pct.serve", 100.0 / 3),
    ("synth_ms.serve", 20.0),
    ("mel_ms.serve", 2.0),
])
def test_a_reader_on_a_synthetic_stretch(name, expected, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)
    assert R.load_metric(name).read(_traced_run()) == pytest.approx(expected, rel=1e-6)


def test_the_budget_cut_share_reads_none_from_a_program_without_the_attribute(monkeypatch):
    old = [_span("des", 1.0, 60.0, timed_out=0, events=10), _span("des", 2.0, 60.0)]
    monkeypatch.setattr(spans, "program_spans", lambda: old)
    assert R.load_metric("sim_budget_cut_pct.serve").read(_traced_run()) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert R.load_metric("wav_ms.serve").read(_traced_run()) is None
