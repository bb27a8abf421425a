"""Runs of the harness on the CPU at small sizes: the result line, the modules
a run loads, what ``--seed`` reaches, the window's arithmetic, and the
reference's agreement with the port."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench.tests import small

ROOT = os.path.dirname(small.BENCH)


@pytest.mark.parametrize("name", ["mmgan.serve_n1", "gandes.serve_n1"])
def test_a_run_prints_the_contracts_keys_and_agrees_with_the_reference(name):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    run, result = small.run(name, 2147483647 + 5)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                      if name in m.get("workloads", [name])}
    assert "gen_latency_p95_s" in run.end_to_end  # a cell kept for later reads it too
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["correct"] is True and result["attempted"] >= 1
    assert run.facts["compared"] >= 1


def test_the_command_prints_no_result_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "mmgan.serve_n1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    code = (
        "import sys, json\n"
        "from portbench.tests import small\n"
        "from portbench import run as R\n"
        "small.run('mmgan.serve_n1', 11)\n"
        "print(json.dumps(R.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    code = (
        "import sys, json, pkgutil, importlib\n"
        "import portbench.reference as ref\n"
        "for m in pkgutil.iter_modules(ref.__path__):\n"
        "    importlib.import_module('portbench.reference.' + m.name)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not top & {"gandes_tpu_torch", "gandes_tpu", "jax", "jaxlib", "flax"}


def test_the_seed_reaches_the_z_stream_and_not_the_weights():
    a, result_a = small.run("mmgan.train_none", 5)
    b, result_b = small.run("mmgan.train_none", 2147483700)
    assert result_a["correct"] and result_b["correct"]
    for name in a.tape.d_params0:
        assert np.array_equal(a.tape.d_params0[name].numpy(), b.tape.d_params0[name].numpy())
    for name in a.tape.g_params0:
        assert np.array_equal(a.tape.g_params0[name].numpy(), b.tape.g_params0[name].numpy())
    assert not np.array_equal(a.tape.steps[0]["mats"].numpy(), b.tape.steps[0]["mats"].numpy())
    assert a.tape.steps[0]["count"] == b.tape.steps[0]["count"]


def test_the_training_rate_is_every_step_over_all_the_window():
    from types import SimpleNamespace

    from portbench import trace as tr
    from portbench.runners import train_mmgan as tm

    clock = iter([100.0 + 0.5 * i for i in range(200)])
    tm.time, real_time = SimpleNamespace(perf_counter=lambda: next(clock)), tm.time
    try:
        run = SimpleNamespace(traffic={"warm": 20, "batch_size": 2, "trace_seconds": 8.0}, seconds=10.0, trace=False,
                              device="cpu", tracer=tr.Tracer(False), t_start=0.0,
                              facts={}, dir="/nonexistent")
        data = (np.zeros((8, 128, 4), np.float32),) * 2 + (np.zeros((8, 50), np.float32),)
        tape = tm.Tape(run, data)
        for k in range(1, 60):
            try:
                tape.on_batch(k)
            except tm.WindowClosed:
                break
        steps, seconds = tape.window()
        assert tape.k0 == 21 and steps == tape.k_end - 21
        assert seconds >= 10.0 and abs(steps / seconds - 1.0 / 0.5) < 0.2
    finally:
        tm.time = real_time


def test_the_latency_tail_is_over_every_request_and_a_failure_misses_it():
    from portbench.runners.serve_http import p95_latency

    lat = list(np.linspace(0.1, 0.2, 100))
    assert p95_latency(lat, [True] * 100) == pytest.approx(np.percentile(lat, 95))
    assert p95_latency(lat, [True] * 90 + [False] * 10) == np.inf
    assert p95_latency(lat, [False] + [True] * 99) > p95_latency(lat, [True] * 100)


def test_the_gate_spread_leaves_out_each_sets_farthest_run():
    from portbench.spread import gate_share

    values = [1.0, 1.1, 0.9, 1.0, 1.05, 2.0] + [1.0, 1.02, 0.97, 1.0, 1.01, 0.99]
    share, sets = gate_share(values, 6)
    assert sets == pytest.approx([0.2, 0.03])
    assert share == pytest.approx((0.2 + 0.03) / 2 / 1.0)
