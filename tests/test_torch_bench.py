"""gandes_tpu_torch/bench.py on the CPU: the row format against the root
bench's ``_emit``, every row function at toy sizes on ``--device cpu``
(the kernels' plain versions, no CUDA graphs), the command's headline as its
last line, and the SIGALRM guard. No number here is a device number: the
bench's rows are measured on the card (``chip_smoke.py`` phase ``bench``).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench as root_bench
from gandes_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    timing-sensitive tests elsewhere need their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def toy(monkeypatch):
    """B = 2 (two sim threads at most) for every row built on the bench's
    MM-GAN setup."""
    monkeypatch.setattr(bench, "BATCH", 2)


def _metrics(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("args", [("m", 1.23456789, "steps/s", 2.345678),
                                  ("m", 12345.678901, "%", None),
                                  ("x", 0.000012345, "s", 1.0)])
def test_emit_lines_are_the_root_benchs(args, capsys):
    bench._emit(*args)
    ours = capsys.readouterr().out
    root_bench._emit(*args)
    assert ours == capsys.readouterr().out


@pytest.fixture(scope="module")
def warm():
    """The headline's windows at B = 2 and its warm step for the rows that
    reuse it (the module-scoped patch keeps B = 2 for them). The bench's
    deadline starts here, as it starts at the command's import: from the
    test session's import, a late worker would find it spent and measure
    one window."""
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "BATCH", 2)
    mp.setattr(bench, "_T_START", time.monotonic())
    out, seen = {}, []
    rates, flops = bench.bench_torch(iters=2, windows=2, on_window=seen.append,
                                     warm_out=out, device=CPU)
    out.update(rates=rates, flops=flops, seen=seen)
    yield out
    mp.undo()


def test_headline_windows_restore_the_state(warm):
    """Two windows of two steps, each from the same restored state; the
    FLOP count of one eager step covers G's and D's products."""
    assert len(warm["rates"]) == 2 and all(r > 0 for r in warm["rates"])
    assert warm["seen"][-1] is warm["rates"]
    assert warm["flops"] and warm["flops"] > 2 * 2 * 100 * 4096  # at least G1's last layer
    state = warm["fresh"]()
    assert state.step == warm["fresh"].step
    for t, s in zip(warm["fresh"].tensors, warm["fresh"].saved):
        assert torch.equal(t, s)


def test_full_pipeline_row(warm, capsys):
    bench.bench_full_step(50.0, warm, iters=1, device=CPU)
    (row,) = _metrics(capsys.readouterr().out)
    assert row["metric"] == "mmgan_full_pipeline_steps_per_sec" and row["value"] > 0


def test_scan_row(warm, capsys):
    bench.bench_scan_steps(warm, K=2, iters=1, device=CPU)
    (row,) = _metrics(capsys.readouterr().out)
    assert row["metric"] == "mmgan_train_steps_per_sec_scan2" and row["value"] > 0


def test_des_row(capsys):
    bench.bench_des(customers=300)
    (row,) = _metrics(capsys.readouterr().out)
    assert row["metric"] == "des_engine_customers_per_sec_logged" and row["vs_baseline"] > 0


def test_mel_row(capsys):
    bench.bench_mel(device=CPU)
    (row,) = _metrics(capsys.readouterr().out)
    assert row["metric"] == "mel_5s_216f_ms" and row["unit"] == "ms" and row["value"] > 0


def test_roll_row_inputs_are_the_root_benchs(capsys, monkeypatch):
    """The root row's numpy seed-0 events; the CPU takes K1's plain version."""
    seen = []
    real = bench.np.random.RandomState

    def spy(seed):
        seen.append(seed)
        return real(seed)

    monkeypatch.setattr(bench.np.random, "RandomState", spy)
    bench.bench_roll(B=2, E=64, T=50, device=CPU)
    (row,) = _metrics(capsys.readouterr().out)
    assert row["metric"] == "piano_roll_ms_per_roll" and seen == [0]


def test_host_stage_row(capsys):
    bench.bench_host_stage(B=2)
    (row,) = _metrics(capsys.readouterr().out)
    assert row["metric"] == "mmgan_host_stage_s_per_batch" and row["value"] > 0


def test_batch_scaling_rows(toy, capsys):
    """B = 2 against B = 4 in float32 and bf16; no MFU row off the card."""
    bench.bench_batch_scaling(big_batch=4, iters=1, device=CPU)
    rows = _metrics(capsys.readouterr().out)
    assert [r["metric"] for r in rows] == ["mmgan_train_step_samples_per_sec_B4",
                                           "mmgan_train_step_samples_per_sec_B4_bf16"]


def test_serving_row(capsys):
    bench.bench_serving(n_requests=1, device=CPU)
    (row,) = _metrics(capsys.readouterr().out)
    assert row == {"metric": "serve_warm_latency_p50_s", "value": row["value"], "unit": "s",
                   "vs_baseline": 1.0}


def _run(code_or_args, env_extra, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env_extra)
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_bench_on_the_cpu_ends_with_the_headline():
    """A short deadline: one headline window, the guarded rows skipped (and
    said so on stderr), the kernels' launch counts noted (none on the CPU),
    the headline the last line, exit 0."""
    proc = _run(["-m", "gandes_tpu_torch.cli", "bench", "--device", "cpu"],
                {"GANDES_BENCH_DEADLINE_S": "3"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    rows = [json.loads(ln) for ln in lines]
    assert [r["metric"] for r in rows] == ["mmgan_fused_train_steps_per_sec_sustained",
                                           "mmgan_fused_train_steps_per_sec"]
    assert rows[-1]["unit"] == "steps/s" and np.isfinite(rows[-1]["value"])
    assert "full-pipeline row skipped" in proc.stderr
    assert "scan-steps row skipped" in proc.stderr
    assert "# launches mel_power 0 roll_rasterize 0" in proc.stderr.splitlines()


GUARD = """
import signal, time
from gandes_tpu_torch import bench
bench._HEADLINE = {HEADLINE}
signal.signal(signal.SIGALRM, bench._flush_headline_and_exit)
print('{{"metric": "row", "value": 1.0, "unit": "s"}}', flush=True)
signal.alarm(1)
time.sleep(30)
"""


@pytest.mark.parametrize("headline", [
    {"metric": "mmgan_fused_train_steps_per_sec", "value": 12.5, "unit": "steps/s",
     "vs_baseline": 3.1}, None])
def test_alarm_guard_prints_the_best_known_headline(headline):
    proc = _run(["-c", GUARD.format(HEADLINE=repr(headline))], {}, timeout=60)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if headline is None:  # nothing measured yet: no headline, exit 1
        assert proc.returncode == 1 and len(lines) == 1
    else:
        assert proc.returncode == 0 and json.loads(lines[-1]) == headline
