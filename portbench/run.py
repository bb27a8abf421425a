"""The benchmark of ``gandes_tpu_torch`` on one NVIDIA H100.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``portbench/cells/<cell>.json``: its configuration
(``portbench/configs/<config>.json``), its traffic parameters, its runner
(``portbench/runners/<runner>.py``) and its chips. ``BENCHMARK.json`` at the
checkout's root names the metrics: a run with ``--trace 0`` reports the
cell's end-to-end metrics, a run with ``--trace 1`` its per-layer metrics,
each read by ``portbench/metrics/<metric>.py``. Nothing here lists a cell,
a configuration or a metric: each is found by its name.

A run makes its inputs from ``--seed`` (weights from the configuration's
``weight_seed``), sets up and warms up the program, measures for
``--seconds``, checks what the measured window produced against the plain
reference in ``portbench/reference/``, and prints one JSON line last on
standard output. The numbers the check compared, each beside its limit,
are the last lines on standard error and the last key of that line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gandes_tpu")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def fix_caches():
    """Every build and kernel cache at a fixed path inside the checkout, set
    before torch is imported (the program builds its own kernels and the
    DES library into ``gandes_tpu_torch/_build``, also inside it)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"


class Run:
    """One run of one cell: what the runner is given and what it fills in."""

    def __init__(self, name, cell, config, seed, seconds, trace, device, run_dir=None):
        self.name, self.cell, self.config = name, cell, config
        self.traffic = cell["traffic"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.dir = run_dir or os.path.join(BENCH, "_run", name)  # the program's own outputs
        self.t_start = T_START
        self.setup_s = None
        self.attempted = self.failed = 0
        self.end_to_end: dict[str, float] = {}
        self.checks: list[tuple[str, float, float]] = []  # (name, value, limit): ok iff value <= limit
        self.facts: dict = {}
        self.readings: dict = {}  # what the per-layer readers read
        self.tracer = None
        self.memory_peak_bytes = 0
        self.control = False  # also read the control and the faults (the card's test)
        self.control_readings: dict = {}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them (a card set
    below its 700 W runs slower under load), or None where it cannot."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_metric(name):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry, cell_name) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def run_cell(name, seed, seconds, trace, require_cuda=True, cell=None, control=False,
             run_dir=None):
    """Run cell ``name`` and return ``(run, result)``: the result dict is the
    line to print, or None where the run must print none. Tests pass
    ``require_cuda=False``, a small ``cell`` and a ``run_dir`` of their own."""
    cell = cell or _load_json(os.path.join(BENCH, "cells", f"{name}.json"))
    config = _load_json(os.path.join(BENCH, "configs", f"{cell['config']}.json"))
    bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: cell {name} needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None, None
        device = "cuda"
    else:
        device = "cpu"
    torch.set_num_threads(1)
    run = Run(name, cell, config, seed, seconds, trace, device, run_dir)
    run.control = control
    shutil.rmtree(run.dir, ignore_errors=True)
    os.makedirs(run.dir)
    runner = importlib.import_module(f"portbench.runners.{cell['runner']}")
    runner.run(run)

    metrics = {}
    if trace:
        for entry in bench["per_layer"]:
            if _applies(entry, name):
                value = load_metric(entry["name"]).read(run)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in bench["end_to_end"]:
            if _applies(entry, name):
                value = run.setup_s if entry["name"] == "setup_s" else run.end_to_end.get(
                    entry["name"])
                if value is not None and math.isfinite(value):  # an infinite tail: no value
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    tr = run.tracer.trace if run.tracer is not None else None
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for n, v, lim in run.checks}  # JSON has no infinity
    return run, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_caches()
    run, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    run.facts["card"] = power_limit()
    print("# host " + json.dumps(run.facts), flush=True)
    for n, v, lim in run.checks:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
