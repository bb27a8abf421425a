"""The port's spans and counters (``gandes_tpu_torch/core/profiling.py``) on
the CPU: spans only under a ``torch.profiler``, their nesting, threads and
clock against the profiler's own ranges; the host stage's counters for sims
cut by their watchdog or by their wall budget; ``/healthz``'s counters and
an MM-GAN and a GAN-DES request's spans; a
two-step ``train_mmgan``'s counters and spans; ``StepTimer`` samples after
the loop is stopped from its data, and its CUDA-event phases resolved
without a synchronisation (with stand-in events, since the CPU has none).
"""

import json
import sys
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gandes_tpu_torch.bridge import mmgan_decode
from gandes_tpu_torch.core import profiling
from gandes_tpu_torch.core.profiling import COUNTER_NAMES, COUNTERS, StepTimer, span, spans
from gandes_tpu_torch.des import native
from gandes_tpu_torch.des.engine import Sim
from gandes_tpu_torch.music import native_decode
from gandes_tpu_torch.serve import GenerationService, make_http_server
from gandes_tpu_torch.train import mmgan_loop as ml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _native_libs_loaded():
    """The DES core and the record decoder load before any sim runs under a
    wall budget."""
    assert native.get_lib() is not None
    assert native_decode.native_decode_available()


def _profiler():
    """A CPU profiler recording every thread's ranges."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=config)


def _new_spans(t0_ns, name=None):
    return [s for s in spans() if s.start_ns >= t0_ns and (name is None or s.name == name)]


def test_no_span_is_recorded_without_a_profiler():
    t0 = time.perf_counter_ns()
    with span("idle", x=1) as s:
        s.set(y=2)
    assert s is span("other")  # the one shared no-op
    assert _new_spans(t0) == []


def test_spans_nest_with_parent_and_trace_ids():
    t0 = time.perf_counter_ns()
    with _profiler():
        with span("root", trace_id=7, a=1) as root:
            with span("child") as child:
                with span("leaf", b=2) as leaf:
                    leaf.set(c=3)
            with span("sibling", trace_id=8) as sibling:
                pass
        with span("alone") as alone:
            pass
    assert [s.name for s in _new_spans(t0)] == ["leaf", "child", "sibling", "root", "alone"]
    assert root.parent_id is None and root.trace_id == 7 and root.attrs == {"a": 1}
    assert child.parent_id == root.span_id and child.trace_id == 7
    assert leaf.parent_id == child.span_id and leaf.trace_id == 7
    assert leaf.attrs == {"b": 2, "c": 3}
    assert sibling.parent_id == root.span_id and sibling.trace_id == 8
    assert alone.parent_id is None and alone.trace_id is None
    assert root.start_ns <= child.start_ns <= leaf.start_ns <= leaf.end_ns <= child.end_ns
    assert child.end_ns <= sibling.start_ns <= sibling.end_ns <= root.end_ns


def test_a_span_that_raises_is_recorded_with_its_error():
    t0 = time.perf_counter_ns()
    with _profiler(), pytest.raises(KeyError):
        with span("fails"):
            raise KeyError("x")
    (s,) = _new_spans(t0, "fails")
    assert s.attrs == {"error": "KeyError"}


def test_a_span_in_a_second_thread_is_recorded():
    t0 = time.perf_counter_ns()
    seen = {}

    def work():
        with span("worker", trace_id=3) as s:
            seen["thread"] = threading.get_ident()
            time.sleep(0.001)
        seen["span"] = s

    with _profiler() as prof:
        with span("main"):
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    (s,) = _new_spans(t0, "worker")
    assert s is seen["span"] and s.thread == seen["thread"] != threading.get_ident()
    assert s.parent_id is None and s.trace_id == 3  # a thread starts its own stack
    assert [e.name for e in prof.events()].count("gandes.worker") == 1


def test_each_span_is_a_profiler_range_on_the_same_clock():
    """Each span's start lies within 1 ms of its ``gandes.<name>`` range's,
    once each clock's offset is taken out (the profiler counts from its own
    start)."""
    t0 = time.perf_counter_ns()
    with _profiler() as prof:
        for i in range(6):
            with span(f"clock{i}"):
                time.sleep(0.002 * (i + 1))
            time.sleep(0.003)
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("gandes.clock")}
    ours = {s.name: s for s in _new_spans(t0) if s.name.startswith("clock")}
    assert sorted(ranges) == sorted(profiling.RANGE_PREFIX + n for n in ours)
    offsets_us = [s.start_ns * 1e-3 - ranges[profiling.RANGE_PREFIX + n].start
                  for n, s in ours.items()]
    assert max(offsets_us) - min(offsets_us) < 1000.0
    for n, s in ours.items():  # the lengths agree too
        r = ranges[profiling.RANGE_PREFIX + n]
        assert abs((s.end_ns - s.start_ns) * 1e-3 - (r.end - r.start)) < 1000.0


def _inputs(seed, B):
    rng = np.random.RandomState(seed)
    g1 = rng.rand(B, 1, 64, 64).astype(np.float32)
    g2 = rng.rand(B, 20).astype(np.float32) * 0.5 + 0.2
    return g1, g2


@pytest.mark.parametrize("parallel,span_name", [(2, "des.batch"), (None, "des")])
def test_a_sim_past_its_watchdog_is_counted(tmp_path, parallel, span_name):
    """A watchdog of 0 cuts every sim: the native batch and the sequential
    path both count each one in ``sims_timed_out`` and on its span."""
    B = 2
    g1, g2 = _inputs(5, B)
    np.random.seed(3)
    before = COUNTERS.snapshot()
    t0 = time.perf_counter_ns()
    with _profiler():
        rolls, failed = mmgan_decode.matrix_to_midi(
            g1, g2, adj_size=(64, 64), start=100, end=150, watchdog=0.0, parallel=parallel,
            log_path=str(tmp_path) + "/", out_dir=str(tmp_path / "midi"))
    grew = COUNTERS.since(before)
    assert failed == B and not any(r.any() for r in rolls)
    assert grew["sims_run"] == grew["sims_timed_out"] == B
    assert grew["rolls_decoded"] == grew["decodes_skipped"] == grew["sims_failed"] == 0
    found = _new_spans(t0, span_name)
    assert sum(s.attrs["timed_out"] for s in found) == B
    if parallel:
        (s,) = found
        assert s.attrs["sims"] == B and s.attrs["events"] == grew["des_events"]
        assert s.attrs["capped"] == grew["sims_capped"] == 0  # cut by the clock first
        (d,) = _new_spans(t0, "des.decode")
        assert d.attrs == {"decoded": 0, "skipped": 0}
    else:
        assert len(found) == B
        assert sum(s.attrs["events"] for s in found) == grew["des_events"]


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("budget,customers,cut", [(0.0, 100_000, 1), (1000.0, 50, 0)])
def test_a_sim_cut_by_its_wall_budget_is_counted(engine, budget, customers, cut):
    """A wall budget of 0 stops the sim long before its customers:
    ``sims_budget_cut`` and the ``des`` span's ``budget_cut`` count it once on
    either engine; a sim that reaches its customer count counts zero. Neither
    is past a watchdog."""
    adj = np.array([[1.0, 1.0], [0.0, -1.0]])  # source 0 -> server 1 -> sink
    sim = Sim(adj, [["exponential", 1.0], ["exponential", 0.8]], [0, 20], seeds=[7],
              max_sim_time=budget, engine=engine)
    np.random.seed(42)
    before = COUNTERS.snapshot()
    t0 = time.perf_counter_ns()
    with _profiler():
        sim.run(number_of_customers=customers)
    grew = COUNTERS.since(before)
    assert sim.budget_cut is bool(cut)
    assert (sim.total_customers < customers) is bool(cut)
    assert grew["sims_run"] == 1 and grew["sims_budget_cut"] == cut
    assert grew["sims_timed_out"] == grew["sims_failed"] == 0
    (s,) = _new_spans(t0, "des")
    assert s.attrs["budget_cut"] == cut and s.attrs["timed_out"] == 0


@pytest.mark.parametrize("engine", ["python", "native"])
def test_a_sim_cut_by_its_watchdog_is_not_a_budget_cut(engine):
    """A watchdog that passes long before the wall budget stops the sim: it
    counts as timed out on either engine, and not as cut by its budget."""
    adj = np.array([[1.0, 1.0], [0.0, -1.0]])
    sim = Sim(adj, [["exponential", 1.0], ["exponential", 0.8]], [0, 20], seeds=[7],
              max_sim_time=1000.0, deadline=time.time(), engine=engine)
    np.random.seed(42)
    before = COUNTERS.snapshot()
    t0 = time.perf_counter_ns()
    with _profiler():
        sim.run(number_of_customers=100_000)
    grew = COUNTERS.since(before)
    assert sim.total_customers < 100_000 and sim.budget_cut is False
    assert grew["sims_timed_out"] == 1 and grew["sims_budget_cut"] == 0
    (s,) = _new_spans(t0, "des")
    assert s.attrs["budget_cut"] == 0 and s.attrs["timed_out"] == 1


def test_counted_decodes_add_up_to_the_sims(tmp_path):
    """With a watchdog that no sim reaches, every sim is decoded or skipped
    by the reference's zero-roll shortcut, and its span says which. These
    sims pass 5,100 records, so the thread-mode batch stops each there: the
    span's ``capped`` and ``sims_capped`` count all of them."""
    B = 3
    g1, g2 = _inputs(11, B)
    np.random.seed(4)
    before = COUNTERS.snapshot()
    t0 = time.perf_counter_ns()
    with _profiler():
        mmgan_decode.matrix_to_midi(g1, g2, adj_size=(64, 64), start=100, end=150,
                                    parallel=2, log_path=str(tmp_path) + "/",
                                    out_dir=str(tmp_path / "midi"))
    grew = COUNTERS.since(before)
    assert grew["sims_run"] == B and grew["sims_timed_out"] == 0
    assert grew["rolls_decoded"] + grew["decodes_skipped"] == B
    (d,) = _new_spans(t0, "des.decode")
    assert d.attrs == {"decoded": grew["rolls_decoded"], "skipped": grew["decodes_skipped"]}
    (b,) = _new_spans(t0, "des.batch")
    assert b.attrs["events"] == grew["des_events"] > 0
    assert b.attrs["capped"] == grew["sims_capped"] == B
    assert b.end_ns <= d.start_ns


@pytest.mark.parametrize("sims,share", [("long", 100.0), ("cut", 0.0), ("unmarked", None)])
def test_the_benchmarks_capped_share_reads_the_batch_spans(tmp_path, sims, share):
    """``portbench``'s ``sim_capped_pct.train`` over a traced thread-mode
    batch: 100 where every sim passed 5,100 records, 0 where the clock cut
    them first, and nothing from spans without ``capped`` (a program that
    does not stop its sims)."""
    from types import SimpleNamespace

    from portbench import run as bench_run

    B = 2
    g1, g2 = _inputs(11, B)
    np.random.seed(4)
    t0 = time.perf_counter()
    with _profiler():
        mmgan_decode.matrix_to_midi(g1, g2, adj_size=(64, 64), start=100, end=150, parallel=2,
                                    watchdog=0.0 if sims == "cut" else 2.5,
                                    log_path=str(tmp_path) + "/", out_dir=str(tmp_path / "m"))
    window = time.perf_counter() - t0
    (b,) = _new_spans(int(t0 * 1e9), "des.batch")
    if sims == "unmarked":
        b = SimpleNamespace(name=b.name, start_ns=b.start_ns, end_ns=b.end_ns,
                            attrs={k: v for k, v in b.attrs.items() if k != "capped"})
    run = SimpleNamespace(tracer=SimpleNamespace(t0=t0, trace=SimpleNamespace(window_s=window)))
    reader = bench_run.load_metric("sim_capped_pct.train")
    with mock.patch.object(profiling, "spans", return_value=[b]):
        assert reader.read(run) == share


def test_healthz_carries_the_counters_and_a_request_its_spans(tmp_path):
    svc = GenerationService("mmgan", device="cpu", lock=threading.Lock())
    server = make_http_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter_ns()
        with _profiler():
            req = urllib.request.Request(base + "/generate/mmgan", data=b'{"n": 1, "seed": 3}',
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                reply = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
    assert health["requests"] == 1 and health["busy"] is False
    assert health["avg_latency_s"] == pytest.approx(reply["latency_s"], abs=1e-4)
    assert set(health["counters"]) == set(COUNTER_NAMES)
    assert health["counters"]["sims_run"] >= 1
    assert "sims_capped" in health["counters"] and "sims_budget_cut" in health["counters"]

    (request,) = _new_spans(t0, "request")
    (wait,) = _new_spans(t0, "lock_wait")
    assert wait.trace_id == request.trace_id and wait.end_ns <= request.start_ns
    assert request.attrs == {"model": "mmgan", "n": 1}
    assert (request.end_ns - request.start_ns) * 1e-9 == pytest.approx(reply["latency_s"], abs=2e-3)
    for name in ("generator", "des", "midi"):
        (s,) = _new_spans(t0, name)
        assert s.trace_id == request.trace_id
        assert request.start_ns <= s.start_ns <= s.end_ns <= request.end_ns
    (gen,) = _new_spans(t0, "generator")
    assert gen.parent_id == request.span_id
    replies = _new_spans(t0, "http.reply")
    assert replies and all(s.attrs["bytes"] > 0 for s in replies)


def test_a_gandes_request_records_each_stage_under_its_request():
    """One GAN-DES request on the CPU: its ``generator``, ``des``, ``midi``,
    ``synth``, ``wav`` and ``mel`` spans lie inside its ``request`` and carry
    its trace id; the sim's span says whether its wall budget cut it."""
    svc = GenerationService("gandes", device="cpu", lock=threading.Lock())
    t0 = time.perf_counter_ns()
    with _profiler():
        reply = svc.generate(n=1, seed=5)
    assert reply["mel_shape"] == [1, 128, 216]
    (request,) = _new_spans(t0, "request")
    assert request.attrs == {"model": "gandes", "n": 1}
    for name in ("generator", "des", "midi", "synth", "wav", "mel"):
        found = _new_spans(t0, name)
        assert found, name
        for s in found:
            assert s.trace_id == request.trace_id, name
            assert request.start_ns <= s.start_ns <= s.end_ns <= request.end_ns, name
    (des,) = _new_spans(t0, "des")
    assert des.attrs["budget_cut"] in (0, 1) and des.attrs["events"] > 0


class _Windows:
    """``n`` random (roll, durations, beats) windows; pulling sample
    ``stop_at`` raises ``StopFromData``."""

    def __init__(self, n, stop_at=None):
        rng = np.random.RandomState(0)
        self.rolls = (rng.rand(n, 128, 50) > 0.97).astype(np.float32) * 64
        self.durs = self.rolls / 32
        self.beats = np.tile(np.arange(50, dtype=np.float32) * 0.5, (n, 1))
        self.stop_at = stop_at

    def __len__(self):
        return len(self.rolls)

    def __getitem__(self, i):
        if i == self.stop_at:
            raise StopFromData
        return self.rolls[i], self.durs[i], self.beats[i]


class StopFromData(Exception):
    pass


def _cfg(tmp_path, **kw):
    return ml.MMGANConfig(batch_size=2, des_parallel=2, num_epochs=1, save_interval=1,
                          print_interval=1, profile=True, resume=False,
                          models_dir=str(tmp_path / "models"),
                          losses_dir=str(tmp_path / "losses"), log_path=str(tmp_path) + "/logs/",
                          midi_out_dir=str(tmp_path / "midi"), **kw)


def test_train_history_counts_the_host_stage_and_steps_are_spans(tmp_path):
    np.random.seed(0)
    t0 = time.perf_counter_ns()
    with _profiler():
        _, history = ml.train_mmgan(_Windows(4), _cfg(tmp_path), device="cpu")
    counters = history["counters"]
    assert set(counters) == set(COUNTER_NAMES)
    assert counters["sims_run"] == 4 and counters["sims_failed"] == 0
    assert (counters["rolls_decoded"] + counters["decodes_skipped"]
            + counters["sims_timed_out"]) == 4
    assert counters["des_events"] > 0

    steps = _new_spans(t0, "step")
    assert [s.trace_id for s in steps] == [1, 2]
    by_id = {s.span_id: s for s in _new_spans(t0)}
    for name, parent in (("host_des", "step"), ("device_step", "step"), ("report", "step"),
                         ("gen_forward", "host_des"), ("g_fetch", "host_des"),
                         ("des.batch", "host_des"), ("des.decode", "host_des")):
        found = _new_spans(t0, name)
        assert len(found) == 2, name
        for s in found:
            assert by_id[s.parent_id].name == parent, name
            assert s.trace_id == by_id[s.parent_id].trace_id
    (ckpt,) = _new_spans(t0, "checkpoint")
    assert ckpt.parent_id is None and ckpt.trace_id == 2
    assert sum(s.attrs["sims"] for s in _new_spans(t0, "des.batch")) == 4


def test_step_timer_samples_are_complete_after_the_loop_stops_from_its_data(
        tmp_path, monkeypatch):
    timers = []

    class Timer(ml.StepTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    monkeypatch.setattr(ml, "StepTimer", Timer)
    np.random.seed(1)
    with pytest.raises(StopFromData):  # the third batch's first sample
        ml.train_mmgan(_Windows(8, stop_at=4), _cfg(tmp_path), device="cpu")
    (timer,) = timers
    for phase in ("host_des", "device_step"):
        assert len(timer.samples[phase]) == 2
        assert all(isinstance(x, float) and x > 0 for x in timer.samples[phase])


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: recorded at a fake card time,
    done once the fake card has passed it."""

    card = {"now_ms": 0.0, "done_ms": 0.0, "waits": 0}

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        self.at = self.card["now_ms"]

    def query(self):
        return self.at <= self.card["done_ms"]

    def synchronize(self):
        self.card["waits"] += 1
        self.card["done_ms"] = max(self.card["done_ms"], self.at)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.at - self.at


def test_event_timed_phases_wait_for_the_card_only_when_read(monkeypatch):
    card = _FakeEvent.card
    card.update(now_ms=0.0, done_ms=0.0, waits=0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def no_sync(*args, **kwargs):
        raise AssertionError("a phase synchronised the card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timer = StepTimer()
    for step in range(3):
        with timer.phase("host_des"):
            card["now_ms"] += 5.0  # the host's work moves the card's clock on
        with timer.phase("device_step", device="cuda"):
            card["now_ms"] += 2.0 + step
        if step == 0:
            card["done_ms"] = card["now_ms"]  # the card caught up with step 0
    assert card["waits"] == 0
    # step 0 resolved on the way, the others when read
    assert timer._samples["device_step"] == [pytest.approx(2.0e-3), None, None]
    assert timer.samples["device_step"] == pytest.approx([2.0e-3, 3.0e-3, 4.0e-3])
    assert card["waits"] == 2
    assert len(timer.samples["host_des"]) == 3
    assert timer.summary()["device_step"]["count"] == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the device phase only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profiled_loop_times_the_step_by_events_without_a_synchronise(cuda, tmp_path,
                                                                      monkeypatch):
    """On the card under ``profile``, the device phase is CUDA-event timed:
    no ``torch.cuda.synchronize`` in the loop, and each sample at most the
    wall time from the phase's start to the end of the run."""
    timers, syncs = [], []

    class Timer(ml.StepTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    real_sync = torch.cuda.synchronize

    def sync(*args, **kwargs):  # CUDA-graph capture synchronises too: note who asks
        syncs.append(sys._getframe(1).f_code.co_filename)
        real_sync(*args, **kwargs)

    monkeypatch.setattr(ml, "StepTimer", Timer)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    np.random.seed(2)
    t0 = time.perf_counter()
    _, history = ml.train_mmgan(_Windows(8), _cfg(tmp_path), device="cuda")
    wall = time.perf_counter() - t0
    (timer,) = timers
    assert not [f for f in syncs if f in (profiling.__file__, ml.__file__)]
    device = timer.samples["device_step"]
    assert len(device) == 4 and all(0.0 < x < wall for x in device)
    assert history["profile"]["device_step"]["count"] == 4
    assert history["counters"]["sims_run"] == 8
