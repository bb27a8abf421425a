"""Benchmark of the port: fused MM-GAN train steps/s on the card against the
reference's PyTorch-CPU math — the counterpart of the root ``bench.py``.

    python -m gandes_tpu_torch.bench [--all] [--device cuda|cpu]
    python -m gandes_tpu_torch.cli bench [--all] [--device cuda|cpu]

Measures the per-step device work of MM-GAN training (D update on real and
fake rolls, the post-update G loss, G's Adam step, then the next batch's
train-mode G1+G2 forward: ``train/steps.py::
make_mmgan_step_and_next_forward``, the reference's `network_tests.py:
276-348` inner loop minus the host DES) at the reference's configuration:
batch 16, 64x64 adjacency, (2, 128, 50) rolls. On CUDA the step is one CUDA
graph replay (``graph_step``), as in the training loop; on the CPU it runs
eagerly and the kernels take their plain versions. The baseline is the same
math in torch on the CPU (``bench_torch_cpu``, copied from the root bench).

Prints one JSON line per metric (``_emit``), the headline
``mmgan_fused_train_steps_per_sec`` last. The whole run keeps one wall-clock
deadline (``GANDES_BENCH_DEADLINE_S``, default 420 s) and a SIGTERM/SIGALRM
guard that prints the best-known headline. ``--all`` adds the rows of the
root bench's perf table: the DES engines, the mel (kernel K2) and roll
(kernel K1) against their plain versions, the MM-GAN host stage, batch
scaling to B = 1024 (float32 and bf16), and warm serving latency. Before
the headline, a note on stderr gives the kernels' launches in the run, by
their wrappers' counts: ``# launches mel_power N roll_rasterize M``.

Left out of the root bench, as TPU/relay workarounds with no GPU reason:
the healthy-rate floor ``HEALTHY_STEPS_PER_SEC`` and ``_degraded_retry``
(extra windows while a remote relay reads degraded), the 20 s and 60 s
sleeps between windows and retries, and ``enable_compilation_cache``.
Windows run back to back. Each headline window starts from the same state:
the captured step's tensors are restored in place (``_Restore``), since a
CUDA graph refuses a state whose tensors were replaced after capture.

FLOPs per step come from ``torch.utils.flop_counter.FlopCounterMode`` over
one eager call of the step (products and convolutions, forward and
backward; the JAX bench read XLA's cost analysis). MFU divides by this
card's peak for the step's type (``F32_PEAK_FLOPS``, ``BF16_PEAK_FLOPS``);
the MFU rows are the card's only, and ``--device cpu`` prints none.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import time

import numpy as np

BATCH, T, ADJ, ZDIM = 16, 50, 64, 50
LR = 0.01

# H100 SXM, NVIDIA's data sheet: float32 outside the tensor cores. TF32 is
# off in the port (``gandes_tpu_torch.use_f32_numerics``), so the step's
# float32 products run on the CUDA cores at this rate.
F32_PEAK_FLOPS = 67e12
# H100 SXM dense bf16 on the tensor cores (``compute_dtype='bf16'``).
BF16_PEAK_FLOPS = 989.4e12

# ---------------------------------------------------------------- deadline
#
# The whole bench runs against one wall-clock deadline, the headline is
# computed from the first windows, and a signal/alarm guard prints the
# best-known headline even if the process is killed mid-row: a timeout can
# truncate the optional rows but cannot erase the headline.

_T_START = time.monotonic()
try:
    _DEADLINE_S = float(os.environ.get("GANDES_BENCH_DEADLINE_S", "420"))
except ValueError:
    _DEADLINE_S = 420.0

_HEADLINE = None  # set as soon as the first measurement exists


def _remaining() -> float:
    return _DEADLINE_S - (time.monotonic() - _T_START)


def _flush_headline_and_exit(signum, frame):
    """SIGTERM/SIGALRM guard: emit the best-known headline as the LAST
    line (a reader parses the last JSON line) and exit cleanly."""
    if _HEADLINE is not None:
        sys.stdout.write("\n" + json.dumps(_HEADLINE) + "\n")
        sys.stdout.flush()
        os._exit(0)
    os._exit(1)


def _step_flops(fn, *args):
    """FLOPs of one eager call of ``fn(*args)`` from ``FlopCounterMode``
    (None when it counts none): the numerator of the MFU rows. The call
    runs, so it advances a state it is given."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops()) or None


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Restore:
    """Every tensor of a ``GANState`` (params, BatchNorm statistics, both
    Adams' state) and its step count as they are now; ``()`` copies them
    back in place, so a CUDA graph captured over the state still holds it
    (the counterpart of the root bench's ``fresh()`` copies)."""

    def __init__(self, state):
        import torch

        from gandes_tpu_torch.train.steps import _state_tensors

        self.state, self.step = state, state.step
        self.tensors = _state_tensors(state, optimizers=True)
        with torch.no_grad():
            self.saved = [t.detach().clone() for t in self.tensors]

    def __call__(self):
        import torch

        with torch.no_grad():
            for t, s in zip(self.tensors, self.saved, strict=True):
                t.copy_(s)
        self.state.step = self.step
        return self.state


def _mmgan_setup(batch: int, device, compute_dtype=None):
    """An MM-GAN ``GANState`` at the bench's widths and batch on
    ``device``, its counted step-and-next-forward (``step_fn``), the step
    to time (a CUDA graph on CUDA, ``step_fn`` on the CPU) and inputs drawn
    from a seeded ``torch.Generator``."""
    import torch

    from gandes_tpu_torch.models.composite import MultiModalGAN
    from gandes_tpu_torch.train.steps import (
        graph_step,
        init_mmgan_state,
        make_mmgan_step_and_next_forward,
    )

    device = torch.device(device)
    model = MultiModalGAN(z_dim=ZDIM, adj_size=(ADJ, ADJ), roll_size=(2, 128, T),
                          input_dim=50, output_dim=20, seed=0,
                          compute_dtype=compute_dtype or torch.float32).to(device)
    lr = lambda count: LR  # noqa: E731 — optax.adam(0.01): a constant rate
    state = init_mmgan_state(model, lr, lr)
    step_fn = make_mmgan_step_and_next_forward(lr, lr)
    gen = torch.Generator().manual_seed(1)
    inputs = dict(
        noise1=torch.randn(batch, ZDIM, generator=gen),
        noise2=torch.randn(batch, ZDIM, generator=gen),
        beats=torch.zeros(batch, 50), aux=torch.randn(batch, ZDIM, generator=gen),
        real=torch.rand(batch, 2, 128, T, generator=gen) * 100.0,
        fake=torch.rand(batch, 2, 128, T, generator=gen) * 100.0)
    inputs = {k: v.to(device) for k, v in inputs.items()}
    step = graph_step(step_fn) if device.type == "cuda" else step_fn
    return state, step_fn, step, inputs


def _call(step, state, x, fake=None):
    """One step: ``step(state, real, fake, noise1, noise2, beats, aux)``."""
    return step(state, x["real"], x["fake"] if fake is None else fake, x["noise1"],
                x["noise2"], x["beats"], x["aux"])


def bench_torch(iters: int = 100, windows: int = 3, on_window=None,
                warm_out: dict | None = None, device="cuda"):
    """The headline's measurement windows: ``iters`` steps each, the rate
    of each appended to the returned list; returns ``(rates, flops)``."""
    state, step_fn, step, x = _mmgan_setup(BATCH, device)
    # warm-up: on CUDA the first call runs eagerly and captures the graph
    _call(step, state, x)
    _sync(device)
    flops = _step_flops(lambda: _call(step_fn, state, x))
    fresh = _Restore(state)
    if warm_out is not None:
        # the warm captured step and its inputs for the full-pipeline and
        # scan rows (the root bench hands its compiled step over the same way)
        warm_out.update(step=step, step_fn=step_fn, state=state, fresh=fresh, inputs=x)

    rates = []

    def window():
        s = fresh()
        t0 = time.perf_counter()
        for _ in range(iters):
            _call(step, s, x)
        _sync(device)
        rates.append(iters / (time.perf_counter() - t0))
        if on_window is not None:
            on_window(rates)

    for w in range(windows):
        window()
        # more windows only while the deadline share reserved for the
        # full-pipeline and scan rows (~45 %) is untouched
        if w + 1 < windows and _remaining() < 0.55 * _DEADLINE_S:
            break
    return rates, flops


def bench_torch_cpu(iters: int = 20) -> float:
    import torch
    from torch import nn

    class GenBlock(nn.Sequential):
        def __init__(self, i, o):
            super().__init__(nn.Linear(i, o), nn.BatchNorm1d(o), nn.Sigmoid())

    class G(nn.Module):
        def __init__(self, out):
            super().__init__()
            self.net = nn.Sequential(GenBlock(100, 256), GenBlock(256, 128),
                                     GenBlock(128, 64), GenBlock(64, out))

        def forward(self, x):
            return self.net(x)

    class DCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(2, 16, 4, 2, 1)
            self.c2 = nn.Conv2d(16, 32, 4, 2, 1)
            self.act = nn.LeakyReLU(0.2)
            self.fc = nn.Linear(32 * 32 * (T // 4), 1)

        def forward(self, x):
            x = self.act(self.c1(x))
            x = self.act(self.c2(x))
            return self.fc(x.reshape(len(x), -1))

    torch.manual_seed(0)
    torch.set_num_threads(max(1, torch.get_num_threads()))
    g1, g2, d = G(ADJ * ADJ), G(20), DCNN()
    gopt = torch.optim.Adam(list(g1.parameters()) + list(g2.parameters()), lr=0.01)
    dopt = torch.optim.Adam(d.parameters(), lr=0.01)
    crit = nn.BCEWithLogitsLoss()

    noise = torch.randn(BATCH, 100)
    real = torch.rand(BATCH, 2, 128, T) * 100
    fake = torch.rand(BATCH, 2, 128, T) * 100
    ones, zeros = torch.ones(BATCH), torch.zeros(BATCH)

    def one():
        m = g1(noise).view(BATCH, ADJ, ADJ)
        v = g2(noise)
        dopt.zero_grad()
        loss = crit(d(fake.detach()).squeeze(), zeros) + crit(d(real).squeeze(), ones)
        loss.backward()
        dopt.step()
        gopt.zero_grad()
        gl = crit(d(fake).squeeze(), ones)
        gl.backward()
        gopt.step()
        return m, v

    one()  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        one()
    return iters / (time.perf_counter() - t0)


# ------------------------------------------------------- --all sub-benches


def _emit(metric, value, unit, vs_baseline=None):
    """One JSON line per metric. ``vs_baseline=None`` omits the field —
    for rows with no meaningful baseline ratio (a placeholder 1.0 would
    read as 'at parity')."""
    row = {"metric": metric, "value": round(value, 4), "unit": unit}
    if vs_baseline is not None:
        row["vs_baseline"] = round(vs_baseline, 2)
    print(json.dumps(row), flush=True)


@contextlib.contextmanager
def _tmp_workdir():
    """chdir into a fresh temp dir with a logs/ subdir; always restore."""
    import tempfile

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs("logs", exist_ok=True)
            yield tmp
        finally:
            os.chdir(cwd)


def bench_des(customers: int = 20000) -> None:
    """Dense 8-node queueing net, Music logging on: native vs Python engine."""
    import tempfile

    from gandes_tpu_torch.des import Sim

    adj = np.zeros((8, 8))
    adj[0, 0] = adj[1, 1] = 1.0          # two sources
    for i in range(2, 8):
        adj[i, i] = -1.0                 # six servers
    adj[0, 2:8] = 1.0 / 6                # sources fan out over all servers
    adj[1, 2:8] = 1.0 / 6
    for i in range(2, 7):                # servers chain + drain to the sink
        adj[i, i + 1] = 0.5
        adj[i, 7] = 0.5
    # row 7 has no children -> sink
    dists = [["exponential", 1.0], ["exponential", 1.0]] + [
        ["exponential", 0.4]] * 6
    queues = [0, 0] + [30] * 6

    def run(engine):
        with tempfile.TemporaryDirectory() as tmp:
            np.random.seed(3)
            sim = Sim(adj, dists, queues, seeds=[7], generate_log=True,
                      log_path=tmp + "/", logging_mode="Music",
                      max_sim_time=1e9, engine=engine)
            t0 = time.perf_counter()
            sim.run(number_of_customers=customers)
            return time.perf_counter() - t0

    # the same number of tries on both sides: unequal repeat counts would
    # bias the ratio toward whichever side gets more
    t_native = min(run("native") for _ in range(3))
    t_python = min(run("python") for _ in range(3))
    _emit("des_engine_customers_per_sec_logged", customers / t_native,
          "customers/s", t_python / t_native)


def _timeit(fn, device, iters: int = 50) -> float:
    """Seconds per call of ``fn``: one warm-up, ``iters`` calls, synced."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def bench_mel(device="cuda") -> None:
    """5 s / 216-frame mel front end: kernel K2 (``melspectrogram_db_tensor``
    on a wave already on the card) vs its plain version on the same wave."""
    import torch

    from gandes_tpu_torch.music.mel import amplitude_to_db_torch, melspectrogram_db_tensor
    from gandes_tpu_torch.ops.mel_power import mel_power_reference

    sr = 44100
    wav = torch.from_numpy(
        np.sin(np.linspace(0, 5 * 2 * np.pi * 440, 5 * sr)).astype(np.float32)).to(device)
    hop = wav.shape[0] // 215

    def plain():
        mel = mel_power_reference(wav[:216 * hop], sr, hop_length=hop)
        return amplitude_to_db_torch(mel)

    t_kernel = min(_timeit(lambda: melspectrogram_db_tensor(wav, sr=sr), device)
                   for _ in range(3))
    t_plain = min(_timeit(plain, device) for _ in range(3))
    _emit("mel_5s_216f_ms", t_kernel * 1e3, "ms", t_plain / t_kernel)


def bench_roll(B: int = 16, E: int = 512, T: int = 50, device="cuda") -> None:
    """Batched piano-roll rasterization: kernel K1 (``rasterize_events`` on
    the card) vs its plain version on the same events."""
    import torch

    from gandes_tpu_torch.music.piano_roll import rasterize_events
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_events_reference

    rng = np.random.RandomState(0)
    notes = rng.randint(-1, 128, (B, E)).astype(np.int32)
    ons = rng.randint(0, 160, (B, E)).astype(np.int32)
    offs = ons + rng.randint(-2, 20, (B, E)).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    events = [torch.from_numpy(a).to(device) for a in (notes, ons, offs, vels)]

    t_fast = min(_timeit(lambda: rasterize_events(*events, num_steps=T, start=100), device)
                 for _ in range(3))
    t_plain = min(_timeit(lambda: rasterize_events_reference(*events, num_steps=T, start=100),
                          device) for _ in range(3))
    _emit("piano_roll_ms_per_roll", t_fast / B * 1e3, "ms", t_plain / t_fast)


def bench_host_stage(B: int = 16) -> None:
    """MM-GAN host DES stage for one training batch: parallel vs sequential."""
    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi

    rng = np.random.RandomState(5)
    g1 = rng.rand(B, 1, 64, 64).astype(np.float32)
    g2 = (rng.rand(B, 20).astype(np.float32) * 0.5 + 0.2)

    def run(parallel):
        with _tmp_workdir():
            t0 = time.perf_counter()
            matrix_to_midi(g1, g2, adj_size=(64, 64), instrument=0,
                           start=100, end=150, parallel=parallel)
            return time.perf_counter() - t0

    t_par = min(run(16) for _ in range(2))
    t_seq = min(run(None) for _ in range(2))
    _emit("mmgan_host_stage_s_per_batch", t_par, "s", t_seq / t_par)


def bench_full_step(torch_rate: float, warm: dict, iters: int = 3, device="cuda") -> None:
    """FULL MM-GAN train step: the headline's captured step (D update, G
    loss, next G1/G2 forward) + the host DES stage (decode, simulate, MIDI,
    rasterize, ``parallel=BATCH``) — end to end, not device math alone.

    vs_baseline: a reference-equivalent full step = the torch-CPU device
    math plus the *sequential* host stage measured here. The sequential
    stage still rides the native engine, so the baseline is a conservative
    lower bound on the reference's real cost."""
    import torch

    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi

    step, x = warm["step"], warm["inputs"]
    state = warm["fresh"]()

    def host_stage(mats, vec, parallel):
        rolls, _failed = matrix_to_midi(
            mats.cpu().numpy()[:, None], vec.cpu().numpy(), adj_size=(ADJ, ADJ),
            instrument=0, start=100, end=150, parallel=parallel)
        return torch.from_numpy(np.stack(rolls).astype(np.float32)).to(device)

    with _tmp_workdir():
        np.random.seed(7)
        # warm-up: the first DES round trip
        _, mats, vec, _ = _call(step, state, x, fake=x["real"])
        fake = host_stage(mats, vec, BATCH)

        t0 = time.perf_counter()
        for _ in range(iters):
            _, mats, vec, _ = _call(step, state, x, fake=fake)
            fake = host_stage(mats, vec, BATCH)
        full_rate = iters / (time.perf_counter() - t0)

        # baseline host stage: sequential parity mode, one batch
        np.random.seed(7)
        t0 = time.perf_counter()
        host_stage(mats, vec, None)
        t_host_seq = time.perf_counter() - t0
    baseline_rate = 1.0 / (1.0 / torch_rate + t_host_seq)
    _emit("mmgan_full_pipeline_steps_per_sec", full_rate, "steps/s",
          full_rate / baseline_rate)


def bench_batch_scaling(big_batch: int = 1024, iters: int = 50, device="cuda") -> None:
    """The same step at a large batch, in float32 and in bf16 compute
    (``compute_dtype``: params, Adams and BatchNorm statistics stay
    float32). vs_baseline: samples/s over the B = 16 configuration, the
    MFU's over B = 16's, bf16's samples/s over float32's. Each
    configuration's MFU against its type's peak goes to stderr."""
    import torch

    rates, mfu = {}, {}
    for B, dt, peak in ((BATCH, torch.float32, F32_PEAK_FLOPS),
                        (big_batch, torch.float32, F32_PEAK_FLOPS),
                        (big_batch, torch.bfloat16, BF16_PEAK_FLOPS)):
        state, step_fn, step, x = _mmgan_setup(B, device, compute_dtype=dt)
        _call(step, state, x)
        _sync(device)
        flops = _step_flops(lambda: _call(step_fn, state, x))
        dt_s = _timeit(lambda: _call(step, state, x), device, iters)
        rates[(B, dt)] = B / dt_s
        if flops and torch.device(device).type == "cuda":
            mfu[(B, dt)] = flops / dt_s / peak * 100.0
    f32_big = rates[(big_batch, torch.float32)]
    bf16_big = rates[(big_batch, torch.bfloat16)]
    _emit(f"mmgan_train_step_samples_per_sec_B{big_batch}", f32_big,
          "samples/s", f32_big / rates[(BATCH, torch.float32)])
    if (big_batch, torch.float32) in mfu:
        base = mfu.get((BATCH, torch.float32))
        _emit(f"mmgan_train_step_mfu_pct_B{big_batch}", mfu[(big_batch, torch.float32)], "%",
              mfu[(big_batch, torch.float32)] / base if base else None)
    _emit(f"mmgan_train_step_samples_per_sec_B{big_batch}_bf16", bf16_big,
          "samples/s", bf16_big / f32_big)
    if mfu:
        print("# MFU by configuration: " + ", ".join(
            f"B={b} {str(d).removeprefix('torch.')} {v:.4f} %" for (b, d), v in mfu.items()),
            file=sys.stderr)


def bench_scan_steps(warm: dict, K: int = 64, iters: int = 10, device="cuda") -> None:
    """Dispatch-free ceiling: K train steps as one call
    (``make_scanned_steps``: one CUDA graph of K steps on CUDA, K eager
    calls on the CPU), against the headline's captured per-step replay on
    the same state. vs_baseline: speedup over that per-replay rate."""
    from gandes_tpu_torch.train.steps import make_scanned_steps

    step, x = warm["step"], warm["inputs"]
    scanned = make_scanned_steps(warm["step_fn"], K)

    def rate(fn, n_steps, iters):
        s = warm["fresh"]()
        fn(s)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(s)
        _sync(device)
        return n_steps * iters / (time.perf_counter() - t0)

    one = lambda s: _call(step, s, x, fake=x["real"])  # noqa: E731
    many = lambda s: scanned(s, x["real"], x["real"], x["noise1"], x["noise2"],  # noqa: E731
                             x["beats"], x["aux"])
    r_launch = max(rate(one, 1, K * iters) for _ in range(3))
    r_scan = max(rate(many, K, iters) for _ in range(3))
    _emit(f"mmgan_train_steps_per_sec_scan{K}", r_scan, "steps/s", r_scan / r_launch)


def bench_serving(n_requests: int = 10, device="cuda") -> None:
    """Warm single-sample generation latency through the serving service
    (G forward + full DES + MIDI encode). Absolute metric — the reference
    has no serving path at all — so vs_baseline is fixed at 1.0."""
    import io

    from gandes_tpu_torch.serve import GenerationService

    with _tmp_workdir():
        # generation prints progress lines; keep stdout JSON-only
        with contextlib.redirect_stdout(io.StringIO()):
            svc = GenerationService(model="mmgan", start=0, device=device)
            svc.generate(n=1, seed=0)  # warmup
            lats = [svc.generate(n=1, seed=i + 1)["latency_s"]
                    for i in range(n_requests)]
    _emit("serve_warm_latency_p50_s", float(np.median(lats)), "s", 1.0)


def main(argv=None):
    global _HEADLINE

    ap = argparse.ArgumentParser(prog="python -m gandes_tpu_torch.bench")
    ap.add_argument("--all", action="store_true", help="add the perf table's rows")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is false (--device cpu runs the "
                         "plain versions)")

    # arm the guard before any measurement: `timeout`'s SIGTERM and our own
    # SIGALRM (self-deadline, 20 s inside it so the headline line wins the
    # race against an external SIGKILL follow-up) both flush the best-known
    # headline as the final JSON line.
    signal.signal(signal.SIGTERM, _flush_headline_and_exit)
    signal.signal(signal.SIGALRM, _flush_headline_and_exit)
    signal.alarm(max(30, int(_DEADLINE_S - 20)))

    # The CPU baseline first, then the headline, refreshed after every
    # window; the same number of samples on both sides (best of 5).
    torch_rates = [bench_torch_cpu(iters=10)]
    while len(torch_rates) < 5 and _remaining() > 0.80 * _DEADLINE_S:
        torch_rates.append(bench_torch_cpu(iters=10))
    torch_rate = max(torch_rates)
    torch_sustained = float(np.median(torch_rates))

    def on_window(rates):
        global _HEADLINE
        _HEADLINE = {
            "metric": "mmgan_fused_train_steps_per_sec",
            "value": round(max(rates), 2),
            "unit": "steps/s",
            "vs_baseline": round(max(rates) / torch_rate, 2),
        }

    warm = {}
    rates, flops = bench_torch(iters=60, windows=5, on_window=on_window, warm_out=warm,
                               device=device)
    sustained = float(np.median(rates))

    if flops and device.type == "cuda":
        # utilization of the device step: counted FLOPs/step x sustained
        # steps/s over the card's float32 peak. The models are the
        # reference's tiny MLP/CNNs at batch 16, so the absolute MFU is low;
        # bench_batch_scaling's B = 1024 row loads the card.
        _emit("mmgan_train_step_mfu_pct", flops * sustained / F32_PEAK_FLOPS * 100.0, "%")
    _emit("mmgan_fused_train_steps_per_sec_sustained", sustained, "steps/s",
          sustained / torch_sustained)

    # Full-pipeline and scan rows in process on the headline's warm captured
    # step, each deadline- and exception-guarded: a row may be truncated,
    # the headline may not.
    for label, need_s, fn in (
        ("full-pipeline", 40.0, lambda: bench_full_step(torch_rate, warm, device=device)),
        ("scan-steps", 75.0, lambda: bench_scan_steps(warm, device=device)),
    ):
        if _remaining() < need_s:
            print(f"# {label} row skipped: deadline nearly spent", file=sys.stderr)
            continue
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — a row must not kill the headline
            print(f"# {label} row failed: {type(e).__name__}: {e}", file=sys.stderr)

    if args.all:
        # the perf table's rows; they run after the headline exists, so a
        # deadline kill truncates rows, not the headline
        bench_des()
        bench_mel(device=device)
        bench_roll(device=device)
        bench_host_stage()
        bench_batch_scaling(device=device)
        bench_serving(device=device)

    signal.alarm(0)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    # the kernels' launches in this run, by their wrappers' own counts
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda

    print(f"# launches mel_power {mel_power_cuda.launches} "
          f"roll_rasterize {rasterize_cuda.launches}", file=sys.stderr, flush=True)
    print(json.dumps(_HEADLINE), flush=True)


if __name__ == "__main__":
    main()
