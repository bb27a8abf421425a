#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``gandes_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the last line:

1. device   — CUDA must be available; prints ``nvidia-smi``'s name and power
              limit.
2. build    — builds every kernel from this checkout's sources, all started
              together (nvcc for ``ops/csrc/mel_power.cu`` and
              ``ops/csrc/roll_rasterize.cu``, g++ for the DES core) and
              prints the build seconds and each kernel's ptxas lines.
3. kernel   — holds each kernel against its plain PyTorch version on the card
              and times kernel, plain version and (where one exists) the
              one-call library equivalent with CUDA events (``ms``: median
              of 30 after 5 warmup calls, the wrapper's host work
              included), and the kernel alone from a torch.profiler trace
              (``device_ms``: its device time summed over the traced
              launches of 30 calls / their count).
              K2 (mel_power) at the serve path's shapes: rtol 2e-3 / atol
              1e-4 in power, 0.05 dB after ``amplitude_to_db_torch``, and
              two launches on one wave bitwise equal; the bound counts the
              function's least work (a real FFT per frame). Also at 300,
              900, 1,024 and 1,025 samples (``SHORT_WAVES``, shorter than
              the 1,024-sample reflect pad, at the dynamic hop len // 215),
              where ``melspectrogram_db_tensor`` on the card is held to the
              CPU's (128, 217) within 0.05 dB; torch.stft refuses such a
              pad, so those rows have no ``library_ms``.
              K1 (roll_rasterize) at the JAX kernel tests' shapes, the
              pickler's (8, 4096, 300), a dense (8, 16384, 300), a long
              roll (2, 4096, 2000), one pitch (8, 4096, 300; every note 60)
              and midi_order (the first 8 corpus files' events as the
              pickler pads them): bitwise (``torch.equal``) and two
              launches on one input bitwise equal; bytes-bound (4 B per
              note, 12 B more per slot up to each sample's trip count, 4 B
              per roll cell out).
4. serve    — launch counts set to 0; ``GenerationService(model="gandes")`` at
              full width on ``cuda`` with a warmup request, then an HTTP
              server on 127.0.0.1:0 answering POST /generate/gandes (n=4,
              seeds 0, 1, 0) and GET /healthz; counts read. Checks RIFF WAVs,
              mel_shape [4, 128, 216], byte-identical replies for the repeated
              seed, and that the serve path launched every kernel.
   profile  — the device busy share of one more request (``device_busy``):
              the union of the device-side intervals (kernels, copies,
              memsets) in a torch.profiler trace over the request's host
              wall time.
5. slice    — ``matrix_to_wav`` on the card for two matrices: finite mel of
              shape (2, 128, 216) equal (0.05 dB) to the plain CPU mel of the
              same WAV samples, MIDI bytes equal to the CPU port's; plus a
              per-stage time breakdown of one request's samples.
6. pickle   — a synthetic MAESTRO-density corpus (256 files of 330 s at ~10
              notes/s, written with the port's MIDI writer from a numpy
              seed); launch counts set to 0; ``build_window_pickle(
              device_rasterize=True, device="cuda")``; counts read. Then the
              sequential host path: equal window count and sha256 over every
              window's bytes. Prints files/s, MB/s and a parse vs rasterize
              breakdown. The device path's windows stay for phase 8.
7. serve_mmgan — ``GenerationService(model="mmgan")`` at full width (G1
              100-256-128-64-4096, G2 100-256-128-64-20) on ``cuda`` with a
              warmup request, then HTTP POST /generate/mmgan (n=4, seeds 0,
              1, 0) and GET /healthz. Checks MIDI (``MThd``), equal bytes for
              the repeated seed wherever neither slot failed (the DES budget
              is wall-clock, so each slot's failed flag is printed), different
              songs for seeds 0 and 1; G1/G2 on the card vs a CPU copy (atol
              1e-5); each reply's MIDI equal to the host decode of the card's
              generator outputs.
8. train_mmgan — MM-GAN training at ``MMGANConfig()`` width (B = 16, lr
              0.01, start 100) on ``cuda``, on phase ``pickle``'s device-path
              windows: ``train_mmgan`` in ``none`` mode for 2 epochs of 3
              batches under ``profile`` (steps/s, StepTimer's ``host_des`` vs
              ``device_step`` seconds per step), resumed to epoch 3, then one
              epoch of ``direct`` and one of ``faithful`` (2 batches each).
              Checks finite losses, model and Adam states on the card, G
              unchanged by ``none`` steps, the resumed counts following the
              first run's, the epoch-2 checkpoint reloading bit for bit, one
              ``none`` and one ``direct`` step on the card (the CPU's Adam
              configuration; the loop's capturable Adams printed beside,
              their losses held to the same 1e-4) vs the CPU at
              rtol 1e-4 (losses and D's gradients vs float32, G's vs a
              float64 step, and G's vs float32 with a two-pass BatchNorm
              variance; G's vs float32 and a batch-reversed CPU step
              printed beside), the same 3 steps twice bitwise equal,
              cuDNN's flags restored after training, and no K1/K2 launch;
              prints the device busy share of one loop step (G forward,
              DES, step) and D's backward under deterministic and default
              cuDNN algorithms. The loop's steps are CUDA graphs; the
              eager step is profiled beside.
9. train_fast — the same training with the whole-batch native host stage
              (``des_parallel=16``): graph steps, eager steps and
              ``fused_io``, 2 epochs of 3 batches each (steps/s,
              ``host_des``, ``device_step`` p50/p95, counts, finite
              losses), beside phase 8's sequential run; then captured ==
              eager steps bitwise (none, direct, StepLR boundaries), captured
              steps repeatable, ``make_scanned_steps(K=4)`` == 4 single
              captured steps, cuDNN's default algorithms under capture
              (repeatable? device ms saved), the captured step's busy
              share and host ops beside the eager step's, the busy share of
              a captured loop step, and ``parallel=1`` on this host ==
              the sequential decode (rolls, failures, RNG state) with the
              host stage's time per batch at parallel None, 1 and 16.
10. gandes_parallel — ``matrix_to_wav(parallel=4)`` on 4 serve-width
              matrices on the card: K2 launches (4), mels and WAVs vs the
              port's CPU run of the same call (0.05 dB above the floor, 0.2
              dB on every bin, <= 2e-4 int16 flips), timed beside the
              sequential call. Runs after phase 5; K2's launches in the
              ``kernels`` line add this path's to the serve path's.
11. train_gandes — GAN-DES training at ``GanDesConfig()`` width (B = 30,
              20x20, mel 128x216, 1000 customers, lr 2e-5, seed 0) on
              ``cuda``, its real side ``MaestroDatasetGanDes(batch_size=30)``
              on the card over 4 synthetic 150 s files: ``none`` 4 steps
              straight and 3 + resumed to 4 (bitwise equal), ``surrogate``
              and ``reinforce`` 2 steps, one step writing WAVs, ``none`` 2
              steps with the sequential host stage; the others run
              ``des_parallel=16``. Steps/s, ``host_des`` and ``device_step``
              per step; K2's launches (counter set to 0 before, read after)
              equal to the fake clips plus the real slices; one step of each
              mode on the card vs the CPU (losses, D's gradients, G's
              through the card's post-update D and surrogate, float64
              printed beside) and twice on the card bitwise; the G forward
              twice bitwise; the busy share of one loop step. K2's
              launches in the ``kernels`` line add this path's.

12. train_mmgan_modes — MM-GAN ``surrogate`` and ``reinforce`` training at
              ``MMGANConfig()`` width (B = 16, lr 0.01, ``surrogate_lr``
              1e-3) on ``cuda`` with ``des_parallel=16``, on phase
              ``pickle``'s windows: ``surrogate`` with instance noise (sigma
              2, floor 0.5, annealed over 2 epochs), R1 ``exact``,
              ``moment_match`` and ``moment_match_cond`` for 2 epochs of 3
              batches, resumed to epoch 3, beside a straight 3-epoch run
              (bitwise equal, the ``_surrogate`` checkpoint included);
              ``surrogate`` with R1 ``fd`` and ``reinforce``, one epoch of
              3 batches each. Steps/s, ``host_des`` and ``device_step``
              p50/p95 per run; no K1/K2 launch; one step of each mode on the
              card vs the CPU (losses rtol 1e-4, reinforce's G loss 1e-3:
              it cancels logprobs of ~-2,000 down to ~2; D's and the
              surrogate's gradients within the rtol 1e-4 budget; G's
              through the card's post-update D and surrogate with a
              two-pass BatchNorm variance vs the CPU's float32, and with
              flax's one-pass variance vs float32 and float64 printed
              beside: on these inputs the CPU's own float32 G gradients
              land 1.4 to 500 of the budget from float64, the H100's 1.3
              to 2.8) and twice on the card bitwise;
              ``make_scanned_steps(K=4, n_carry=2)`` and the regression
              scan (K = 4) == single steps bitwise; the busy
              share of one loop step of each mode.
13. eval_metrics — ``eval-metrics`` through ``cli.main`` on ``cuda``
              (its printed JSON parsed): MM-GAN (n = 16) sweeping phase
              12's epoch checkpoints (its ``_surrogate`` companions
              skipped), GAN-DES (n = 8 over phase 11's corpus) sweeping
              phase 11's ``gen_*`` checkpoints; the JSON keys; each real
              side against a ``--device cpu`` run's (MM-GAN statistics
              rtol 1e-6; GAN-DES real mels slice by slice within phase
              slice's 0.05 dB on every bin); no K1 launch; K2's launches
              equal to the real slices plus 8 fake clips per checkpoint,
              added to the ``kernels`` line's.
14. sf2     — SF2 sample playback on ``cuda``. A GM-scale font built with
              the port's ``build_sf2`` (``build_gm_font``: 128 programs x 2
              key splits x 2 velocity layers of stereo pairs, 1,024 looped
              samples of 20,000 frames, a 20.5 M-sample bank past 2^24;
              every program sends to reverb and chorus, a quarter set the
              static filter, a quarter the LFOs, an eighth the mod-env pitch
              and filter sweep, one an exclusive class). The eight fixture
              cases of ``tests/test_sf2_goldens.py`` (``SF2_CASES``) on the
              card vs the CPU port (atol 2e-5, 1e-4 where an FFT runs,
              samples past it <= 1e-4 of the clip) and a card repeat
              bitwise. ``GenerationService(model="gandes", sound_font=...)``
              at serve width: a warmup, n = 4 requests (``latency_s``, K2
              launches == 4), one request with each render timed (voices,
              L, W, toggles, seconds), the busy share and top device ops of
              one request and of its slowest render (``sf2_profile``); the
              same 4 generator clips through ``matrix_to_wav`` on the card
              and on the CPU (sims ending by customer count): mels 0.05 dB
              above the floor, 0.5 dB on every bin; ``matrix_to_wav(
              parallel=4)``; ``sim-to-wav --sound-font`` through
              ``cli.main``; ``train-gandes --sound-font`` at
              ``GanDesConfig()`` width (B = 30, 2 steps, ``--des-parallel
              16``) over phase 11's corpus: every fake clip and real file
              rendered by the font, K2 launches == fake clips + real slices.
              K2's launches of these paths are added to the ``kernels``
              line's. ``python3 chip_smoke.py --only sf2`` runs the device,
              build and sf2 phases alone (``--only mesh``: device, build,
              pickle and mesh; ``--only examples``: device, build and
              examples).
15. train_bf16 — ``compute_dtype='bf16'`` at full width on ``cuda``.
              MM-GAN (B = 16, ``des_parallel=16``, phase ``pickle``'s
              windows): ``none`` 2 epochs of 3 batches + 1 resumed against 3
              straight (bitwise), float32 ``none`` beside it, one epoch each
              of ``surrogate`` (every knob) and ``reinforce``, the decode path
              each run took, the bf16 checkpoint resumed by a float32 run;
              captured == eager (G forward and direct step) bitwise over 3
              steps. GAN-DES (B = 30, phase ``train_gandes``'s corpus): 2
              bf16 steps (K2 == fake clips + real slices), 2 float32 steps,
              the bf16 checkpoint resumed by a float32 run. Both: every
              param, Adam moment and BatchNorm statistic float32; the product
              and convolution kernels of one eager step from a torch.profiler
              trace (bf16 ones named); one step of each mode card vs the CPU
              port (losses within 2^-8, the loss term of
              ``tests/test_torch_bf16.py``'s budget; reinforce's G loss,
              which cancels logprobs of ~-2,000, printed); ``device_step``
              p50, the busy share of one loop step and the device work of
              one eager step of each mode (after two warm-ups), bf16 beside
              float32.
16. trace   — ``train-gandes --trace-dir`` (one step, B = 30) and
              ``train-mmgan --trace-dir`` (one batch) through ``cli.main``:
              each Chrome trace names the step's cuDNN kernels, the GAN-DES
              one ``mel_power`` too.
17. doctor  — ``python -m gandes_tpu_torch.cli doctor`` in its own process:
              exit 0, every row ``ok``, K1 and K2 through their kernels.
18. generate_gandes — ``cli.generate_gandes`` on phase ``train_gandes``'s
              checkpoint, n = 4: 4 WAVs, K2 4 times, finite (4, 128, 216)
              mels; then ``generate-gandes`` through ``cli.main``: with
              matplotlib ``spectrogram.png``, without it a non-zero exit
              naming matplotlib after the 4 WAVs.

19. composite — ``MultiModalGAN(...).to("cuda")`` with ``decode=None``:
              a train-mode forward (B = 3) through its own ``matrix_to_midi``
              gives finite (3, 1) logits and a failed count (a CPU copy's
              printed beside), ``generate_midi`` writes ``generation.mid``;
              ``SimNN`` on the card vs the CPU (atol 1e-4).
20. bench   — ``python -m gandes_tpu_torch.cli bench --all`` in its own
              process (``GANDES_BENCH_DEADLINE_S=240``): rc 0, no row
              failed or skipped, every metric of ``BENCH_METRICS`` finite,
              the headline last; its rows printed with the card's name and
              power limit. The run's own launch counts (its ``# launches``
              note on stderr): K2 and K1 launched, their launches added to
              the ``kernels`` line's.
21. demo    — ``python -m gandes_tpu_torch.demo --out OUT`` in its own
              process: rc 0, the preset WAVs, ``generation.mid`` (MThd),
              ``generation.wav`` (RIFF), the plots (or, without
              matplotlib, each named as skipped).
22. mesh    — the (dp, tp) training mesh (``gandes_tpu_torch/parallel``) on
              the one card: every rank shares ``cuda:0``, so the ranks run
              over gloo with CUDA tensors (the backend rule), and the times
              are overhead, not scaling. MM-GAN at ``MMGANConfig()`` width,
              B = 16, ``des_parallel=16``, mesh (2, 2) (four ranks: this
              process and three spawned): 3 batches of ``none`` and one
              epoch of ``surrogate`` capped at 3 batches, each beside the
              same run on one device, whose host-stage rolls rank 0 replays
              (a last-bit difference in G's outputs changes a decoded
              roll); the largest gaps of the ``disc`` / ``gen`` histories
              (rtol 1e-3) and of D's params (at most 1e-3 of them more than
              1e-4 apart, none more than 4 lr per step); G's outputs at
              each host stage against the one-device run's (the first,
              before any G update, within 2e-4) and G's param gaps. In
              float32 the ``surrogate`` G drifts apart step by step (Adam
              at lr 0.01 steps each element whose gradient is within
              rounding of zero by anything in [-lr, lr]), so the same
              surrogate step runs again in float64 on the card, 3 steps
              over (2, 2) against one device: G's outputs at every step
              and the params within 1e-9, G's first moments at rtol 1e-7.
              The times come from a third (2, 2) ``none`` run whose rank 0
              runs the DES itself: per rank its backend, device, steps/s
              and the p50 of ``host_des`` / ``device_step``.
              GAN-DES at ``GanDesConfig()`` width, B = 30,
              mesh (2, 1), 2 steps: K2's launches on rank 0 (30 fake clips
              per step and the real slices), counts set to 0 just before and
              read just after. A (1, 1) mesh, one step: the ``nccl``
              backend on the card. The fused step with
              ``callback_device=mesh`` under (2, 1): bitwise the sharded
              two-phase step.
23. examples — the four harnesses of ``gandes_tpu_torch/examples`` through
              their ``run(...)`` on ``cuda``, each one's stdout kept in a log
              and its result line printed: ``ingest_bench`` at the JAX
              harness's defaults (200 files of 6 concatenated sim pieces,
              ``workers`` = the CPU count): the three pickles identical (the
              harness raises otherwise), K1 ceil(files / 8) times in each
              fast mode and never in the sequential one;
              ``train_surrogate_demo`` at ``24 24 surrogate 1e-4`` (144
              steps): finite losses, both gaps, the failed sims of the eval
              and of training; ``train_gandes_demo`` at 16 nets, ``reinforce``
              lr 1e-3, d_lr 1e-5, B = 16, steps cut to 16: K2's launches
              (counter set to 0 just before, read just after) equal to the
              real slices (eval pool and training set) plus the clips,
              counted apart from the kernel; ``ref_schedule_run`` on one
              256-net chunk (~1,100 windows), 32 steps an epoch, epoch 1 and
              then a call to epoch 2 that resumes from the epoch-1 checkpoint:
              s/step and the DONE lines. Then K1 bitwise against its plain
              version at the ingest's densest 8-file launch, and K2 against
              its plain version (the phase ``kernel`` tolerances) on one
              training clip of the GAN-DES demo, each timed as phase
              ``kernel`` times it. ``python3 chip_smoke.py --only examples``
              runs the device, build and examples phases alone.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Bounds use the H100 SXM's published
peaks: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

import base64
import glob
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

DEVICE = "cuda"
SHORT_WAVES = (300, 900, 1024, 1025)
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=5, reps=30) -> float:
    """Median device time of ``fn`` in ms, each run between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, kernel_name, warmup=5, reps=30) -> tuple[float, int]:
    """The kernel's own device time per launch in ms, and the launches it
    is taken over: the device time of the CUDA events named ``kernel_name``
    in a torch.profiler trace of ``reps`` calls of ``fn``, summed and divided
    by their count. The trace may drop events (it once kept 11 of 30 on the
    H100), so the count may fall short of ``reps``; a trace that keeps fewer
    than half is taken again, up to three traces. The count may not exceed
    ``reps`` (one launch per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and kernel_name in ev.name]
        counts.append(len(events))
        if len(events) > reps:
            break
        if len(events) >= reps // 2:
            return (sum(ev.time_range.end - ev.time_range.start for ev in events) / 1e3
                    / len(events), len(events))
    raise AssertionError(f"{kernel_name}: {counts} device events in the traces of {reps} calls")


def mel_bound_ms(n_samples, hop, n_frames, fb_nonzeros, n_fft=2048, n_mels=128
                 ) -> tuple[float, str]:
    """Least time for one mel power call, from the least work of the
    function: per frame the window (n_fft products), a real FFT
    (~2.5 n_fft log2 n_fft operations), the power (3 per bin) and the
    filterbank's nonzeros (a multiply-add each), over the f32 peak; against
    the wave samples the frames read (all of them when frames overlap, only
    the framed ones when hop >= n_fft), the filterbank's nonzeros and the
    output, over the HBM rate."""
    n_freqs = n_fft // 2 + 1
    per_frame = n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * fb_nonzeros
    ops = n_frames * per_frame
    samples = min(n_samples, n_frames * n_fft) if hop >= n_fft else n_samples
    nbytes = 4 * samples + 4 * fb_nonzeros + 4 * n_mels * n_frames
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def phase_build():
    from gandes_tpu_torch.des import native
    from gandes_tpu_torch.ops import mel_power, roll_rasterize

    t0 = time.perf_counter()
    results, seconds, errors = {}, {}, {}

    def build(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # re-raised below, after every build ended
            errors[name] = e
        seconds[name] = round(time.perf_counter() - t0, 2)

    threads = [threading.Thread(target=build, args=a) for a in (
        ("des", native.native_available), ("mel_power", mel_power.kernel),
        ("roll_rasterize", roll_rasterize.kernel))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")
    emit({"phase": "build", "seconds": seconds, "all_s": round(time.perf_counter() - t0, 2),
          "native_des": results["des"],
          "ptxas": {k: _ptxas(results[k].build_log) for k in ("mel_power", "roll_rasterize")}})
    if not results["des"]:
        raise RuntimeError("native DES core failed to build (g++)")


def _mel_row(label, wav, hop, htk=True, slaney=False, sr=44100, n_fft=2048):
    """K2 against its plain version on the card wave ``wav`` at ``hop``:
    rtol 2e-3 / atol 1e-4 in power, 0.05 dB after ``amplitude_to_db_torch``,
    two launches bitwise equal; event, device, plain and (above the 1,024-
    sample reflect pad torch.stft refuses) library times, and the bound."""
    import torch

    from gandes_tpu_torch.music.mel import amplitude_to_db_torch, mel_filterbank
    from gandes_tpu_torch.ops.mel_power import kernel, mel_power_cuda, mel_power_reference

    n = int(wav.shape[0])
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=128, fmin=20, fmax=8300, htk=htk,
              norm_slaney=slaney)
    ref = mel_power_reference(wav, sr, **kw)
    out = mel_power_cuda(wav, sr, **kw)
    repeat_equal = bool(torch.equal(out, mel_power_cuda(wav, sr, **kw)))
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    err = (out - ref).abs()
    ok_power = bool(torch.all(err <= 1e-4 + 2e-3 * ref.abs()))
    db_err = float((amplitude_to_db_torch(out) - amplitude_to_db_torch(ref)).abs().max())
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, 128, 20, 8300, htk, slaney)).cuda()
    window = torch.hann_window(n_fft, periodic=True, device="cuda")

    def library():
        spec = torch.stft(wav, n_fft, hop, window=window, center=True, pad_mode="reflect",
                          return_complex=True)
        return fb @ spec.abs().square()

    ms = cuda_ms(lambda: mel_power_cuda(wav, sr, **kw))
    kernel_ms, traced = device_ms(lambda: mel_power_cuda(wav, sr, **kw), "mel_power_kernel")
    plain_ms = cuda_ms(lambda: mel_power_reference(wav, sr, **kw))
    # torch.stft's reflect pad refuses a pad as long as the wave
    library_ms = cuda_ms(library) if n > n_fft // 2 else None
    frames = int(out.shape[1])
    # the device memory K2's constants hold for this n_fft and filterbank
    k = kernel()
    consts = (*k.tables(n_fft, wav.device),
              *k.filterbank(sr, n_fft, 128, 20, 8300, htk, slaney, wav.device)[:2])
    bound_ms, bound_by = mel_bound_ms(n, hop, frames, int(torch.count_nonzero(fb)), n_fft, 128)
    return {"name": "mel_power", "case": label, "samples": n, "hop": hop,
            "frames": frames, "max_abs_err": float(err.max()),
            "max_rel_err": float((err / ref.abs().clamp(min=1e-30)).max()),
            "db_err": db_err, "repeat_equal": repeat_equal,
            "ok": ok_power and db_err <= 0.05 and repeat_equal, "ms": ms,
            "device_ms": kernel_ms, "traced_launches": traced, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "below_library": None if library_ms is None else ms < library_ms,
            "constants_bytes": sum(t.numel() * t.element_size() for t in consts)}


def phase_kernel():
    import numpy as np
    import torch

    from gandes_tpu_torch.music.mel import melspectrogram_db_tensor

    sr = 44100
    # (label, samples, hop, htk, norm_slaney): the fixed-hop cases of the
    # JAX package's kernel tests, the blank clip's slaney variant, and the
    # serve path's dynamic hop len // 215 at pow2 buckets up to the synth's
    # 190 s timeline cap (2^23 samples)
    # hop1025 is GAN-DES training's real 5 s slice (220500 samples, hop
    # 220500 // 215, 216 frames)
    cases = [("hop512", 44100, 512, True, False), ("hop1025", 220500, 1025, True, False),
             ("hop220", 44100, 220, True, False), ("blank_slaney", 220500, 512, False, True)]
    cases += [(f"serve_2^{p}", 1 << p, (1 << p) // 215, True, False) for p in (18, 20, 22, 23)]
    # waves shorter than the n_fft / 2 reflect pad at melspectrogram_db_tensor's
    # dynamic hop: the kernel folds the reflection again and again
    cases += [(f"short_{n}", n, n // 215, True, False) for n in SHORT_WAVES]
    rng = np.random.RandomState(0)
    rows = []
    for label, n, hop, htk, slaney in cases:
        t = np.arange(n) / sr
        wav_np = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)
        wav = torch.from_numpy(wav_np).cuda()
        row = {"phase": "kernel", **_mel_row(label, wav, hop, htk, slaney)}
        if label.startswith("short_"):
            # melspectrogram_db_tensor of the same wave (cropped to 216 hops)
            # on the card vs on the CPU
            db = melspectrogram_db_tensor(wav)
            gap = float((db.cpu() - melspectrogram_db_tensor(wav.cpu())).abs().max())
            row.update(db_tensor_shape=list(db.shape), db_tensor_gap=gap)
            row["ok"] = row["ok"] and row["db_tensor_shape"] == [128, 217] and gap <= 0.05
        emit(row)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"mel_power {label}: kernel disagrees with its plain version "
                                 f"or with itself")
    return rows


def roll_bound_ms(notes, T) -> tuple[float, str]:
    """Least time for one rasterizer call on these events, over the HBM
    rate: every note read once (4 B a slot; the notes set each sample's trip
    count), the other three int32 fields of each slot up to the trip count
    (the last valid index + 1; the pad tail past it needs no more), and each
    roll cell written once (f32). Its few integer operations per event and
    cell are far below the card's rate."""
    import numpy as np

    B, E = notes.shape
    valid = notes >= 0
    trips = np.where(valid.any(axis=1), E - np.argmax(valid[:, ::-1], axis=1), 0)
    nbytes = 4 * B * E + 12 * int(trips.sum()) + 4 * B * 2 * 128 * T
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes"


def _roll_events(B, E, T, start, seed, pad_from=None, pitch=None):
    """tests/test_pallas_roll.py's generator (notes in [-1, 128), ons past
    the crop on both sides, spans of -2..19 steps, velocities from -1);
    ``pitch`` sets every valid note to one pitch."""
    import numpy as np

    rng = np.random.RandomState(seed)
    notes = rng.randint(-1, 128, (B, E)).astype(np.int32)
    if pitch is not None:
        notes[notes >= 0] = pitch
    if pad_from is not None:
        notes[:, pad_from:] = -1
    ons = rng.randint(0, T + start + 10, (B, E)).astype(np.int32)
    offs = (ons + rng.randint(-2, 20, (B, E))).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    return notes, ons, offs, vels


def _midi_order_events(n_files=8, sample_size=300):
    """The events of the first ``n_files`` files of phase ``pickle``'s
    corpus (the same seed), padded as the pickler pads one launch's files:
    MIDI order, onsets non-decreasing, per-file pad tails."""
    from gandes_tpu_torch.data.datasets import _extract_file_events, pad_file_events

    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(tmp, n_files=n_files)
        files = sorted(glob.glob(os.path.join(tmp, "**", "*.mid*"), recursive=True))
        return pad_file_events([_extract_file_events((f, sample_size, 50)) for f in files])


def _roll_row(label, events, T, start, timed):
    """K1 against its plain version on the numpy events ``(notes, ons, offs,
    vels)``: bitwise (``torch.equal``), two launches bitwise equal; with
    ``timed`` the event, device and plain times and the bound."""
    import numpy as np
    import torch

    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda, rasterize_events_reference

    ev = [torch.from_numpy(a).cuda() for a in events]
    B, E = ev[0].shape
    out = rasterize_cuda(*ev, num_steps=T, start=start)
    again = rasterize_cuda(*ev, num_steps=T, start=start)
    ref = rasterize_events_reference(*ev, num_steps=T, start=start)
    torch.cuda.synchronize()
    valid = events[0] >= 0
    row = {"name": "roll_rasterize", "case": label, "B": B, "E": E, "T": T, "start": start,
           "equal": bool(torch.equal(out, ref)), "repeat_equal": bool(torch.equal(out, again)),
           "max_abs_err": float((out - ref).abs().max()), "cells_set": int(ref.count_nonzero()),
           "valid_events": int(valid.sum()),
           "ons_sorted": bool(all((np.diff(o[v]) >= 0).all()
                                  for o, v in zip(events[1], valid)))}
    if timed:
        row["ms"] = cuda_ms(lambda: rasterize_cuda(*ev, num_steps=T, start=start))
        row["device_ms"], row["traced_launches"] = device_ms(
            lambda: rasterize_cuda(*ev, num_steps=T, start=start), "roll_rasterize_kernel")
        row["plain_ms"] = cuda_ms(lambda: rasterize_events_reference(
            *ev, num_steps=T, start=start))
        row["bound_ms"], row["bound_by"] = roll_bound_ms(events[0], T)
        row["library_ms"] = None
    return row


def phase_kernel_roll():
    import numpy as np

    last_writer = (np.array([[60, 60, 60, 60, 64, 64]], np.int32),
                   np.array([[10, 10, 10, 10, 5, 5]], np.int32),
                   np.array([[30, 20, 15, 12, 40, 8]], np.int32),
                   np.array([[100, 90, 0, -1, 70, 0]], np.int32))
    # (label, events, T, start, timed): tests/test_pallas_roll.py's shapes,
    # then the pickler's, a dense one, a roll of four column tiles, a file
    # whose every note is one pitch (the skewed case), the pickler's own
    # events for one launch (MIDI order) and the bench's events
    cases = [("jax_3x32", _roll_events(3, 32, 50, 5, 0), 50, 5, False),
             ("jax_2x128", _roll_events(2, 128, 50, 100, 1), 50, 100, False),
             ("jax_1x16", _roll_events(1, 16, 96, 0, 2), 96, 0, False),
             ("last_writer", last_writer, 50, 0, False),
             ("pad_tail", _roll_events(4, 256, 50, 0, 3, pad_from=37), 50, 0, False),
             ("pickler", _roll_events(8, 4096, 300, 0, 4), 300, 0, True),
             ("dense", _roll_events(8, 16384, 300, 0, 5), 300, 0, True),
             ("long_roll", _roll_events(2, 4096, 2000, 0, 6), 2000, 0, True),
             ("one_pitch", _roll_events(8, 4096, 300, 0, 7, pitch=60), 300, 0, True),
             ("midi_order", _midi_order_events(), 300, 0, True),
             # bench --all's piano_roll row: the bench draws these very
             # events (RandomState(0), ons below T + start + 10)
             ("bench_roll", _roll_events(16, 512, 50, 100, 0), 50, 100, True)]
    rows = []
    for label, events, T, start, timed in cases:
        row = {"phase": "kernel", **_roll_row(label, events, T, start, timed)}
        emit(row)
        rows.append(row)
        if not (row["equal"] and row["repeat_equal"]):
            raise AssertionError(f"roll_rasterize {label}: kernel disagrees with its plain version "
                                 f"or with itself")
    return rows


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def phase_serve():
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.serve import GenerationService, make_http_server

    mel_power_cuda.launches = 0
    t0 = time.perf_counter()
    service = GenerationService(model="gandes", device=DEVICE)
    service.generate(n=1, seed=0)  # warmup: first launches, first DES run
    warmup_s = time.perf_counter() - t0
    server = make_http_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        replies = []
        for seed in (0, 1, 0):
            t = time.perf_counter()
            out = _post(base + "/generate/gandes", {"n": 4, "seed": seed})
            out["wall_s"] = time.perf_counter() - t
            replies.append(out)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = {"mel_power": mel_power_cuda.launches}

    for out in replies:
        if out["mel_shape"] != [4, 128, 216]:
            raise AssertionError(f"mel_shape {out['mel_shape']}")
        for b64 in out["wav_b64"]:
            if base64.b64decode(b64)[:4] != b"RIFF":
                raise AssertionError("reply is not a RIFF WAV")
    if replies[0]["wav_b64"] != replies[2]["wav_b64"]:
        raise AssertionError("seed 0 gave different WAV bytes on repeat")
    if replies[0]["wav_b64"] == replies[1]["wav_b64"]:
        raise AssertionError("seeds 0 and 1 gave the same WAVs")
    if health.get("status") != "ok" or health.get("requests") != 4:
        raise AssertionError(f"healthz {health}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the serve path never launched: {launches}")
    emit({"phase": "serve", "warmup_s": round(warmup_s, 3),
          "latency_s": [r["latency_s"] for r in replies],
          "wall_s": [round(r["wall_s"], 4) for r in replies], "samples_per_request": 4,
          "launches": launches, "healthz": health})
    profile_request(service)
    return launches


def device_busy(fn):
    """Run ``fn`` under torch.profiler and return the device busy share: the
    union of the device-side event intervals (kernels, copies, memsets; the
    host-side aten ops that launched them are left out, so no device time
    counts twice; so are user annotations such as
    ``Optimizer.step#Adam.step``, whose device-side range spans the gaps
    between its kernels) over ``fn``'s host wall time, and the device events
    that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        _sync()
        wall_ms = 1e3 * (time.perf_counter() - t)
    device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    annotations = [ev for ev in device if ev.is_user_annotation]
    device = [ev for ev in device if not ev.is_user_annotation]
    busy_us, end = 0.0, -math.inf
    for ev in sorted(device, key=lambda e: e.time_range.start):
        start, stop = ev.time_range.start, ev.time_range.end
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict[str, list] = {}
    for ev in device:
        acc = by_name.setdefault(ev.name, [0.0, 0])
        acc[0] += ev.time_range.end - ev.time_range.start
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    busy_ms = busy_us / 1e3
    if not device:
        raise AssertionError("the profiled call shows no device-side event")
    return {"wall_ms": round(wall_ms, 3), "device_events": len(device),
            "annotations_skipped": sorted({ev.name for ev in annotations}),
            "device_busy_ms": round(busy_ms, 3), "device_busy_share": round(busy_ms / wall_ms, 4),
            "top": [{"name": k[:80], "ms": round(us / 1e3, 3), "count": c}
                    for k, (us, c) in top]}


def profile_request(service):
    """Device busy share of one more request (n=4, seed 2)."""
    emit({"phase": "profile", **device_busy(lambda: service.generate(n=4, seed=2))})


def phase_slice():
    import numpy as np
    import torch
    from scipy.io import wavfile

    from gandes_tpu_torch.bridge.gandes_decode import (
        _decode_gandes_sample,
        _mel_from_device_audio,
        matrix_to_wav,
    )
    from gandes_tpu_torch.des.engine import Sim
    from gandes_tpu_torch.music.generators import process_adjsim_log_v1
    from gandes_tpu_torch.music.mel import melspectrogram_db_tensor
    from gandes_tpu_torch.music.synth import _pow2, render_midi
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig
    from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

    mats = np.random.RandomState(3).rand(2, 20, 20).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for dev in (DEVICE, "cpu"):
            d = os.path.join(tmp, dev)
            np.random.seed(0)
            spec = matrix_to_wav(mats, size=20, start=0, end=216, out_dir=d,
                                 log_path=os.path.join(d, "logs/"), max_sim_time=60, device=dev)
            with open(os.path.join(d, "midi", "output.mid"), "rb") as f:
                midi = f.read()
            wavs = [wavfile.read(os.path.join(d, "wav", f"output_{i}.wav"))[1] for i in range(2)]
            outs[dev] = (spec.cpu(), midi, wavs)
        spec, midi, wavs = outs[DEVICE]
        if tuple(spec.shape) != (2, 128, 216) or not bool(torch.isfinite(spec).all()):
            raise AssertionError(f"cuda spectrogram {tuple(spec.shape)} not finite/shaped")
        if midi != outs["cpu"][1]:
            raise AssertionError("MIDI bytes differ between cuda and cpu")
        lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
                  for a, b in zip(wavs, outs["cpu"][2]))
        db_err = 0.0
        for i, w in enumerate(wavs):  # plain CPU mel of the card's own samples
            q = np.zeros(_pow2(len(w)), np.float32)
            q[: len(w)] = w.astype(np.float32) / 32768.0
            ref = melspectrogram_db_tensor(torch.from_numpy(q))[:, :216]
            db_err = max(db_err, float((spec[i] - ref).abs().max()))
        if db_err > 0.05:
            raise AssertionError(f"cuda mel differs from the plain mel by {db_err} dB")

        # per-stage host-clock breakdown of one request's 4 samples (seed 0)
        gen, _ = load_gandes_state(GanDesConfig(), device=DEVICE)
        g = torch.Generator(device=DEVICE).manual_seed(0)
        _sync()
        t = time.perf_counter()
        m = gandes_eval_forward(gen)(torch.randn(4, 100, generator=g, device=DEVICE)).cpu().numpy()
        stages = {"generator_s": time.perf_counter() - t, "decode_des_midi_s": 0.0,
                  "synth_s": 0.0, "wav_write_s": 0.0, "mel_s": 0.0}
        np.random.seed(0)
        for i, mat in enumerate(m):
            t = time.perf_counter()
            sim_matrix, dists, instruments, note_levels = _decode_gandes_sample(mat, 20, 5, None)
            np.random.seed(np.random.randint(0, 99999, size=1))
            seeds = np.random.randint(0, 99999, size=1)
            sim = Sim(sim_matrix, dists, [254] * 15, seeds=seeds, log_path=os.path.join(tmp, "l/"),
                      generate_log=True, record_history=False, logging_mode="Music",
                      max_sim_time=0.5)
            sim.run(number_of_customers=1000)
            _, mid = process_adjsim_log_v1(instruments=instruments, note_levels=note_levels,
                                           lines=sim.music_lines(),
                                           out_path=os.path.join(tmp, "b", "output.mid"),
                                           return_mid=True)
            stages["decode_des_midi_s"] += time.perf_counter() - t
            t = time.perf_counter()
            audio, true_len = render_midi(mid, as_tensor=True, device=DEVICE)
            _sync()
            stages["synth_s"] += time.perf_counter() - t
            t = time.perf_counter()
            wavfile.write(os.path.join(tmp, f"b{i}.wav"), 44100,
                          (audio[:true_len].clamp(-1, 1).cpu().numpy() * 32767.0).astype(np.int16))
            stages["wav_write_s"] += time.perf_counter() - t
            t = time.perf_counter()
            _mel_from_device_audio(audio, 44100)
            _sync()
            stages["mel_s"] += time.perf_counter() - t
    emit({"phase": "slice", "shape": list(spec.shape), "midi_equal_cpu": True,
          "wav_max_lsb_vs_cpu": lsb, "mel_db_err_vs_plain": db_err,
          "breakdown_4_samples_s": {k: round(v, 4) for k, v in stages.items()}})


def write_corpus(root, n_files=256, seconds=330.0, rate=10.0, seed=0):
    """Synthetic MAESTRO-density corpus written with the port's MIDI writer:
    MAESTRO v3.0.0 holds ~7 M notes over ~200 h (~10 notes/s), so each file
    is ``seconds`` of Poisson onsets at ``rate``, piano pitches around middle
    C, velocities 30-110 and log-normal durations, one track at 480 ticks
    per beat and 120 bpm. Returns the total bytes written."""
    import numpy as np

    from gandes_tpu_torch.music.midi import Message, MetaMessage, MidiFile, MidiTrack

    rng = np.random.RandomState(seed)
    tpb, tempo = 480, 500000
    total = 0
    os.makedirs(os.path.join(root, "2004"), exist_ok=True)
    for f in range(n_files):
        n = rng.poisson(rate * seconds)
        on = np.sort(rng.uniform(0.0, seconds, n))
        dur = np.minimum(rng.lognormal(np.log(0.25), 0.8, n), 4.0)
        pitch = np.clip(np.round(rng.normal(64, 12, n)), 21, 108).astype(int)
        vel = rng.randint(30, 111, n)
        ticks = np.round(np.concatenate([on, on + dur]) * tpb * 1e6 / tempo).astype(np.int64)
        is_on = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
        track = MidiTrack()
        track.append(MetaMessage("set_tempo", tempo=tempo, time=0))
        prev = 0
        for k in np.lexsort((is_on, ticks)):  # at equal ticks, offs before ons
            i = k % n
            kind, v = ("note_on", int(vel[i])) if is_on[k] else ("note_off", 0)
            track.append(Message(kind, note=int(pitch[i]), velocity=v, time=int(ticks[k] - prev)))
            prev = ticks[k]
        mid = MidiFile(ticks_per_beat=tpb)
        mid.tracks.append(track)
        path = os.path.join(root, "2004", f"synthetic_{f:04d}.midi")
        mid.save(path)
        total += os.path.getsize(path)
    return total


def _windows_digest(path):
    import pickle

    import numpy as np

    with open(path, "rb") as f:
        windows = pickle.load(f)
    h = hashlib.sha256()
    for window in windows:
        for a in window:
            h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return len(windows), h.hexdigest()


def phase_pickle(work_dir):
    """Returns K1's launches; leaves the device path's windows in
    ``work_dir/windows.pkl`` for phase ``train_mmgan``."""
    from gandes_tpu_torch.data.datasets import (
        _extract_file_events,
        _rasterize_file_batch,
        build_window_pickle,
    )
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "maestro")
        t = time.perf_counter()
        corpus_bytes = write_corpus(root)
        write_s = time.perf_counter() - t
        files = sorted(glob.glob(os.path.join(root, "**", "*.mid*"), recursive=True))

        rasterize_cuda.launches = 0
        t = time.perf_counter()
        windows = os.path.join(work_dir, "windows.pkl")
        n_dev = build_window_pickle(root, windows, sample_size=300,
                                    sequence_length=50, device_rasterize=True, device=DEVICE)
        _sync()
        device_s = time.perf_counter() - t
        launches = rasterize_cuda.launches

        t = time.perf_counter()
        n_host = build_window_pickle(root, os.path.join(tmp, "host.pkl"), sample_size=300,
                                     sequence_length=50)
        host_s = time.perf_counter() - t
        dev_digest = _windows_digest(windows)
        host_digest = _windows_digest(os.path.join(tmp, "host.pkl"))

        # breakdown of the device path: parse (host) vs rasterize (K1 + copies)
        t = time.perf_counter()
        extracted = [_extract_file_events((f, 300, 50)) for f in files]
        parse_s = time.perf_counter() - t
        t = time.perf_counter()
        rolls = list(_rasterize_file_batch(extracted, 300, device=DEVICE))
        _sync()
        rasterize_s = time.perf_counter() - t
    events = [len(e[0]) for e in extracted]
    emit({"phase": "pickle", "files": len(files), "corpus_bytes": corpus_bytes,
          "write_s": round(write_s, 3), "windows": n_dev, "launches": {"roll_rasterize": launches},
          "device_path_s": round(device_s, 3), "host_path_s": round(host_s, 3),
          "device_files_per_s": round(len(files) / device_s, 2),
          "device_mb_per_s": round(corpus_bytes / 1e6 / device_s, 3),
          "host_files_per_s": round(len(files) / host_s, 2),
          "host_mb_per_s": round(corpus_bytes / 1e6 / host_s, 3),
          "breakdown_s": {"parse": round(parse_s, 3), "rasterize": round(rasterize_s, 4)},
          "events_per_file": {"min": min(events), "max": max(events),
                              "mean": round(sum(events) / len(events), 1)},
          "rolls": len(rolls), "sha256": dev_digest[1]})
    if (n_dev, dev_digest) != (n_host, host_digest) or n_dev != dev_digest[0] or n_dev == 0:
        raise AssertionError(f"device pickle {n_dev} {dev_digest} != host {n_host} {host_digest}")
    if launches <= 0:
        raise AssertionError("the pickler's device path never launched roll_rasterize")
    return launches


def phase_serve_mmgan():
    import numpy as np

    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda
    from gandes_tpu_torch.serve import GenerationService, make_http_server
    from gandes_tpu_torch.train.mmgan_loop import eval_forward

    mel_power_cuda.launches = rasterize_cuda.launches = 0
    t0 = time.perf_counter()
    service = GenerationService(model="mmgan", device=DEVICE)
    service.generate(n=1, seed=0)  # warmup
    warmup_s = time.perf_counter() - t0
    server = make_http_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        replies = []
        for seed in (0, 1, 0):
            t = time.perf_counter()
            out = _post(base + "/generate/mmgan", {"n": 4, "seed": seed})
            out["wall_s"] = time.perf_counter() - t
            replies.append(out)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = {"mel_power": mel_power_cuda.launches, "roll_rasterize": rasterize_cuda.launches}

    failed = [[m is None for m in r["midi_b64"]] for r in replies]
    for r in replies:
        if len(r["midi_b64"]) != 4 or r["failed"] != r["midi_b64"].count(None):
            raise AssertionError(f"reply slots {r['midi_b64']!r:.200} failed={r['failed']}")
        for m in r["midi_b64"]:
            if m is not None and base64.b64decode(m)[:4] != b"MThd":
                raise AssertionError("reply is not a MIDI file")
    a, b, again = (r["midi_b64"] for r in replies)
    repeat_equal = [x == y for x, y in zip(a, again) if x is not None and y is not None]
    if not all(repeat_equal):
        raise AssertionError("seed 0 gave different MIDI bytes on repeat")
    songs_0, songs_1 = {m for m in a if m}, {m for m in b if m}
    if not songs_0 or not songs_1 or songs_0 & songs_1:
        raise AssertionError("seeds 0 and 1 did not give different songs")
    if health.get("status") != "ok" or health.get("requests") != 4:
        raise AssertionError(f"healthz {health}")

    # G1/G2 on the card vs a CPU copy, and each reply's MIDI vs the host
    # decode of the card's generator outputs (same noise, same routing seed)
    cfg, model = service.cfg, service.mmgan
    cpu_model = GenerationService(model="mmgan", device="cpu").mmgan
    rng = np.random.RandomState(0)
    g_err, decoded_equal = 0.0, []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(4):
            noise1, noise2 = (rng.randn(1, cfg.noise_dim).astype(np.float32) for _ in range(2))
            beats = np.zeros((1, cfg.max_beat_length), np.float32)
            o1, o2 = (x.cpu().numpy() for x in eval_forward(model, noise1, noise2, beats))
            c1, c2 = (x.numpy() for x in eval_forward(cpu_model, noise1, noise2, beats))
            g_err = max(g_err, float(np.abs(o1 - c1).max()), float(np.abs(o2 - c2).max()))
            np.random.seed(i)
            out_dir = os.path.join(tmp, str(i))
            matrix_to_midi(o1[:, None], o2, adj_size=cfg.adj_size, instrument=cfg.instrument,
                           start=cfg.start, end=cfg.start + cfg.sequence_length,
                           generate=True, log_path=os.path.join(tmp, "logs/"), out_dir=out_dir)
            path = os.path.join(out_dir, "generation.mid")
            if a[i] is not None and os.path.exists(path):
                with open(path, "rb") as f:
                    decoded_equal.append(f.read() == base64.b64decode(a[i]))
    emit({"phase": "serve_mmgan", "warmup_s": round(warmup_s, 3),
          "latency_s": [r["latency_s"] for r in replies],
          "wall_s": [round(r["wall_s"], 4) for r in replies], "samples_per_request": 4,
          "failed_slots": failed, "repeat_equal": repeat_equal, "g_cuda_vs_cpu_max_err": g_err,
          "decoded_equal": decoded_equal, "launches": launches, "healthz": health})
    if g_err > 1e-5:
        raise AssertionError(f"G1/G2 on the card differ from the CPU by {g_err}")
    if not decoded_equal or not all(decoded_equal):
        raise AssertionError(f"replies differ from the host decode of the card's G: {decoded_equal}")


def _top_host_ops(fn, n=8):
    """The host-side ops with the most self CPU time in a torch.profiler
    trace of ``fn`` (ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        _sync()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:n]
    return [{"name": e.key[:60], "self_ms": round(e.self_cpu_time_total / 1e3, 3),
             "count": e.count} for e in rows]


def _tensors_equal(a, b) -> bool:
    """Nested state dicts (tensors, lists, numbers) equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


def _states_equal(a, b) -> bool:
    return (_tensors_equal(a.model.state_dict(), b.model.state_dict())
            and _tensors_equal(a.g_opt.state_dict(), b.g_opt.state_dict())
            and _tensors_equal(a.d_opt.state_dict(), b.d_opt.state_dict()) and a.step == b.step)


def _two_pass_batchnorm(self, x, update_stats=True):
    """``FlaxBatchNorm1d``'s train-mode normalisation with a two-pass
    variance, mean((x - mean)^2), in place of flax's E[x^2] - E[x]^2; the
    running statistics are left alone."""
    import torch

    mean = x.mean(0)
    var = (x - mean).pow(2).mean(0)
    return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _named_grads(state, group):
    """(name, gradient) of D's (``group`` "d") or G1's then G2's ("g")
    parameters: G's in the order of G's Adam."""
    modules = ("discriminator",) if group == "d" else ("generator1", "generator2")
    return [(f"{m}.{n}", p.grad) for m in modules
            for n, p in getattr(state.model, m).named_parameters()]


def _grad_err(named, named_ref, rtol=1e-4) -> dict:
    """Largest |g - ref| over rtol * (|ref| + the tensor's largest |ref|)
    across a group's gradients (<= 1 passes): rtol 1e-4 against each
    element, with an absolute floor of rtol times the tensor's largest
    element for elements that cancel to near zero. The Linear biases that
    feed a train-mode BatchNorm have an exact gradient of zero (rounding
    noise only): each of theirs must stay below 1e-5 of the group's
    largest gradient instead (counted as 2 when it does not). Returns the
    worst leaf, its flat index and both values there."""
    top = max(float(ref.abs().max()) for _, ref in named_ref)
    worst = {"err": 0.0}
    for (name, g), (ref_name, ref) in zip(named, named_ref, strict=True):
        assert name == ref_name, (name, ref_name)
        g, ref = g.detach().cpu().double(), ref.detach().cpu().double()
        if name.startswith("generator") and name.endswith(".0.bias"):
            err = 2.0 if max(float(g.abs().max()), float(ref.abs().max())) > 1e-5 * top else 0.0
            i = int(g.abs().argmax())
        else:
            e = (g - ref).abs() / (rtol * (ref.abs() + ref.abs().max())).clamp(min=1e-30)
            i = int(e.argmax())
            err = float(e.flatten()[i])
        if err >= worst["err"]:
            worst = {"err": err, "leaf": name, "index": i, "value": float(g.flatten()[i]),
                     "ref": float(ref.flatten()[i])}
    return worst


def phase_train_mmgan(work_dir):
    """MM-GAN training at ``MMGANConfig()`` width on the card, on the pickle
    phase's device-path windows."""
    import numpy as np
    import torch

    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.models.mmgan import FlaxBatchNorm1d
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train import mmgan_loop
    from gandes_tpu_torch.train.losses import bce_with_logits
    from gandes_tpu_torch.train.steps import (
        ADAM_BETAS,
        ADAM_EPS,
        CUDNN_TRAIN_FLAGS,
        direct_g_loss_and_grads,
        g_parameters,
        make_mmgan_gen_forward,
        make_mmgan_train_step,
    )

    t_phase = time.perf_counter()
    ds = MaestroDatasetPickle(os.path.join(work_dir, "windows.pkl"), data_dir=".")
    base = mmgan_loop.MMGANConfig()
    paths = {"log_path": os.path.join(work_dir, "logs") + "/",
             "midi_out_dir": os.path.join(work_dir, "midi")}
    os.makedirs(paths["log_path"], exist_ok=True)

    def cfg_for(name, **kw):
        return mmgan_loop.MMGANConfig(**{**paths, "models_dir": os.path.join(work_dir, name),
                                         "losses_dir": os.path.join(work_dir, name + "_losses"),
                                         **kw})

    counts = []
    real_m2m = mmgan_loop.matrix_to_midi

    def recording_m2m(*args, **kw):
        counts.append(kw["count"])
        return real_m2m(*args, **kw)

    mmgan_loop.matrix_to_midi = recording_m2m
    try:
        # g_update='none': 2 epochs of 3 batches, profiled; then resume to 3
        mel_power_cuda.launches = rasterize_cuda.launches = 0
        cfg = cfg_for("none", num_epochs=2, profile=True)
        np.random.seed(0)
        t = time.perf_counter()
        state, hist = mmgan_loop.train_mmgan(ds, cfg, max_batches=3, device=DEVICE)
        _sync()
        none_s = time.perf_counter() - t
        first_counts, counts[:] = list(counts), []
        launches = {"mel_power": mel_power_cuda.launches,
                    "roll_rasterize": rasterize_cuda.launches}
        fresh = mmgan_loop.build_mmgan(cfg).state_dict()
        sd = state.model.state_dict()
        g_unchanged = all(torch.equal(sd[n].cpu(), fresh[n])
                          for n, _ in state.model.named_parameters() if n.startswith("generator"))
        on_card = (all(p.is_cuda for p in state.model.parameters())
                   and all(st[k].is_cuda for opt in (state.g_opt, state.d_opt)
                           for st in opt.state.values() for k in ("exp_avg", "exp_avg_sq")))
        template, _ = mmgan_loop.init_state_for_config(cfg, device=DEVICE)
        path, epoch = ckpt.latest_epoch_checkpoint(cfg.models_dir, "mmgan_64_64")
        reload_equal = epoch == 2 and _states_equal(ckpt.restore_state(path, template), state)

        cfg.num_epochs = 3
        resumed, hist3 = mmgan_loop.train_mmgan(ds, cfg, max_batches=3, device=DEVICE)
        resume_counts, counts[:] = list(counts), []

        direct, hist_d = mmgan_loop.train_mmgan(
            ds, cfg_for("direct", num_epochs=1, g_update="direct"), max_batches=2, device=DEVICE)
        faithful, hist_f = mmgan_loop.train_mmgan(
            ds, cfg_for("faithful", num_epochs=1, faithful=True), max_batches=2, device=DEVICE)
        other_counts = list(counts)
    finally:
        mmgan_loop.matrix_to_midi = real_m2m
    losses = [v for h in (hist, hist3, hist_d, hist_f) for k in ("disc", "gen")
              for e in h[k] for v in e]
    prof = hist["profile"]
    steps = prof["device_step"]["count"]

    # one none step and one direct step from one state on the card and on
    # the CPU: the losses and D's gradients against the CPU in float32; G's
    # (direct) against a float64 CPU step. G's gradients pass back through
    # four train-mode BatchNorms whose variance is flax's one-pass E[x^2] -
    # E[x]^2, which in float32 loses digits where mean^2 / var is large:
    # two float32 runs of the same function (the card and the CPU, or the
    # CPU on the batch reversed) differ by more than rtol 1e-4 of G2's
    # gradients, while each lies within it of float64. The same comparison
    # with a two-pass variance (card and CPU, through the card's post-update
    # D) shows the card's float32 within rtol 1e-4 of the CPU's. The params
    # after Adam are not compared: its first step maps g to ~lr * sign(g).
    def batch(i):
        items = [ds[k] for k in range(i * base.batch_size, (i + 1) * base.batch_size)]
        real = np.stack([np.stack([r, d]) for r, d, _ in items]).astype(np.float32)
        return real, np.stack([b for _, _, b in items]).astype(np.float32)

    (real, beats), (fake, _) = batch(0), batch(1)
    noise = mmgan_loop.draw_step_inputs(0, 1, base.batch_size, base.noise_dim, "cpu")
    step_args = [torch.from_numpy(a) for a in (real, fake)] + list(noise[:2]) + \
        [torch.from_numpy(beats), noise[2]]
    reverse = torch.arange(base.batch_size - 1, -1, -1)

    def one_step(mode, dev, dtype=torch.float32, order=None, capturable=False):
        """One step from the initial state. On the card the Adams are the
        CPU's configuration (capturable off, float lr) unless
        ``capturable``: a capturable Adam takes its bias corrections in
        float32 (1 - 0.999f, as optax does) where the CPU's takes them in
        float64, which moves every first update by ~6e-6 relative."""
        st, scheds = mmgan_loop.init_state_for_config(base, device=dev)
        if not capturable:
            st.g_opt, st.d_opt = (torch.optim.Adam(params, lr=0.0, betas=ADAM_BETAS, eps=ADAM_EPS)
                                  for params in (g_parameters(st.model),
                                                 st.model.discriminator.parameters()))
        st.model.to(dtype)
        args = [a if order is None else a[order] for a in step_args]
        st, m = make_mmgan_train_step(*scheds, g_update=mode)(
            st, *(a.to(dev, dtype) for a in args))
        return st, {k: float(v) for k, v in m.items()}

    vs_cpu = {}
    for mode in ("none", "direct"):
        (cs, cm), (ps, pm) = one_step(mode, DEVICE), one_step(mode, "cpu")
        r = vs_cpu[mode] = {
            "losses": cm, "loss_rel_err": max(abs(cm[k] - pm[k]) / abs(pm[k]) for k in pm),
            "d_grad": _grad_err(_named_grads(cs, "d"), _named_grads(ps, "d"))}
        # the loop's capturable Adams on the card against the CPU's: printed
        cap_s, cap_m = one_step(mode, DEVICE, capturable=True)
        r["capturable_adam_loss_rel_err"] = max(abs(cap_m[k] - pm[k]) / abs(pm[k]) for k in pm)
        if mode == "direct":
            r["capturable_adam_g_grad_vs_cpu32"] = _grad_err(_named_grads(cap_s, "g"),
                                                             _named_grads(ps, "g"))
        if mode == "direct":
            card_g, cpu_g = _named_grads(cs, "g"), _named_grads(ps, "g")
            cpu64_g = _named_grads(one_step(mode, "cpu", torch.float64)[0], "g")

            def through_card_d(dev):
                # G's gradients from the initial G through the card's
                # post-update D (so D's Adam step plays no part)
                st, _ = mmgan_loop.init_state_for_config(base, device=dev)
                st.model.discriminator.load_state_dict(cs.model.discriminator.state_dict())
                _, grads = direct_g_loss_and_grads(st.model.train(),
                                                   *(a.to(dev) for a in step_args[1:]))
                return [(n, g) for (n, _), g in zip(card_g, grads)]

            one_pass = FlaxBatchNorm1d.forward
            FlaxBatchNorm1d.forward = _two_pass_batchnorm
            try:
                two_pass = _grad_err(through_card_d(DEVICE), through_card_d("cpu"))
            finally:
                FlaxBatchNorm1d.forward = one_pass
            r.update({
                "g_grad_vs_cpu64": _grad_err(card_g, cpu64_g),
                "g_grad_vs_cpu32": _grad_err(card_g, cpu_g),
                "g_grad_vs_cpu32_through_card_d": _grad_err(card_g, through_card_d("cpu")),
                "g_grad_cpu32_vs_cpu64": _grad_err(cpu_g, cpu64_g),
                "g_grad_cpu32_reversed_vs_cpu32": _grad_err(
                    _named_grads(one_step(mode, "cpu", order=reverse)[0], "g"), cpu_g),
                "g_grad_two_pass_variance_vs_cpu32": two_pass})

    # repeatability: the same 3 none steps twice on the card
    def three_steps():
        st, scheds = mmgan_loop.init_state_for_config(base, device=DEVICE)
        step = make_mmgan_train_step(*scheds)
        for i in range(3):
            r, _ = batch(2 * i)
            f, _ = batch(2 * i + 1)
            st, _ = step(st, torch.from_numpy(r).to(DEVICE), torch.from_numpy(f).to(DEVICE))
        return st

    a, b = three_steps(), three_steps()
    repeat_equal = all(torch.equal(x, y) for x, y in zip(a.model.discriminator.parameters(),
                                                          b.model.discriminator.parameters()))

    # device busy share of one loop step: G forward, DES decode, train step
    st, scheds = mmgan_loop.init_state_for_config(base, device=DEVICE)
    step = make_mmgan_train_step(*scheds)
    gen_forward = make_mmgan_gen_forward()
    real_t = torch.from_numpy(real).to(DEVICE)
    beats_t = torch.from_numpy(beats).to(DEVICE)

    decode = mmgan_loop.make_decode(cfg_for("busy"))

    def loop_step(count):
        n1, n2, aux = mmgan_loop.draw_step_inputs(0, count, base.batch_size, base.noise_dim,
                                                  DEVICE)
        mats, vec = gen_forward(st, n1, n2, beats_t, aux)
        step(st, real_t, decode(mats, vec, count)[0])

    loop_step(1)  # warm
    busy = device_busy(lambda: loop_step(2))
    # the train step alone: its device time against its host time, and the
    # host-side ops that take the most of it
    fake_t = torch.from_numpy(fake).to(DEVICE)
    step_busy = device_busy(lambda: step(st, real_t, fake_t))
    step_host_ops = _top_host_ops(lambda: step(st, real_t, fake_t))

    # what cuDNN's deterministic algorithms cost: D's two forwards and its
    # backward, as the step runs them, under CUDNN_TRAIN_FLAGS and with
    # cuDNN's default (non-deterministic) choice
    def d_grads(deterministic):
        d = st.model.discriminator
        with torch.backends.cudnn.flags(**{**CUDNN_TRAIN_FLAGS, "deterministic": deterministic}):
            loss = (bce_with_logits(d(fake_t).squeeze(), 0.0)
                    + bce_with_logits(d(real_t).squeeze(), 1.0))
            torch.autograd.grad(loss, list(d.parameters()))

    cudnn_cost = {}
    for deterministic in (True, False):
        d_grads(deterministic)  # cuDNN picks its algorithms on the first call
        prof_d = device_busy(lambda: d_grads(deterministic))
        cudnn_cost["deterministic" if deterministic else "default"] = {
            "device_busy_ms": prof_d["device_busy_ms"], "top": prof_d["top"][:3]}

    row = {"phase": "train_mmgan", "phase_s": round(time.perf_counter() - t_phase, 2),
           "batch_size": base.batch_size, "lr": base.lr,
           "none": {"steps": steps, "wall_s": round(none_s, 3),
                    "steps_per_s": round(steps / none_s, 3),
                    "host_des_s_per_step": prof["host_des"]["mean_s"],
                    "device_step_s_per_step": prof["device_step"]["mean_s"],
                    "host_des_p50_s": prof["host_des"]["p50_s"],
                    "device_step_p50_s": prof["device_step"]["p50_s"],
                    "host_des_p95_s": prof["host_des"]["p95_s"],
                    "device_step_p95_s": prof["device_step"]["p95_s"],
                    "counts": first_counts, "g_unchanged": g_unchanged},
           "resume_counts": resume_counts, "direct_and_faithful_counts": other_counts,
           "losses_finite": all(math.isfinite(v) for v in losses),
           "d_loss": hist["disc"], "g_loss": hist["gen"], "direct_g_loss": hist_d["gen"],
           "faithful_g_loss": hist_f["gen"], "on_card": on_card,
           "epoch2_reload_equal": reload_equal, "vs_cpu": vs_cpu,
           "repeat_equal_3_steps": repeat_equal, "cudnn_train_flags": CUDNN_TRAIN_FLAGS,
           "cudnn_deterministic_after_training": torch.backends.cudnn.deterministic,
           "d_backward_cudnn_cost": cudnn_cost,
           "kernel_launches_in_training": launches, "one_step_profile": busy,
           "train_step_profile": step_busy, "train_step_host_ops": step_host_ops,
           "direct_step": direct.step, "faithful_step": faithful.step}
    emit(row)
    failures = []
    if first_counts != [1, 2, 3, 4, 5, 6] or resume_counts != [7, 8, 9]:
        failures.append("counts")
    if not (row["losses_finite"] and g_unchanged and on_card and reload_equal and repeat_equal):
        failures.append("losses/g_unchanged/on_card/reload/repeat")
    if torch.backends.cudnn.deterministic:
        failures.append("the train step left cudnn.deterministic set")
    if direct.step != 2 or faithful.step != 2 or resumed.step != 9:
        failures.append("steps")
    for mode, r in vs_cpu.items():
        if (max(r["loss_rel_err"], r["capturable_adam_loss_rel_err"]) > 1e-4
                or r["d_grad"]["err"] > 1
                or max(r.get(k, {"err": 0.0})["err"]
                       for k in ("g_grad_vs_cpu64", "g_grad_two_pass_variance_vs_cpu32")) > 1):
            failures.append(f"card vs cpu ({mode})")
    if failures:
        raise AssertionError(f"train_mmgan: {failures}")
    return {"sequential_captured": row["none"], "eager_step_profile": step_busy,
            "eager_step_host_ops": step_host_ops}


def _loop_run_summary(state, hist, wall_s, counts):
    """steps/s over the whole ``train_mmgan`` call and StepTimer's seconds
    per step of each phase (``full_step`` holds the host stage too)."""
    prof = hist["profile"]
    out = {"wall_s": round(wall_s, 3), "counts": counts, "step": state.step}
    for name in ("host_des", "device_step", "full_step(fwd+des+update)"):
        if name in prof:
            key = name.split("(")[0]
            out.update({f"{key}_s_per_step": prof[name]["mean_s"],
                        f"{key}_p50_s": prof[name]["p50_s"], f"{key}_p95_s": prof[name]["p95_s"]})
            out["steps"] = prof[name]["count"]
    out["steps_per_s"] = round(out["steps"] / wall_s, 3)
    out["losses_finite"] = all(math.isfinite(v) for k in ("disc", "gen") for e in hist[k]
                               for v in e)
    return out


def phase_train_fast(work_dir, seq):
    """MM-GAN training with the whole-batch host stage (``des_parallel=16``)
    and one-launch steps (CUDA graphs, ``fused_io``), beside phase
    ``train_mmgan``'s sequential run (``seq``); then the graph checks at
    ``MMGANConfig()`` width: captured == eager (same capturable Adams),
    repeatable, scanned K=4 == 4 single captured steps, cuDNN's default
    algorithms under capture (repeatable? device time), ``parallel=1`` on
    this host == the sequential decode (rolls and RNG state)."""
    import numpy as np
    import torch

    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi
    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda
    from gandes_tpu_torch.train import fused_callback, mmgan_loop, steps

    t_phase = time.perf_counter()
    ds = MaestroDatasetPickle(os.path.join(work_dir, "windows.pkl"), data_dir=".")
    base = mmgan_loop.MMGANConfig()
    paths = {"log_path": os.path.join(work_dir, "logs") + "/",
             "midi_out_dir": os.path.join(work_dir, "midi")}

    def run(name, eager=False, **kw):
        counts, real_m2m = [], mmgan_loop.matrix_to_midi
        graphs = mmgan_loop.graph_gen_forward, mmgan_loop.graph_step

        def recording(*args, **kwargs):
            counts.append((kwargs["count"], kwargs["parallel"]))
            return real_m2m(*args, **kwargs)

        mmgan_loop.matrix_to_midi = fused_callback.matrix_to_midi = recording
        if eager:  # the loop's plain (eager) steps on the card
            mmgan_loop.graph_gen_forward = mmgan_loop.graph_step = lambda fn: fn
        try:
            cfg = mmgan_loop.MMGANConfig(**{**paths, "num_epochs": 2, "profile": True,
                                            "models_dir": os.path.join(work_dir, name),
                                            "losses_dir": os.path.join(work_dir, name + "_l"),
                                            **kw})
            np.random.seed(0)
            t = time.perf_counter()
            state, hist = mmgan_loop.train_mmgan(ds, cfg, max_batches=3, device=DEVICE)
            _sync()
            wall = time.perf_counter() - t
        finally:
            mmgan_loop.matrix_to_midi = fused_callback.matrix_to_midi = real_m2m
            mmgan_loop.graph_gen_forward, mmgan_loop.graph_step = graphs
        return _loop_run_summary(state, hist, wall, counts)

    mel_power_cuda.launches = rasterize_cuda.launches = 0
    runs = {"parallel16_captured": run("p16_graph", des_parallel=16),
            "parallel16_eager": run("p16_eager", eager=True, des_parallel=16),
            "parallel16_fused_io": run("p16_fused", fused_io=True, des_parallel=16)}
    launches = {"mel_power": mel_power_cuda.launches, "roll_rasterize": rasterize_cuda.launches}

    # step-level checks on the pickler's windows at B = 16
    def batch(i):
        items = [ds[k] for k in range(i * base.batch_size, (i + 1) * base.batch_size)]
        real = np.stack([np.stack([r, d]) for r, d, _ in items]).astype(np.float32)
        return (torch.from_numpy(real).to(DEVICE),
                torch.from_numpy(np.stack([b for _, _, b in items]).astype(np.float32)).to(DEVICE))

    rolls = [batch(i)[0] for i in range(8)]
    beats = batch(0)[1]
    noise = mmgan_loop.draw_step_inputs(0, 1, base.batch_size, base.noise_dim, DEVICE)

    def step_args(mode, i):
        real, fake = rolls[(2 * i) % 8], rolls[(2 * i + 1) % 8]
        return (real, fake) if mode == "none" else (real, fake, noise[0], noise[1], beats,
                                                    noise[2])

    def fresh(**kw):
        cfg = mmgan_loop.MMGANConfig(**kw)
        return mmgan_loop.init_state_for_config(cfg, 1, device=DEVICE)

    def run_steps(mode, graphed, n=3, **kw):
        st, scheds = fresh(**kw)
        fn = steps.make_mmgan_train_step(*scheds, g_update=mode)
        fn = steps.graph_step(fn) if graphed else fn
        metrics = [fn(st, *step_args(mode, i))[1] for i in range(n)]
        _sync()
        return st, metrics

    def equal_runs(a, b):
        (sa, ma), (sb, mb) = a, b
        return _states_equal(sa, sb) and all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb)
                                             for k in x)

    checks = {}
    for mode in ("none", "direct"):
        captured = run_steps(mode, True)
        checks[f"captured_equals_eager_{mode}"] = equal_runs(captured, run_steps(mode, False))
        checks[f"captured_repeat_equal_{mode}"] = equal_runs(captured, run_steps(mode, True))
    # a StepLR boundary at every step (one step per epoch, StepLR every epoch)
    checks["steplr_boundaries_captured_equals_eager"] = equal_runs(
        run_steps("direct", True, steplr_epochs=1), run_steps("direct", False, steplr_epochs=1))

    # make_scanned_steps(K=4), called twice (4 eager warm-up steps, then one
    # replay of 4), against 8 single captured steps on the same arguments
    (single, scheds), (scanned_state, _) = fresh(steplr_epochs=3), fresh(steplr_epochs=3)
    one = steps.graph_step(steps.make_mmgan_train_step(*scheds, g_update="direct"))
    single_m = [one(single, *step_args("direct", 0))[1] for _ in range(8)]
    scanned = steps.make_scanned_steps(steps.make_mmgan_train_step(*scheds, g_update="direct"), 4)
    stacked = [scanned(scanned_state, *step_args("direct", 0))[1] for _ in range(2)]
    _sync()
    checks["scanned_k4_equals_single_captured"] = (
        _states_equal(single, scanned_state) and scanned_state.step == 8
        and all(torch.equal(torch.cat([s[k] for s in stacked]),
                            torch.stack([m[k] for m in single_m])) for k in ("d_loss", "g_loss")))

    # the captured none step: its device time and host ops, and the same
    # under cuDNN's default (non-deterministic) algorithms
    def captured_step_cost():
        st, scheds = fresh()
        graphed = steps.graph_step(steps.make_mmgan_train_step(*scheds))
        for i in range(3):
            graphed(st, *step_args("none", i))
        busy = device_busy(lambda: graphed(st, *step_args("none", 3)))
        ms = cuda_ms(lambda: graphed(st, *step_args("none", 4)), warmup=2, reps=20)
        return {"device_busy_ms": busy["device_busy_ms"], "host_wall_ms": busy["wall_ms"],
                "event_ms": ms, "top": busy["top"][:4]}, (st, graphed)

    det, (st, graphed) = captured_step_cost()
    cudnn = {"deterministic": det}
    captured_profile = device_busy(lambda: graphed(st, *step_args("none", 5)))
    captured_host_ops = _top_host_ops(lambda: graphed(st, *step_args("none", 6)))
    flags = steps.CUDNN_TRAIN_FLAGS
    steps.CUDNN_TRAIN_FLAGS = {**flags, "deterministic": False}
    try:
        cudnn["default"] = captured_step_cost()[0]
        checks_default_repeat = equal_runs(run_steps("none", True), run_steps("none", True))
    finally:
        steps.CUDNN_TRAIN_FLAGS = flags
    cudnn["default_graph_repeat_equal"] = checks_default_repeat
    cudnn["default_saves_device_ms"] = round(cudnn["deterministic"]["device_busy_ms"]
                                             - cudnn["default"]["device_busy_ms"], 4)

    # device busy share of one captured loop step with the batch host stage
    st, scheds = fresh()
    fwd = steps.graph_gen_forward(steps.make_mmgan_gen_forward())
    graphed = steps.graph_step(steps.make_mmgan_train_step(*scheds))
    decode = mmgan_loop.make_decode(mmgan_loop.MMGANConfig(**paths, des_parallel=16))

    def loop_step(count):
        n1, n2, aux = mmgan_loop.draw_step_inputs(0, count, base.batch_size, base.noise_dim,
                                                  DEVICE)
        mats, vec = fwd(st, n1, n2, beats, aux)
        graphed(st, rolls[0], decode(mats, vec, count)[0])

    loop_step(1)
    loop_step(2)
    loop_busy = device_busy(lambda: loop_step(3))

    # parallel=1 on this host: the sequential decode's rolls, failures and
    # global RNG state; and the host stage's time per B = 16 batch
    n1, n2, aux = noise
    mats, vec = steps.make_mmgan_gen_forward()(fresh()[0], n1, n2, beats, aux)
    g1, g2 = mats.cpu().numpy()[:, None], vec.cpu().numpy()
    decoded, host_s = {}, {}
    for parallel in (None, 1, 16):
        np.random.seed(5)
        t = time.perf_counter()
        r, f = matrix_to_midi(g1, g2, adj_size=base.adj_size, instrument=base.instrument,
                              start=base.start, end=base.start + base.sequence_length, count=1,
                              log_path=paths["log_path"], out_dir=paths["midi_out_dir"],
                              force_roll=True, watchdog=30.0, parallel=parallel)
        host_s[str(parallel)] = round(time.perf_counter() - t, 4)
        s = np.random.get_state()
        decoded[parallel] = (r, f, (tuple(s[1]), s[2], s[3], s[4]))
    (r0, f0, s0), (r1, f1, s1) = decoded[None], decoded[1]
    checks["parallel1_equals_sequential"] = (
        f0 == f1 and s0 == s1 and all(np.array_equal(a, b) for a, b in zip(r0, r1, strict=True)))
    checks["rolls_with_notes_parallel1"] = sum(bool(r.any()) for r in r1)

    row = {"phase": "train_fast", "phase_s": round(time.perf_counter() - t_phase, 2),
           "sequential_captured": seq["sequential_captured"], **runs,
           "host_stage_s_per_batch": host_s, "checks": checks, "cudnn_under_capture": cudnn,
           "captured_step_profile": captured_profile, "captured_step_host_ops": captured_host_ops,
           "eager_step_profile": seq["eager_step_profile"],
           "eager_step_host_ops": seq["eager_step_host_ops"],
           "captured_loop_step_profile": loop_busy, "kernel_launches": launches}
    emit(row)
    failures = [k for k, v in checks.items() if v is False]
    for name, r in runs.items():
        if r["counts"] and [c for c, _ in r["counts"]] != [1, 2, 3, 4, 5, 6]:
            failures.append(f"{name} counts")
        if {p for _, p in r["counts"]} != {16} or not r["losses_finite"] or r["step"] != 6:
            failures.append(f"{name} parallel/losses/steps")
    if failures:
        raise AssertionError(f"train_fast: {failures}")


def phase_gandes_parallel():
    """``matrix_to_wav(parallel=4)`` on 4 matrices from the GAN-DES generator
    at serve width, on the card: K2's launches (one per clip), each mel and
    WAV against the port's CPU run of the same call from the same global
    seed at the GAN-DES tolerances, and its time beside the sequential
    ``matrix_to_wav`` on the card. Returns K2's launches."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig
    from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

    gen, _ = load_gandes_state(GanDesConfig(), device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    mats = gandes_eval_forward(gen)(torch.randn(4, 100, generator=g, device=DEVICE)).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        def call(dev, parallel, name):
            d = os.path.join(tmp, name)
            np.random.seed(0)
            _sync()
            t = time.perf_counter()
            spec = matrix_to_wav(mats, size=20, start=0, end=216, out_dir=d,
                                 log_path=os.path.join(d, "logs/"), max_sim_time=60,
                                 parallel=parallel, device=dev)
            _sync()
            wall = time.perf_counter() - t
            wavs = [wavfile.read(os.path.join(d, "wav", f"output_{i}.wav"))[1] for i in range(4)]
            return spec.cpu(), wavs, wall

        call(DEVICE, 4, "warm")
        mel_power_cuda.launches = 0
        spec, wavs, par_s = call(DEVICE, 4, "card")
        launches = mel_power_cuda.launches
        ref, ref_wavs, cpu_s = call("cpu", 4, "cpu")
        _, _, seq_s = call(DEVICE, None, "seq")
        _, _, par_s2 = call(DEVICE, 4, "card2")
    db_above, db_all, flips = 0.0, 0.0, 0.0
    for i in range(4):
        above = ref[i] > ref[i].min() + 10.0
        db_above = max(db_above, float((spec[i] - ref[i]).abs()[above].max()))
        db_all = max(db_all, float((spec[i] - ref[i]).abs().max()))
        flips = max(flips, float(np.count_nonzero(wavs[i] != ref_wavs[i]) / wavs[i].size))
    row = {"phase": "gandes_parallel", "clips": 4, "parallel": 4, "launches": launches,
           "mel_shape": list(spec.shape), "finite": bool(torch.isfinite(spec).all()),
           "db_err_above_floor": db_above, "db_err_all_bins": db_all, "int16_flip_share": flips,
           "wav_samples": [len(w) for w in wavs], "parallel_s": [round(par_s, 4),
                                                                 round(par_s2, 4)],
           "sequential_s": round(seq_s, 4), "cpu_parallel_s": round(cpu_s, 4)}
    emit(row)
    if (launches != 4 or row["mel_shape"] != [4, 128, 216] or not row["finite"]
            or db_above > 0.05 or db_all > 0.2 or flips > 2e-4):
        raise AssertionError(f"gandes_parallel: {row}")
    return launches


def _rel_err(a, b) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def phase_train_gandes(work_dir):
    """GAN-DES training at ``GanDesConfig()`` width on the card (z 100,
    gen_dim 32, 20x20 matrices, mel 128x216, 1000 customers, 0.5 s DES
    budget, additive synth; B = 30, lr 2e-5; random weights from seed 0), the
    real side ``MaestroDatasetGanDes(batch_size=30)`` over 4 synthetic files
    of 150 s (31 five-second slices each, 30 sampled). Returns K2's launches
    on the path: one per fake clip and one per real slice."""
    import random

    import numpy as np
    import torch

    from gandes_tpu_torch.data.datasets import DataLoader, MaestroDatasetGanDes, my_collate
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train import gandes_loop, steps

    t_phase = time.perf_counter()
    corpus = os.path.join(work_dir, "gandes_corpus")
    corpus_bytes = write_corpus(corpus, n_files=4, seconds=150.0, seed=1)
    base = gandes_loop.GanDesConfig()
    counted = {"clips": 0, "slices": 0}
    decodes = []  # (mats, fake) of every host stage, in order
    real_m2w = gandes_loop.matrix_to_wav

    def recording_m2w(mats, **kw):
        fake = real_m2w(mats, **kw)
        counted["clips"] += len(mats)
        decodes.append((torch.from_numpy(mats), fake))
        return fake

    class Counting:
        """A fresh shuffled loader over the corpus (the CLI's), counting the
        real slices of every batch it yields, skipped ones included."""

        def __iter__(self):
            ds = MaestroDatasetGanDes(batch_size=base.batch_size, input_folder=corpus,
                                      device=DEVICE)
            for batch in DataLoader(ds, batch_size=1, shuffle=True, collate_fn=my_collate):
                counted["slices"] += len(batch)
                yield batch

    def run(name, mode="none", seed_np=True, max_steps=None, **kw):
        cfg = gandes_loop.GanDesConfig(**{
            "model_path": os.path.join(work_dir, name),
            "log_path": os.path.join(work_dir, name + "_logs") + "/",
            "out_dir": os.path.join(work_dir, name + "_out"), "g_update": mode,
            "des_parallel": 16, "write_wav": False, "profile": True, "display_step": 100,
            "save_step": 2, "resume": True, **kw})
        if seed_np:
            np.random.seed(0)
        random.seed(0)  # the dataset samples its slices with Python's random
        first = len(decodes)
        t = time.perf_counter()
        state, hist = gandes_loop.train_gandes(Counting(), cfg, max_steps=max_steps,
                                               device=DEVICE)
        _sync()
        wall = time.perf_counter() - t
        prof = hist["profile"]
        n = prof["device_step"]["count"] if "device_step" in prof else 0
        summary = {"steps": n, "wall_s": round(wall, 3), "steps_per_s": round(n / wall, 4),
                   "state_step": state.step, "d_loss": hist["disc"], "g_loss": hist["gen"],
                   "losses_finite": all(math.isfinite(v) for k in ("disc", "gen")
                                        for v in hist[k])}
        for phase in ("host_des", "device_step"):
            if phase in prof:
                summary.update({f"{phase}_p50_s": prof[phase]["p50_s"],
                                f"{phase}_mean_s": prof[phase]["mean_s"],
                                f"{phase}_p95_s": prof[phase]["p95_s"]})
        return state, summary, decodes[first:]

    mel_power_cuda.launches = 0
    gandes_loop.matrix_to_wav = recording_m2w
    try:
        straight, runs_straight, straight_decodes = run("straight")
        _, runs_split, split_decodes = run("split", max_steps=3)
        resumed, runs_resumed, _ = run("split", seed_np=False)
        s_state_run, runs_surrogate, surrogate_decodes = run("surrogate", "surrogate",
                                                             max_steps=2)
        _, runs_reinforce, reinforce_decodes = run("reinforce", "reinforce", max_steps=2)
        _, runs_wav, wav_decodes = run("wav", max_steps=1, write_wav=True)
        wavs = sorted(os.listdir(os.path.join(work_dir, "wav_out", "wav")))
        _, runs_seq, _ = run("sequential", max_steps=2, des_parallel=None)
    finally:
        gandes_loop.matrix_to_wav = real_m2w
    launches, clips, slices = mel_power_cuda.launches, counted["clips"], counted["slices"]
    # the straight and the split run's first host stage: G's matrices and the
    # fake mels, bit for bit (what the resume check rests on)
    first_stage_equal = [torch.equal(a, b) for a, b in zip(straight_decodes[0],
                                                           split_decodes[0])]
    resume_equal = (_tensors_equal(straight.gen.state_dict(), resumed.gen.state_dict())
                    and _tensors_equal(straight.disc.state_dict(), resumed.disc.state_dict())
                    and _tensors_equal(straight.g_opt.state_dict(), resumed.g_opt.state_dict())
                    and _tensors_equal(straight.d_opt.state_dict(), resumed.d_opt.state_dict())
                    and straight.step == resumed.step == 4
                    and runs_split["d_loss"] + runs_resumed["d_loss"] == runs_straight["d_loss"])

    # one step of each mode on the card against the same step on the CPU,
    # from the seed-0 state, on two input sets: "loop", the loop's own first
    # inputs (a real batch, each run's first host stage's fake mels and
    # matrices, step 0's noise), and "uniform", mels drawn from U(-4, 0) (the
    # CPU tests' inputs) with the same matrices and noise. On the loop's
    # mel-dB inputs D's first Adam step saturates its output on the fakes
    # (sigmoid ~1e-7), so G's gradient vanishes (surrogate) or its
    # advantages are the clip's rounding (reinforce); and the mel floor's
    # plateaus tie D's max pools, whose gradient cuDNN's FFT convolution
    # (which rounds a plateau's outputs by position) and the CPU's route to
    # different pixels. G's gradients are checked on the uniform set,
    # against the CPU in float32, and printed on the loop's. Against float64
    # they are printed only: D's max pools route ~60 of the 829,440 input
    # gradient elements differently in float64 (near ties), which moves G's
    # surrogate gradient by ~37 of the budget on the CPU as on the card,
    # while G's own float32 backward, given float64's input gradient, stays
    # within 0.008 of it. On the card
    # the Adams take the CPU's configuration (capturable off), as in phase
    # train_mmgan; the loop's capturable Adams are printed beside.
    real = next(iter(Counting()))
    noise = gandes_loop.draw_step_inputs(base.seed, 0, len(real), base.z_dim, "cpu")[0]
    first_inputs = {"none": straight_decodes[0], "surrogate": surrogate_decodes[0],
                    "reinforce": reinforce_decodes[0]}

    uniform = [torch.rand(real.shape, generator=torch.Generator().manual_seed(i)) * 4 - 4
               for i in range(2)]

    def inputs(mode, variant):
        """(real, fake, noise, mats) on the CPU."""
        mats, fake = first_inputs[mode]
        if variant == "loop":
            return real.cpu(), fake.cpu(), noise, mats
        return uniform[0], uniform[1], noise, mats

    def one_step(mode, variant, dev, capturable=False):
        st = gandes_loop.init_state_for_config(base, dev)
        s_st = gandes_loop.init_surrogate_for_config(base, dev) if mode == "surrogate" else None
        if not capturable:
            st.g_opt, st.d_opt = (
                torch.optim.Adam(m.parameters(), lr=base.lr, betas=steps.GANDES_ADAM_BETAS,
                                 eps=steps.ADAM_EPS) for m in (st.gen, st.disc))
            if s_st is not None:
                s_st.opt = torch.optim.Adam(s_st.model.parameters(), lr=base.surrogate_lr,
                                            betas=steps.ADAM_BETAS, eps=steps.ADAM_EPS)
        r, f, z, x = (a.to(dev) for a in inputs(mode, variant))
        if mode == "surrogate":
            st, s_st, m = steps.make_gandes_train_step_surrogate()(st, s_st, r, f, x, z)
        elif mode == "reinforce":
            st, m = steps.make_gandes_train_step_reinforce(base.reinforce_sigma)(st, r, f, x, z)
        else:
            st, m = steps.make_gandes_train_step()(st, r, f)
        _sync()
        return st, s_st, {k: float(v) for k, v in m.items()}

    def named(module):
        return [(n, p.grad) for n, p in module.named_parameters()]

    def g_grads_through(card, card_s, mode, variant, dev, dtype):
        """G's gradients from the initial G on ``dev`` through the card
        step's post-update D (and surrogate)."""
        st = gandes_loop.init_state_for_config(base, dev)
        st.disc.load_state_dict(card.disc.state_dict())
        for m in (st.gen, st.disc):
            m.to(dtype)
        _, f, z, x = (a.to(dev, dtype) for a in inputs(mode, variant))
        if mode == "surrogate":
            s_model = gandes_loop.init_surrogate_for_config(base, dev).model
            s_model.load_state_dict(card_s.model.state_dict())
            _, grads = steps.surrogate_g_loss_and_grads(st, s_model.to(dtype), f, z)
        else:
            _, grads, _ = steps.reinforce_g_loss_and_grads(st, f, x, z, base.reinforce_sigma)
        return [(n, g) for (n, _), g in zip(st.gen.named_parameters(), grads)]

    vs_cpu = {}
    for mode in ("none", "surrogate", "reinforce"):
        for variant in ("loop", "uniform"):
            (cs, css, cm), (ps, _, pm) = (one_step(mode, variant, dev) for dev in (DEVICE, "cpu"))
            r = vs_cpu[f"{mode}_{variant}"] = {
                "losses": cm, "loss_rel_err": {k: _rel_err(cm[k], pm[k]) for k in pm},
                "d_grad": _grad_err(named(cs.disc), named(ps.disc))}
            cap_m = one_step(mode, variant, DEVICE, capturable=True)[2]
            r["capturable_adam_loss_rel_err"] = {k: _rel_err(cap_m[k], pm[k]) for k in pm}
            if mode != "none":
                card_g = named(cs.gen)
                r["g_grad_vs_cpu64"] = _grad_err(card_g, g_grads_through(
                    cs, css, mode, variant, "cpu", torch.float64))
                r["g_grad_vs_cpu32"] = _grad_err(card_g, g_grads_through(
                    cs, css, mode, variant, "cpu", torch.float32))
                r["g_grad_cpu32_vs_cpu64"] = _grad_err(*(g_grads_through(
                    cs, css, mode, variant, "cpu", dt) for dt in (torch.float32, torch.float64)))
            if variant == "loop":  # the same step twice on the card (capturable Adams)
                (a, sa, ma), (b, sb, mb) = (one_step(mode, variant, DEVICE, capturable=True)
                                            for _ in range(2))
                r["repeat_equal"] = (
                    ma == mb and _tensors_equal(a.gen.state_dict(), b.gen.state_dict())
                    and _tensors_equal(a.disc.state_dict(), b.disc.state_dict())
                    and (sa is None or _tensors_equal(sa.model.state_dict(),
                                                      sb.model.state_dict())))

    # the loop's train-mode G forward at B = 30, twice from the seed-0 state
    forward_repeat_equal = torch.equal(*(
        steps.make_gandes_gen_forward()(gandes_loop.init_state_for_config(base, DEVICE),
                                        noise.to(DEVICE)) for _ in range(2)))

    # device busy share of one loop step (G forward, host stage, none step)
    st = gandes_loop.init_state_for_config(base, DEVICE)
    step = steps.make_gandes_train_step()
    forward = steps.make_gandes_gen_forward()
    real_dev = real.to(DEVICE)
    busy_dir = os.path.join(work_dir, "busy")

    def loop_step(count):
        z = gandes_loop.draw_step_inputs(base.seed, count, len(real), base.z_dim, DEVICE)[0]
        mats = forward(st, z)
        fake = real_m2w(mats.cpu().numpy(), size=20, start=0, end=216, log_path=busy_dir + "/",
                        out_dir=busy_dir, parallel=16, write_wav=False, device=DEVICE)
        step(st, real_dev, fake)

    os.makedirs(busy_dir, exist_ok=True)
    loop_step(0)
    busy = device_busy(lambda: loop_step(1))
    fake_dev = first_inputs["none"][1].to(DEVICE)
    step_busy = device_busy(lambda: step(st, real_dev, fake_dev))
    step_host_ops = _top_host_ops(lambda: step(st, real_dev, fake_dev))

    row = {"phase": "train_gandes", "phase_s": round(time.perf_counter() - t_phase, 2),
           "batch_size": base.batch_size, "lr": base.lr, "corpus_files": 4,
           "corpus_bytes": corpus_bytes, "none_parallel16": runs_straight,
           "none_split_3": runs_split, "none_resumed_to_4": runs_resumed,
           "surrogate": runs_surrogate, "reinforce": runs_reinforce,
           "none_sequential": runs_seq, "write_wav_run": runs_wav, "wav_files": len(wavs),
           "resume_equal": resume_equal, "fake_clips": clips, "real_slices": slices,
           "k2_launches": launches, "forward_repeat_equal": forward_repeat_equal,
           "first_stage_mats_fake_equal": first_stage_equal,
           "surrogate_steps": s_state_run.step, "vs_cpu": vs_cpu,
           "one_step_profile": busy, "train_step_profile": step_busy,
           "train_step_host_ops": step_host_ops,
           "cudnn_deterministic_after_training": torch.backends.cudnn.deterministic}
    emit(row)
    failures = []
    if launches <= 0 or launches != clips + slices:
        failures.append("k2 launches != fake clips + real slices")
    if not (resume_equal and forward_repeat_equal):
        failures.append("resume / G forward repeat")
    if wavs != sorted(f"output_{i}.wav" for i in range(len(wav_decodes[0][0]))):
        failures.append("wav files")
    for name, r in (("straight", runs_straight), ("surrogate", runs_surrogate),
                    ("reinforce", runs_reinforce), ("sequential", runs_seq)):
        if not r["losses_finite"] or r["steps"] != (4 if name == "straight" else 2):
            failures.append(f"{name} steps/losses")
    for name, r in vs_cpu.items():
        if (r["d_grad"]["err"] > 1 or not r.get("repeat_equal", True)
                or r["loss_rel_err"]["d_loss"] > 1e-4
                or (name.endswith("uniform")
                    and r.get("g_grad_vs_cpu32", {"err": 0.0})["err"] > 1)):
            failures.append(f"card vs cpu ({name})")
    if torch.backends.cudnn.deterministic:
        failures.append("the train step left cudnn.deterministic set")
    if failures:
        raise AssertionError(f"train_gandes: {failures}")
    return launches, straight


def _named_s_grads(s_state):
    return [(f"s.{n}", p.grad) for n, p in s_state.model.named_parameters()]


def _s_states_equal(a, b) -> bool:
    return (_tensors_equal(a.model.state_dict(), b.model.state_dict())
            and _tensors_equal(a.opt.state_dict(), b.opt.state_dict()) and a.step == b.step)


def phase_train_mmgan_modes(work_dir):
    """MM-GAN ``surrogate`` and ``reinforce`` training at ``MMGANConfig()``
    width (B = 16, lr 0.01, ``surrogate_lr`` 1e-3) on the card with
    ``des_parallel=16``, on phase ``pickle``'s windows; returns the
    surrogate run's models directory for phase ``eval_metrics``."""
    import numpy as np
    import torch

    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.models.mmgan import FlaxBatchNorm1d
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train import mmgan_loop, steps

    t_phase = time.perf_counter()
    ds = MaestroDatasetPickle(os.path.join(work_dir, "windows.pkl"), data_dir=".")
    base = mmgan_loop.MMGANConfig()
    paths = {"log_path": os.path.join(work_dir, "logs") + "/",
             "midi_out_dir": os.path.join(work_dir, "midi")}
    # every balance knob of the surrogate step on, the anneal over 2 epochs
    # (fixed, so a run of 3 epochs and a run of 2 resumed to 3 agree)
    knobs = {"instance_noise_sigma": 2.0, "instance_noise_anneal_epochs": 2.0,
             "instance_noise_floor": 0.5, "r1_gamma": 1.0, "moment_match": 1.0,
             "moment_match_cond": 1.0}
    fd_knobs = {"r1_gamma": 1.0, "r1_mode": "fd", "r1_fd_eps": 0.5}
    real_m2m = mmgan_loop.matrix_to_midi

    def run(name, epochs, **kw):
        counts = []

        def recording(*args, **kwargs):
            counts.append((kwargs["count"], kwargs["parallel"], kwargs["force_roll"]))
            return real_m2m(*args, **kwargs)

        mmgan_loop.matrix_to_midi = recording
        try:
            cfg = mmgan_loop.MMGANConfig(**{**paths, "num_epochs": epochs, "profile": True,
                                            "des_parallel": 16,
                                            "models_dir": os.path.join(work_dir, name),
                                            "losses_dir": os.path.join(work_dir, name + "_l"),
                                            **kw})
            t = time.perf_counter()
            state, hist = mmgan_loop.train_mmgan(ds, cfg, max_batches=3, device=DEVICE)
            _sync()
            wall = time.perf_counter() - t
        finally:
            mmgan_loop.matrix_to_midi = real_m2m
        return state, {**_loop_run_summary(state, hist, wall, counts),
                       "d_loss": hist["disc"], "g_loss": hist["gen"]}

    mel_power_cuda.launches = rasterize_cuda.launches = 0
    np.random.seed(0)
    _, surrogate = run("modes_surrogate", 2, g_update="surrogate", **knobs)
    resumed, surrogate_resumed = run("modes_surrogate", 3, g_update="surrogate", **knobs)
    np.random.seed(0)
    straight, surrogate_straight = run("modes_straight", 3, g_update="surrogate", **knobs)
    np.random.seed(0)
    _, surrogate_fd = run("modes_fd", 1, g_update="surrogate", **fd_knobs)
    np.random.seed(0)
    _, reinforce = run("modes_reinforce", 1, g_update="reinforce")
    launches = {"mel_power": mel_power_cuda.launches, "roll_rasterize": rasterize_cuda.launches}
    name3 = "mmgan_64_64_epoch_3_surrogate"
    resume_equal = (_states_equal(resumed, straight)
                    and _s_states_equal(*(ckpt.restore_surrogate_state(
                        os.path.join(work_dir, d, name3),
                        mmgan_loop.init_surrogate_for_config(base, "cpu"))
                        for d in ("modes_surrogate", "modes_straight"))))

    # one step of each mode from one state on the card and on the CPU, on
    # the loop's own kind of inputs: a real batch, the DES's rolls of the
    # initial G's outputs (forced), those outputs, and step 1's draws
    def batch(i):
        items = [ds[k] for k in range(i * base.batch_size, (i + 1) * base.batch_size)]
        real = np.stack([np.stack([r, d]) for r, d, _ in items]).astype(np.float32)
        return torch.from_numpy(real), torch.from_numpy(np.stack([b for _, _, b in items]))

    real, beats = batch(0)
    n1, n2, aux = mmgan_loop.draw_step_inputs(0, 1, base.batch_size, base.noise_dim, "cpu")
    st0, _ = mmgan_loop.init_state_for_config(base, device="cpu")
    mats, vec = steps.make_mmgan_gen_forward()(st0, n1, n2, beats.float(), aux)
    eps_m, eps_v = mmgan_loop.draw_perturbation(0, 1, mats.shape, vec.shape, "cpu")
    samples = {"surrogate": (mats, vec),
               "reinforce": (torch.clamp(mats + base.reinforce_sigma * eps_m, 0.0, 1.0),
                             torch.clamp(vec + base.reinforce_sigma * eps_v, 0.0, 1.0))}
    fakes = {}
    for kind, (m, v) in samples.items():
        np.random.seed(3)
        rolls, _ = real_m2m(m.numpy()[:, None], v.numpy(), adj_size=base.adj_size,
                            instrument=base.instrument, start=base.start,
                            end=base.start + base.sequence_length, count=1,
                            log_path=paths["log_path"], out_dir=paths["midi_out_dir"],
                            force_roll=True, parallel=16)
        fakes[kind] = torch.from_numpy(np.stack(rolls)).float()
    modes = {"surrogate_all_knobs": ("surrogate", {k.replace("_sigma", ""): v
                                                   for k, v in knobs.items()}),
             "surrogate_r1_fd": ("surrogate", fd_knobs), "reinforce": ("reinforce", {})}

    def make_step(kind, kw, scheds):
        if kind == "reinforce":
            return steps.make_mmgan_train_step_reinforce(*scheds, base.reinforce_sigma)
        kw = dict(kw)
        if "instance_noise" in kw:
            kw["instance_noise"] = (kw.pop("instance_noise"),
                                    max(1, int(kw.pop("instance_noise_anneal_epochs") * 3)))
        return steps.make_mmgan_train_step_surrogate(*scheds, **kw)

    def step_args(kind, dev, dtype=torch.float32):
        m, v = samples[kind]
        return [a.to(dev, dtype) for a in (real, fakes[kind], m, v, n1, n2, beats, aux)]

    def one_step(name, dev, dtype=torch.float32, capturable=False):
        """One step from the seed-0 state; on the card with the CPU's Adam
        configuration unless ``capturable`` (the loop's)."""
        kind, kw = modes[name]
        st, scheds = mmgan_loop.init_state_for_config(base, 3, device=dev)
        s_st = mmgan_loop.init_surrogate_for_config(base, dev) if kind == "surrogate" else None
        if not capturable:
            st.g_opt, st.d_opt = (torch.optim.Adam(p, lr=0.0, betas=steps.ADAM_BETAS,
                                                   eps=steps.ADAM_EPS)
                                  for p in (steps.g_parameters(st.model),
                                            st.model.discriminator.parameters()))
            if s_st is not None:
                s_st.opt = torch.optim.Adam(s_st.model.parameters(), lr=base.surrogate_lr,
                                            betas=steps.ADAM_BETAS, eps=steps.ADAM_EPS)
        st.model.to(dtype)
        if s_st is not None:
            s_st.model.to(dtype)
        step = make_step(kind, kw, scheds)
        args = step_args(kind, dev, dtype)
        if kind == "surrogate":
            st, s_st, m = step(st, s_st, args[0], args[1], *args[2:])
        else:
            st, m = step(st, *args)
        _sync()
        return st, s_st, {k: float(v) for k, v in m.items()}, step

    def g_grads_through(card, card_s, name, dev, dtype, two_pass=False):
        """G's gradients from the initial G on ``dev`` through the card
        step's post-update D (and surrogate)."""
        kind, kw = modes[name]
        st, _ = mmgan_loop.init_state_for_config(base, 3, device=dev)
        st.model.discriminator.load_state_dict(card.model.discriminator.state_dict())
        st.model.to(dtype)
        args = step_args(kind, dev, dtype)
        one_pass = FlaxBatchNorm1d.forward
        if two_pass:
            FlaxBatchNorm1d.forward = _two_pass_batchnorm
        try:
            if kind == "surrogate":
                s_model = mmgan_loop.init_surrogate_for_config(base, dev).model
                s_model.load_state_dict(card_s.model.state_dict())
                draws = make_step(kind, kw, (lambda c: 0.0, lambda c: 0.0)).draws(0, args[0])
                _, grads = steps.mmgan_surrogate_g_loss_and_grads(
                    st.model.train(), s_model.to(dtype), args[0], args[1], *args[4:],
                    None if "proxy" not in draws else draws["proxy"].to(dev, dtype),
                    kw.get("moment_match", 0.0), kw.get("moment_match_cond", 0.0))
            else:
                _, grads, _ = steps.mmgan_reinforce_g_loss_and_grads(
                    st.model.train(), args[1], *args[2:], base.reinforce_sigma)
        finally:
            FlaxBatchNorm1d.forward = one_pass
        return [(n, g) for (n, _), g in zip(_named_grads(st, "g"), grads)]

    vs_cpu = {}
    for name, (kind, _) in modes.items():
        (cs, css, cm, _), (ps, pss, pm, _) = one_step(name, DEVICE), one_step(name, "cpu")
        r = vs_cpu[name] = {"losses": cm, "loss_rel_err": {k: _rel_err(cm[k], pm[k]) for k in pm},
                            "d_grad": _grad_err(_named_grads(cs, "d"), _named_grads(ps, "d"))}
        if css is not None:
            r["s_grad"] = _grad_err(_named_s_grads(css), _named_s_grads(pss))
        card_g = _named_grads(cs, "g")
        r["g_grad_vs_cpu32"] = _grad_err(card_g, g_grads_through(cs, css, name, "cpu",
                                                                 torch.float32))
        r["g_grad_vs_cpu64"] = _grad_err(card_g, g_grads_through(cs, css, name, "cpu",
                                                                 torch.float64))
        r["g_grad_cpu32_vs_cpu64"] = _grad_err(*(g_grads_through(cs, css, name, "cpu", dt)
                                                 for dt in (torch.float32, torch.float64)))
        r["g_grad_two_pass_variance_vs_cpu32"] = _grad_err(
            g_grads_through(cs, css, name, DEVICE, torch.float32, two_pass=True),
            g_grads_through(cs, css, name, "cpu", torch.float32, two_pass=True))
        # the same step twice on the card, the loop's capturable Adams
        (a, sa, ma, _), (b, sb, mb, _) = (one_step(name, DEVICE, capturable=True)
                                          for _ in range(2))
        r["repeat_equal"] = (ma == mb and _states_equal(a, b)
                             and (sa is None or _s_states_equal(sa, sb)))
        r["capturable_adam_loss_rel_err"] = {k: _rel_err(ma[k], pm[k]) for k in pm}

    # make_scanned_steps(K=4, n_carry=2), all knobs: called twice (4 eager
    # warm-up steps, then one replay of a captured graph of 4) against 8
    # single eager steps with the same capturable Adams; the regression scan
    # the same way against 8 single regressions
    def fresh_pair():
        st, scheds = mmgan_loop.init_state_for_config(base, 3, device=DEVICE)
        return st, mmgan_loop.init_surrogate_for_config(base, DEVICE), scheds

    args = step_args("surrogate", DEVICE)
    (single, single_s, scheds), (scan, scan_s, _) = fresh_pair(), fresh_pair()
    one = make_step("surrogate", modes["surrogate_all_knobs"][1], scheds)
    single_m = [one(single, single_s, *args)[2] for _ in range(8)]
    scanned = steps.make_scanned_steps(make_step("surrogate", modes["surrogate_all_knobs"][1],
                                                 scheds), 4, n_carry=2)
    stacked = [scanned(scan, scan_s, *args)[2] for _ in range(2)]
    _sync()
    checks = {"scanned_k4_n_carry2_equals_single": (
        _states_equal(single, scan) and _s_states_equal(single_s, scan_s) and scan.step == 8
        and all(torch.equal(torch.cat([s[k] for s in stacked]),
                            torch.stack([m[k] for m in single_m]))
                for k in ("d_loss", "g_loss", "s_loss")))}
    (_, reg_single, _), (_, reg_scan, _) = fresh_pair(), fresh_pair()
    reg_args = (args[2], args[3], args[1])
    reg_one = steps.make_surrogate_regression_step()
    reg_losses = [reg_one(reg_single, *reg_args)[1]["s_loss"] for _ in range(8)]
    reg_run = steps.make_surrogate_regression_scan(4)
    reg_scanned = torch.cat([reg_run(reg_scan, *reg_args)[1] for _ in range(2)])
    _sync()
    checks["regression_scan_k4_equals_single"] = (
        _s_states_equal(reg_single, reg_scan) and torch.equal(reg_scanned,
                                                              torch.stack(reg_losses)))

    # device busy share of one loop step of each mode: G forward (graph),
    # perturbation (reinforce), DES, the eager step
    busy = {}
    decode = mmgan_loop.make_decode(mmgan_loop.MMGANConfig(**paths, des_parallel=16),
                                    force_roll=True)
    real_dev, beats_dev = real.to(DEVICE), beats.to(DEVICE, torch.float32)
    for name in ("surrogate_all_knobs", "reinforce"):
        kind, kw = modes[name]
        st, scheds = mmgan_loop.init_state_for_config(base, 3, device=DEVICE)
        s_st = mmgan_loop.init_surrogate_for_config(base, DEVICE)
        fwd = steps.graph_gen_forward(steps.make_mmgan_gen_forward())
        step = make_step(kind, kw, scheds)

        def loop_step(count):
            a1, a2, ax = mmgan_loop.draw_step_inputs(0, count, base.batch_size, base.noise_dim,
                                                     DEVICE)
            m, v = fwd(st, a1, a2, beats_dev, ax)
            if kind == "reinforce":
                e_m, e_v = mmgan_loop.draw_perturbation(0, count, m.shape, v.shape, DEVICE)
                m = torch.clamp(m + base.reinforce_sigma * e_m, 0.0, 1.0)
                v = torch.clamp(v + base.reinforce_sigma * e_v, 0.0, 1.0)
            fake = decode(m, v, count)[0]
            if kind == "surrogate":
                step(st, s_st, real_dev, fake, m, v, a1, a2, beats_dev, ax)
            else:
                step(st, real_dev, fake, m, v, a1, a2, beats_dev, ax)

        loop_step(1)
        loop_step(2)
        busy[name] = device_busy(lambda: loop_step(3))

    runs = {"surrogate_all_knobs": surrogate, "surrogate_resumed_to_3": surrogate_resumed,
            "surrogate_straight_3": surrogate_straight, "surrogate_r1_fd": surrogate_fd,
            "reinforce": reinforce}
    row = {"phase": "train_mmgan_modes", "phase_s": round(time.perf_counter() - t_phase, 2),
           "batch_size": base.batch_size, "lr": base.lr, "surrogate_lr": base.surrogate_lr,
           "knobs": knobs, "fd_knobs": fd_knobs, **runs, "resume_equal": resume_equal,
           "checks": checks, "vs_cpu": vs_cpu, "one_loop_step_profile": busy,
           "kernel_launches": launches,
           "cudnn_deterministic_after_training": torch.backends.cudnn.deterministic}
    emit(row)
    failures = [k for k, v in checks.items() if not v]
    want = {"surrogate_all_knobs": [1, 2, 3, 4, 5, 6], "surrogate_resumed_to_3": [7, 8, 9],
            "surrogate_straight_3": list(range(1, 10)), "surrogate_r1_fd": [1, 2, 3],
            "reinforce": [1, 2, 3]}
    for name, r in runs.items():
        if ([c for c, _, _ in r["counts"]] != want[name] or not r["losses_finite"]
                or {(p, f) for _, p, f in r["counts"]} != {(16, True)}):
            failures.append(f"{name} counts/losses")
    if not resume_equal:
        failures.append("resume (incl. the surrogate) != straight")
    if launches != {"mel_power": 0, "roll_rasterize": 0}:
        failures.append(f"kernel launches in training: {launches}")
    for name, r in vs_cpu.items():
        # reinforce's G loss, -mean(advantage * logprob), cancels logprobs
        # of ~-2,000 down to ~2: each device's rounding of the rewards
        # reaches it multiplied by ~700 (tests/test_torch_mmgan_modes.py)
        loss_rtol = {"g_loss": 1e-3} if name == "reinforce" else {}
        if (any(v > loss_rtol.get(k, 1e-4) for k, v in r["loss_rel_err"].items())
                or r["d_grad"]["err"] > 1
                or r.get("s_grad", {"err": 0.0})["err"] > 1 or not r["repeat_equal"]
                or r["g_grad_two_pass_variance_vs_cpu32"]["err"] > 1):
            failures.append(f"card vs cpu ({name})")
    if torch.backends.cudnn.deterministic:
        failures.append("the train step left cudnn.deterministic set")
    if failures:
        raise AssertionError(f"train_mmgan_modes: {failures}")
    return os.path.join(work_dir, "modes_surrogate")


def _eval_metrics(argv) -> dict:
    """``cli.main(argv)`` for ``eval-metrics``, its printed JSON parsed."""
    import contextlib
    import io

    from gandes_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue())


def phase_eval_metrics(work_dir, mmgan_models, gandes_state):
    """``eval-metrics`` through the CLI function on the card for both
    families, each beside a ``--device cpu`` run of its real side: MM-GAN
    (n = 16, the pickle's windows) sweeping phase ``train_mmgan_modes``'
    epoch checkpoints (its ``_surrogate`` companions skipped); GAN-DES
    (n = 8 over phase ``train_gandes``' corpus) sweeping that phase's
    ``gen_*`` checkpoints. Returns K2's launches: one per real slice and one
    per fake clip of each checkpoint."""
    import torch

    from gandes_tpu_torch import cli
    from gandes_tpu_torch.data import datasets
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda
    from gandes_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work_dir)  # the decodes write logs/ and adj_sim_outputs/ here
    try:
        pickle_path = os.path.join(work_dir, "windows.pkl")
        mmgan_argv = ["eval-metrics", "--data", pickle_path, "--n", "16", "--des-parallel", "16"]
        rasterize_cuda.launches = 0
        t = time.perf_counter()
        mmgan = _eval_metrics(mmgan_argv + ["--checkpoints-dir", mmgan_models,
                                            "--device", DEVICE])
        _sync()
        mmgan_s = time.perf_counter() - t
        mmgan_cpu = _eval_metrics(mmgan_argv + ["--device", "cpu"])

        gandes_models = os.path.join(work_dir, "straight")
        ckpt.save_gandes_state(os.path.join(gandes_models, f"gen_{gandes_state.step}_9.5"),
                               gandes_state)
        n_ckpts = sum(cli._gandes_step_key(n) is not None for n in os.listdir(gandes_models))
        corpus = os.path.join(work_dir, "gandes_corpus")
        gandes_argv = ["eval-metrics", "--family", "gandes", "--data", corpus, "--n", "8",
                       "--des-parallel", "16"]
        mels = {DEVICE: [], "cpu": []}  # every real item each run rendered, in order
        get_item = datasets.MaestroDatasetGanDes.__getitem__

        def counting(self, i):
            out = get_item(self, i)
            mels[str(self.device)].append(out.cpu())
            return out

        datasets.MaestroDatasetGanDes.__getitem__ = counting
        try:
            mel_power_cuda.launches = 0
            t = time.perf_counter()
            gandes = _eval_metrics(gandes_argv + ["--checkpoints-dir", gandes_models,
                                                  "--device", DEVICE])
            _sync()
            gandes_s = time.perf_counter() - t
            launches = mel_power_cuda.launches
            real_slices = sum(len(m) for m in mels[DEVICE])
            gandes_cpu = _eval_metrics(gandes_argv + ["--device", "cpu"])
        finally:
            datasets.MaestroDatasetGanDes.__getitem__ = get_item
    finally:
        os.chdir(cwd)
    # the real blocks against the CPU runs': the MM-GAN statistics are of
    # integer rolls (rtol 1e-6). The GAN-DES real mels themselves, slice by
    # slice, within phase slice's 0.05 dB on every bin; their statistics
    # are then read from the JSON beside
    mmgan_real_err = max(_rel_err(mmgan["real"][k], v) for k, v in mmgan_cpu["real"].items())
    g_real, g_cpu = gandes["real"], gandes_cpu["real"]
    gandes_real_err = {k: abs(g_real[k] - g_cpu[k]) for k in ("db_mean", "db_std", "flux")}
    gandes_real_err["centroid_rel"] = _rel_err(g_real["centroid"], g_cpu["centroid"])
    same_items = [tuple(a.shape) for a in mels[DEVICE]] == [tuple(b.shape) for b in mels["cpu"]]
    mel_db_err = max(float((a - b).abs().max()) for a, b in zip(mels[DEVICE], mels["cpu"])) \
        if same_items and mels["cpu"] else float("inf")
    gandes_real_err["mel_db_all_bins"] = mel_db_err
    keys = {"real", "n_real", "per_epoch", "rank_by", "best_epoch", "best_checkpoint"}
    row = {"phase": "eval_metrics", "phase_s": round(time.perf_counter() - t_phase, 2),
           "mmgan": {"wall_s": round(mmgan_s, 3), "real": mmgan["real"],
                     "per_epoch": mmgan["per_epoch"], "best_epoch": mmgan["best_epoch"],
                     "real_rel_err_vs_cpu": mmgan_real_err},
           "gandes": {"wall_s": round(gandes_s, 3), "real": g_real, "real_cpu": g_cpu,
                      "per_epoch": gandes["per_epoch"], "best_epoch": gandes["best_epoch"],
                      "checkpoints": n_ckpts, "real_err_vs_cpu": gandes_real_err,
                      "real_slices": real_slices, "k2_launches": launches},
           "k1_launches": rasterize_cuda.launches}
    emit(row)
    failures = []
    if set(mmgan) != keys or set(gandes) != keys | {"family"}:
        failures.append("json keys")
    if sorted(mmgan["per_epoch"]) != ["1", "2", "3"] or n_ckpts < 2 or \
            len(gandes["per_epoch"]) != n_ckpts:
        failures.append("sweeps")
    if mmgan_real_err > 1e-6 or mel_db_err > 0.05:
        failures.append("real block vs cpu")
    if rasterize_cuda.launches:
        failures.append("k1 launched on the eval path")
    if launches != real_slices + 8 * n_ckpts or real_slices < 8:
        failures.append("k2 launches != real slices + fake clips")
    if failures:
        raise AssertionError(f"eval_metrics: {failures}")
    return launches


# ------------------------------------------------------------------ sf2

# The eight fixture cases of tests/test_sf2_goldens.py, written out again
# (that file imports JAX; tests/test_torch_sf2.py checks that these build the
# same font bytes and play the same notes).
SF2_SR = 22050


def _sf2():
    from gandes_tpu_torch.music import sf2

    return sf2


def _sine(n, period, amp=0.5):
    import numpy as np

    return (amp * np.sin(2 * np.pi * np.arange(n) / period)).astype(np.float32)


def _noise(n, seed=0, amp=0.4):
    import numpy as np

    return (np.random.RandomState(seed).randn(n) * amp / 3).astype(np.float32)


def _one_zone_font(path, sample, gens):
    """One looped sample in one instrument zone of preset 0."""
    name, data, loop_start, loop_end = sample
    _sf2().build_sf2(path, samples=[{"name": name, "data": data, "sample_rate": SF2_SR,
                                     "original_pitch": 60, "loop_start": loop_start,
                                     "loop_end": loop_end}],
                     instruments=[{"name": "i", "zones": [{"sample": 0, "gens": gens}]}],
                     presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}])


def _sine_loop():
    return ("s", _sine(2000, 50), 200, 1800)


def _gens(**kw):
    """Generator amounts by their ``G_*`` names, in the order given."""
    m = _sf2()
    return {getattr(m, "G_" + k): v for k, v in kw.items()}


def _font_layers_excl(path):
    """Velocity-split zones, a pitched-up layer and an exclusiveClass choke."""
    _sf2().build_sf2(path, samples=[
        {"name": "a", "data": _sine(1500, 40, 0.4), "sample_rate": SF2_SR,
         "original_pitch": 72},
        {"name": "b", "data": _sine(1500, 64, 0.4), "sample_rate": SF2_SR,
         "original_pitch": 60},
    ], instruments=[{"name": "i", "zones": [
        {"sample": 0, "vel_lo": 0, "vel_hi": 63,
         "gens": _gens(HOLD_VOL=2786, EXCLUSIVE_CLASS=1)},
        {"sample": 1, "vel_lo": 64, "vel_hi": 127,
         "gens": _gens(HOLD_VOL=2786, EXCLUSIVE_CLASS=1)},
    ]}], presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}])


SF2_CASES = {
    "plain_loop": (lambda p: _one_zone_font(p, _sine_loop(), _gens(
        SAMPLE_MODES=1, HOLD_VOL=2786)), [(60, 100, 0.0, 0.5)]),
    "dahdsr": (lambda p: _one_zone_font(p, _sine_loop(), _gens(
        SAMPLE_MODES=1, ATTACK_VOL=-2000, HOLD_VOL=-3000, DECAY_VOL=-1000, SUSTAIN_VOL=200,
        RELEASE_VOL=-1500)), [(60, 100, 0.0, 0.6), (67, 64, 0.2, 0.8)]),
    "filter_q": (lambda p: _one_zone_font(p, ("n", _noise(4000), 400, 3600), _gens(
        SAMPLE_MODES=1, HOLD_VOL=2786, INITIAL_FILTER_FC=7000, INITIAL_FILTER_Q=300)),
        [(60, 100, 0.0, 0.7)]),
    "lfos_pan": (lambda p: _one_zone_font(p, _sine_loop(), _gens(
        SAMPLE_MODES=1, HOLD_VOL=2786, VIB_LFO_TO_PITCH=80, DELAY_VIB_LFO=-1200,
        MOD_LFO_TO_VOL=80, PAN=350)), [(60, 100, 0.0, 0.9)]),
    "modenv_sweeps": (lambda p: _one_zone_font(p, ("n", _noise(4000, seed=1), 400, 3600), _gens(
        SAMPLE_MODES=1, HOLD_VOL=2786, MOD_ENV_TO_PITCH=400, DECAY_MOD_ENV=-1500,
        INITIAL_FILTER_FC=6000, MOD_ENV_TO_FILTER_FC=2400, MOD_LFO_TO_FILTER_FC=600)),
        [(60, 100, 0.0, 0.8)]),
    "effects_sends": (lambda p: _one_zone_font(p, _sine_loop(), _gens(
        SAMPLE_MODES=1, HOLD_VOL=2786, REVERB_SEND=500, CHORUS_SEND=400)),
        [(60, 100, 0.0, 0.4)]),
    "layers_exclusive": (_font_layers_excl,
                         [(60, 40, 0.0, 0.5), (60, 100, 0.25, 0.7), (64, 100, 0.5, 0.9)]),
    "full_matrix": (lambda p: _one_zone_font(p, _sine_loop(), _gens(
        SAMPLE_MODES=1, HOLD_VOL=1200, ATTACK_VOL=-6000, RELEASE_VOL=-3000, PAN=200,
        INITIAL_FILTER_FC=9000, INITIAL_FILTER_Q=200, VIB_LFO_TO_PITCH=50, MOD_LFO_TO_VOL=60,
        MOD_ENV_TO_PITCH=300, DECAY_MOD_ENV=-2000, MOD_ENV_TO_FILTER_FC=1200,
        MOD_LFO_TO_FILTER_FC=600, REVERB_SEND=300, CHORUS_SEND=300)),
        [(60, 100, 0.0, 0.4), (67, 80, 0.1, 0.5)]),
}


def _sf2_midi(notes, program=None):
    """tests/test_sf2_goldens.py's MIDI builder: notes (key, vel, on_s,
    off_s); 1 tick = 1/960 s at the set tempo."""
    from gandes_tpu_torch.music.midi import Message, MetaMessage, MidiFile, MidiTrack

    mid = MidiFile(type=0, ticks_per_beat=480)
    tr = MidiTrack()
    tr.append(MetaMessage("set_tempo", tempo=500000, time=0))
    events = []
    if program is not None:
        events.append((0.0, Message("program_change", program=program)))
    for key, vel, on, off in notes:
        events.append((on, Message("note_on", note=key, velocity=vel)))
        events.append((off, Message("note_off", note=key, velocity=0)))
    events.sort(key=lambda e: e[0])
    t_prev = 0.0
    for t, msg in events:
        msg.time = int(round((t - t_prev) * 960))
        tr.append(msg)
        t_prev = t_prev + msg.time / 960.0
    tr.append(MetaMessage("end_of_track", time=0))
    mid.tracks.append(tr)
    return mid


def build_gm_font(path, frames=20000, sr=44100):
    """A GM-scale font: 128 programs, each 2 key splits x 2 velocity layers
    of stereo sample pairs (1,024 looped samples of ``frames`` frames, a
    bank of 20.5 M samples, past 2^24 as FluidR3_GM's ~65 M is). Every
    program sends to reverb and chorus; programs 1 mod 4 set the static
    low-pass, 2 mod 4 the LFOs, 3 mod 8 the mod-env pitch and filter sweep;
    program 115 (a GM woodblock) an exclusive class. Returns the bank's
    sample count."""
    import numpy as np

    m = _sf2()
    t = np.arange(frames)
    samples, instruments, presets = [], [], []
    for p in range(128):
        gens = {m.G_SAMPLE_MODES: 1, m.G_ATTACK_VOL: -7200, m.G_HOLD_VOL: -2400,
                m.G_DECAY_VOL: 0, m.G_SUSTAIN_VOL: 150, m.G_RELEASE_VOL: -1800,
                m.G_REVERB_SEND: 150 + p, m.G_CHORUS_SEND: 100}
        if p % 4 == 1:
            gens.update({m.G_INITIAL_FILTER_FC: 8000 + 20 * p, m.G_INITIAL_FILTER_Q: 120})
        if p % 4 == 2:
            gens.update({m.G_VIB_LFO_TO_PITCH: 25, m.G_DELAY_VIB_LFO: -2000,
                         m.G_MOD_LFO_TO_VOL: 30, m.G_FREQ_MOD_LFO: -500})
        if p % 8 == 3:
            gens.update({m.G_MOD_ENV_TO_PITCH: 80, m.G_DECAY_MOD_ENV: -1800,
                         m.G_INITIAL_FILTER_FC: 10000, m.G_MOD_ENV_TO_FILTER_FC: 1800})
        if p == 115:
            gens[m.G_EXCLUSIVE_CLASS] = 1
        zones = []
        for lo, hi, root in ((0, 63, 48), (64, 127, 72)):
            period = sr / (440.0 * 2.0 ** ((root - 69) / 12.0))
            for layer, (vlo, vhi) in enumerate(((0, 79), (80, 127))):
                for side, pan in (("L", -300), ("R", 300)):
                    phase = 0.0 if side == "L" else 0.25
                    wave = sum(np.sin(2 * np.pi * h * (t / period + phase)) / h ** (2 - layer)
                               for h in (1, 2, 3, 5))
                    samples.append({"name": f"p{p}k{root}v{layer}{side}",
                                    "data": (0.3 * wave).astype(np.float32), "sample_rate": sr,
                                    "original_pitch": root, "loop_start": 2000,
                                    "loop_end": frames - 1000})
                    zones.append({"sample": len(samples) - 1, "key_lo": lo, "key_hi": hi,
                                  "vel_lo": vlo, "vel_hi": vhi,
                                  "gens": {**gens, m.G_PAN: pan}})
        instruments.append({"name": f"inst{p}", "zones": zones})
        presets.append({"name": f"prog{p}", "program": p, "zones": [{"instrument": p}]})
    m.build_sf2(path, samples=samples, instruments=instruments, presets=presets, name="gm-scale")
    return len(samples) * (frames + 46)


def _sf2_uses_fft(cols, nv) -> bool:
    return any(cols["fc_hz"][i] > 0.0 or cols["menv_fc"][i] != 0.0 or cols["lfo_fc"][i] != 0.0
               or cols["rev_send"][i] != 0.0 for i in range(nv))


def _mel_gap(spec, ref):
    """Largest dB gap on bins more than 10 dB above the floor, on every bin."""
    above = max(float((spec[i] - ref[i]).abs()[ref[i] > ref[i].min() + 10.0].max())
                for i in range(len(ref)))
    return above, float((spec - ref).abs().max())


def phase_sf2(work_dir):
    """SF2 sample playback on the card (see the module docstring). Returns
    K2's launches on the phase's main paths."""
    import numpy as np
    import torch

    from gandes_tpu_torch import cli
    from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
    from gandes_tpu_torch.data import datasets
    from gandes_tpu_torch.music import sf2, synth
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.serve import GenerationService
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig
    from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

    t_phase = time.perf_counter()
    d = os.path.join(work_dir, "sf2")
    os.makedirs(d)
    failures = []
    font = os.path.join(d, "gm.sf2")
    t = time.perf_counter()
    bank_samples = build_gm_font(font)
    font_build_s = time.perf_counter() - t
    _sync()
    t = time.perf_counter()
    card_synth = synth._get_sf2_synth(font, device=DEVICE)
    _sync()
    font_load_s = time.perf_counter() - t
    if card_synth.bank.numel() != bank_samples or bank_samples <= 1 << 24:
        failures.append(f"bank {card_synth.bank.numel()} samples, expected {bank_samples}")
    t = time.perf_counter()
    torch.from_numpy(card_synth.font.bank).to(DEVICE)
    _sync()
    upload_s = time.perf_counter() - t

    # 1. the golden fixture cases: card vs the CPU port, and a card repeat
    cases = {}
    for name, (build, notes) in SF2_CASES.items():
        path = os.path.join(d, name + ".sf2")
        build(path)
        mid = _sf2_midi(notes)
        card, cpu = sf2.Sf2Synth(path, device=DEVICE), sf2.Sf2Synth(path, device="cpu")
        a = card.render_midi(mid, sr=SF2_SR, min_seconds=1.0)
        b = card.render_midi(mid, sr=SF2_SR, min_seconds=1.0)
        c = cpu.render_midi(mid, sr=SF2_SR, min_seconds=1.0)
        cols, nv, _ = cpu.midi_to_voices(mid, SF2_SR)
        atol = 1e-4 if _sf2_uses_fft(cols, nv) else 2e-5
        err = float(np.abs(a - c).max()) if a.shape == c.shape else math.inf
        flips = int(np.count_nonzero(np.abs(a - c) > atol)) if a.shape == c.shape else a.size
        cases[name] = {"atol": atol, "max_abs_err": err, "past_atol": flips,
                       "repeat_bitwise": bool(np.array_equal(a, b))}
        if flips > 1e-4 * a.size or not cases[name]["repeat_bitwise"] or not np.isfinite(a).all():
            failures.append(f"case {name}: {cases[name]}")

    # 2. GAN-DES requests through the font at serve width
    service = GenerationService(model="gandes", sound_font=font, device=DEVICE)
    t = time.perf_counter()
    service.generate(n=1, seed=0)
    warmup_s = time.perf_counter() - t
    mel_power_cuda.launches = 0
    out = service.generate(n=4, seed=0)
    request_launches = mel_power_cuda.launches
    if request_launches != 4 or out["mel_shape"] != [4, 128, 216]:
        failures.append(f"request: {request_launches} K2 launches, mel_shape {out['mel_shape']}")
    latency = [out["latency_s"], service.generate(n=4, seed=1)["latency_s"]]
    renders = []
    real_render = sf2._render_sf2

    def timed_render(*args, **kw):
        _sync()
        t0 = time.perf_counter()
        audio = real_render(*args, **kw)
        _sync()
        renders.append({"s": time.perf_counter() - t0, "args": args, "kw": kw})
        return audio

    sf2._render_sf2 = timed_render
    try:
        t = time.perf_counter()
        service.generate(n=4, seed=0)
        timed_request_s = time.perf_counter() - t
    finally:
        sf2._render_sf2 = real_render
    clips = [{"voices": int((r["args"][1][2] > 0).sum()), "L": r["args"][4], "W": r["args"][5],
              "render_s": round(r["s"], 4),
              "toggles": sorted(k for k, v in r["kw"].items() if v is True)} for r in renders]
    one = max(renders, key=lambda r: r["s"])
    render_profile = device_busy(lambda: real_render(*one["args"], **one["kw"]))
    emit({"phase": "sf2_profile", "request": device_busy(lambda: service.generate(n=4, seed=2)),
          "one_render": render_profile})

    # the same clips' mels on the card and on the CPU (sims end by count)
    gen, _ = load_gandes_state(GanDesConfig(), device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    mats = gandes_eval_forward(gen)(torch.randn(4, 100, generator=g, device=DEVICE)).cpu().numpy()
    specs = {}
    for dev in (DEVICE, "cpu"):
        np.random.seed(0)
        mel_power_cuda.launches = 0
        t = time.perf_counter()
        specs[dev] = matrix_to_wav(mats, size=20, start=0, end=216, sound_font=font,
                                   out_dir=os.path.join(d, "m2w_" + dev),
                                   log_path=os.path.join(d, "logs_" + dev) + "/",
                                   max_sim_time=60, device=dev).cpu()
        _sync()
        specs[dev + "_s"] = time.perf_counter() - t
        specs[dev + "_launches"] = mel_power_cuda.launches
    db_above, db_all = _mel_gap(specs[DEVICE], specs["cpu"])
    if (specs[DEVICE + "_launches"] != 4 or db_above > 0.05 or db_all > 0.5
            or not bool(torch.isfinite(specs[DEVICE]).all())):
        failures.append(f"card vs cpu mels: {db_above} dB above the floor, {db_all} dB all, "
                        f"{specs[DEVICE + '_launches']} launches")

    # 3. matrix_to_wav(parallel=4) through the font
    np.random.seed(1)
    mel_power_cuda.launches = 0
    t = time.perf_counter()
    par = matrix_to_wav(mats, size=20, start=0, end=216, sound_font=font, parallel=4,
                        out_dir=os.path.join(d, "par"), log_path=os.path.join(d, "logs_par") + "/",
                        device=DEVICE)
    _sync()
    parallel_s = time.perf_counter() - t
    parallel_launches = mel_power_cuda.launches
    if parallel_launches != 4 or tuple(par.shape) != (4, 128, 216):
        failures.append(f"parallel: {parallel_launches} launches, shape {tuple(par.shape)}")

    # 4. sim-to-wav and 5. train-gandes through the font (both write to cwd)
    calls = {"render_midi": 0, "render_events": 0}
    wrapped = {}
    for meth in calls:
        real = getattr(sf2.Sf2Synth, meth)

        def counting(self, *a, _real=real, _name=meth, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        wrapped[meth] = real
        setattr(sf2.Sf2Synth, meth, counting)
    real_items = []
    real_getitem = datasets.MaestroDatasetGanDes.__getitem__
    datasets.MaestroDatasetGanDes.__getitem__ = (
        lambda self, i: real_items.append(real_getitem(self, i)) or real_items[-1])
    cwd = os.getcwd()
    try:
        os.chdir(d)
        os.makedirs("logs")
        t = time.perf_counter()
        cli.main(["sim-to-wav", "--sound-font", font, "--seed", "0", "--out-dir", "sim",
                  "--device", DEVICE])
        sim_s = time.perf_counter() - t
        sim_renders = dict(calls)
        with open(os.path.join("sim", "wav", "output_0.wav"), "rb") as f:
            sim_wav = f.read()
        corpus = os.path.join(work_dir, "gandes_corpus")
        if not os.path.isdir(corpus):
            write_corpus(corpus, n_files=4, seconds=150.0, seed=1)
        for k in calls:
            calls[k] = 0
        mel_power_cuda.launches = 0
        t = time.perf_counter()
        cli.main(["train-gandes", "--midi-root", corpus, "--steps", "2", "--batch-size", "30",
                  "--sound-font", font, "--des-parallel", "16", "--np-seed", "0",
                  "--models-dir", "models", "--device", DEVICE])
        _sync()
        train_s = time.perf_counter() - t
        train_launches = mel_power_cuda.launches
    finally:
        os.chdir(cwd)
        for meth, real in wrapped.items():
            setattr(sf2.Sf2Synth, meth, real)
        datasets.MaestroDatasetGanDes.__getitem__ = real_getitem
    real_slices = sum(len(x) for x in real_items)
    if sim_renders["render_midi"] != 1 or sim_wav[:4] != b"RIFF" or len(sim_wav) < 44100:
        failures.append(f"sim-to-wav: renders {sim_renders}, {len(sim_wav)} WAV bytes")
    if (calls["render_events"] != 60 or calls["render_midi"] != len(real_items)
            or train_launches != 60 + real_slices):
        failures.append(f"train-gandes: renders {calls}, real items {len(real_items)}, "
                        f"{train_launches} K2 launches, {real_slices} real slices")

    row = {"phase": "sf2", "phase_s": round(time.perf_counter() - t_phase, 2),
           "font": {"programs": 128, "samples": 1024, "bank_samples": bank_samples,
                    "build_s": round(font_build_s, 3), "parse_and_upload_s": round(font_load_s, 3),
                    "bank_upload_s": round(upload_s, 4),
                    "bank_mb": round(4 * bank_samples / 2**20, 1)},
           "cases": cases, "warmup_s": round(warmup_s, 3), "latency_s": latency,
           "timed_request_s": round(timed_request_s, 3), "clips": clips,
           "render_s_per_clip": round(sum(c["render_s"] for c in clips) / len(clips), 4),
           "one_render_device_ms": render_profile["device_busy_ms"],
           "request_launches": request_launches,
           "card_vs_cpu": {"db_err_above_floor": db_above, "db_err_all_bins": db_all,
                           "card_s": round(specs[DEVICE + "_s"], 3),
                           "cpu_s": round(specs["cpu_s"], 3)},
           "parallel": {"launches": parallel_launches, "s": round(parallel_s, 3)},
           "sim_to_wav": {"s": round(sim_s, 3), "wav_bytes": len(sim_wav)},
           "train_gandes": {"s": round(train_s, 3), "sf2_renders": calls,
                            "real_slices": real_slices, "launches": train_launches}}
    emit(row)
    if failures:
        raise AssertionError(f"sf2: {failures}")
    return request_launches + specs[DEVICE + "_launches"] + parallel_launches + train_launches


# ------------------------------------------------- slice 10: bf16, trace, tools

BF16_LOSS_RTOL = 2.0 ** -8  # the loss term of tests/test_torch_bf16.py's budget


def _float32_state(modules, optimizers) -> bool:
    """Every floating tensor of the modules' state dicts (params, BatchNorm
    statistics) and of the optimizers' state (Adam moments) is float32."""
    import torch

    tensors = [t for m in modules for t in m.state_dict().values()]
    tensors += [t for opt in optimizers for st in opt.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)]
    return bool(tensors) and all(t.dtype == torch.float32 for t in tensors
                                 if t.is_floating_point())


def _gemm_conv_kernels(fn) -> dict:
    """The device kernels of ``fn`` (traced by torch.profiler) that are
    products or convolutions, split by whether the name names bfloat16."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    names = {ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation}
    dense = sorted(n for n in names if any(k in n.lower() for k in (
        "gemm", "conv", "xmma", "cutlass", "nvjet", "cudnn", "wgrad", "dgrad", "fprop")))
    bf16 = [n for n in dense if any(k in n.lower() for k in ("bf16", "bfloat16"))]
    return {"bf16": [n[:120] for n in bf16],
            "other": [n[:120] for n in dense if n not in bf16]}


def phase_train_bf16(work_dir):
    """``compute_dtype='bf16'`` on both trainers at full width on the card.
    MM-GAN (B = 16, ``des_parallel=16``, phase ``pickle``'s windows): ``none``
    2 epochs + 1 resumed == 3 straight bitwise, captured == eager steps
    bitwise, one epoch each of ``surrogate`` (every knob) and ``reinforce``,
    the decode path each run took, a bf16 checkpoint resumed by a float32
    run. GAN-DES (B = 30, phase ``train_gandes``'s corpus): 2 steps, K2 ==
    fake clips + real slices, a bf16 checkpoint resumed by a float32 run.
    Both: float32 params / Adam moments / BN statistics, the bf16 product
    kernels of one step from a torch.profiler trace, one step of each mode
    card vs CPU port (losses within 2^-8), ``device_step`` p50, the busy
    share of one loop step and the device work of one eager step of each
    mode after two warm-ups, each beside float32's. Returns K2's launches."""
    import random

    import numpy as np
    import torch

    from gandes_tpu_torch.data.datasets import (
        DataLoader,
        MaestroDatasetGanDes,
        MaestroDatasetPickle,
        my_collate,
    )
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.train import gandes_loop, mmgan_loop, steps

    t_phase = time.perf_counter()
    failures = []
    ds = MaestroDatasetPickle(os.path.join(work_dir, "windows.pkl"), data_dir=".")
    base = mmgan_loop.MMGANConfig(compute_dtype="bf16")
    paths = {"log_path": os.path.join(work_dir, "logs") + "/",
             "midi_out_dir": os.path.join(work_dir, "midi")}
    knobs = {"instance_noise_sigma": 2.0, "instance_noise_anneal_epochs": 2.0,
             "instance_noise_floor": 0.5, "r1_gamma": 1.0, "moment_match": 1.0,
             "moment_match_cond": 1.0}

    def run(name, epochs, **kw):
        cfg = mmgan_loop.MMGANConfig(**{**paths, "num_epochs": epochs, "profile": True,
                                        "des_parallel": 16, "compute_dtype": "bf16",
                                        "models_dir": os.path.join(work_dir, name),
                                        "losses_dir": os.path.join(work_dir, name + "_l"), **kw})
        t = time.perf_counter()
        state, hist = mmgan_loop.train_mmgan(ds, cfg, max_batches=3, device=DEVICE)
        _sync()
        wall = time.perf_counter() - t
        return state, {**_loop_run_summary(state, hist, wall, []),
                       "decode_path": hist["decode_path"], "d_loss": hist["disc"],
                       "g_loss": hist["gen"]}

    np.random.seed(0)
    _, none_2 = run("bf16_none", 2)
    resumed, none_resumed = run("bf16_none", 3)
    np.random.seed(0)
    straight, none_3 = run("bf16_straight", 3)
    resume_equal = (_states_equal(resumed, straight)
                    and none_2["d_loss"] + none_resumed["d_loss"] == none_3["d_loss"])
    np.random.seed(0)
    _, f32_none = run("f32_none", 2, compute_dtype="float32")
    np.random.seed(0)
    sur_state, surrogate = run("bf16_surrogate", 1, g_update="surrogate", **knobs)
    np.random.seed(0)
    rei_state, reinforce = run("bf16_reinforce", 1, g_update="reinforce")
    crossed, crossed_f32 = run("bf16_straight", 4, compute_dtype="float32")
    mm_float32 = all(_float32_state([st.model], [st.g_opt, st.d_opt])
                     for st in (straight, sur_state, rei_state, crossed))
    crossed_ok = (crossed.step == straight.step + 3
                  and crossed.model.discriminator.compute_dtype == torch.float32)

    # step level on the windows: captured == eager at bf16, the product
    # kernels of one eager step, one step of each mode card vs CPU
    def batch(i, device):
        items = [ds[k] for k in range(i * base.batch_size, (i + 1) * base.batch_size)]
        real = np.stack([np.stack([r, d]) for r, d, _ in items]).astype(np.float32)
        beats = np.stack([b for _, _, b in items]).astype(np.float32)
        return torch.from_numpy(real).to(device), torch.from_numpy(beats).to(device)

    def states(n, device, **kw):
        cfg = mmgan_loop.MMGANConfig(**{"compute_dtype": "bf16", **kw})
        out = [mmgan_loop.init_state_for_config(cfg, 1, device=device) for _ in range(n)]
        return [s for s, _ in out], out[0][1]

    (eager, captured), scheds = states(2, DEVICE)
    step = steps.make_mmgan_train_step(*scheds, g_update="direct")
    graphed = steps.graph_step(steps.make_mmgan_train_step(*scheds, g_update="direct"))
    fwd, fwd_graph = steps.make_mmgan_gen_forward(), steps.graph_gen_forward(
        steps.make_mmgan_gen_forward())
    captured_equal = True
    for i in range(3):
        real, beats = batch(i, DEVICE)
        fake = batch(i + 3, DEVICE)[0]
        n1, n2, aux = mmgan_loop.draw_step_inputs(0, i + 1, base.batch_size, base.noise_dim,
                                                  DEVICE)
        ga, gb = fwd(eager, n1, n2, beats, aux), fwd_graph(captured, n1, n2, beats, aux)
        _, m_e = step(eager, real, fake, n1, n2, beats, aux)
        _, m_g = graphed(captured, real, fake, n1, n2, beats, aux)
        captured_equal &= (all(torch.equal(a, b) for a, b in zip(ga, gb))
                           and all(torch.equal(m_e[k], m_g[k]) for k in m_e))
    _sync()
    captured_equal &= _states_equal(eager, captured)
    mm_kernels = _gemm_conv_kernels(lambda: step(eager, real, fake, n1, n2, beats, aux))

    def one_step(device, mode):
        (st,), sch = states(1, device)
        real, beats = batch(0, device)
        fake = batch(1, device)[0]
        n1, n2, aux = mmgan_loop.draw_step_inputs(0, 1, base.batch_size, base.noise_dim, device)
        rng = np.random.RandomState(5)
        mats = torch.from_numpy(rng.rand(base.batch_size, 64, 64).astype(np.float32)).to(device)
        vec = torch.from_numpy(rng.rand(base.batch_size, 20).astype(np.float32)).to(device)
        if mode == "surrogate":
            s_st = mmgan_loop.init_surrogate_for_config(base, device)
            fn = steps.make_mmgan_train_step_surrogate(
                *sch, instance_noise=(2.0, 16), instance_noise_floor=0.5, r1_gamma=1.0,
                moment_match=1.0, moment_match_cond=1.0)
            m = fn(st, s_st, real, fake, mats, vec, n1, n2, beats, aux)[-1]
        elif mode == "reinforce":
            fn = steps.make_mmgan_train_step_reinforce(*sch, base.reinforce_sigma)
            m = fn(st, real, fake, mats, vec, n1, n2, beats, aux)[-1]
        else:
            m = steps.make_mmgan_train_step(*sch, g_update=mode)(
                st, real, fake, n1, n2, beats, aux)[-1]
        return {k: float(v) for k, v in m.items()}

    mm_vs_cpu = {}
    for mode in ("none", "direct", "surrogate", "reinforce"):
        card, cpu = one_step(DEVICE, mode), one_step("cpu", mode)
        rel = {k: _rel_err(card[k], cpu[k]) for k in card}
        mm_vs_cpu[mode] = {"card": card, "cpu": cpu, "rel_err": rel}
        # reinforce's G loss cancels logprobs of ~-2,000 down to ~2: printed
        if any(v > BF16_LOSS_RTOL for k, v in rel.items()
               if not (mode == "reinforce" and k == "g_loss")):
            failures.append(f"MM-GAN {mode} card vs CPU losses {rel}")

    def mm_busy(compute_dtype):
        cfg = mmgan_loop.MMGANConfig(compute_dtype=compute_dtype, des_parallel=16, **paths)
        st, sch = mmgan_loop.init_state_for_config(cfg, 3, device=DEVICE)
        g_fwd = steps.graph_gen_forward(steps.make_mmgan_gen_forward())
        g_step = steps.graph_step(steps.make_mmgan_train_step(*sch))
        decode = mmgan_loop.make_decode(cfg)
        real, beats = batch(0, DEVICE)

        def loop_step(count):
            a1, a2, ax = mmgan_loop.draw_step_inputs(0, count, base.batch_size, base.noise_dim,
                                                     DEVICE)
            m, v = g_fwd(st, a1, a2, beats, ax)
            g_step(st, real, decode(m, v, count)[0])

        loop_step(1)
        loop_step(2)
        return device_busy(lambda: loop_step(3))

    mm_busy_share = {"bf16": mm_busy("bf16"), "float32": mm_busy("float32")}

    def step_work(fn):
        """The device work of one eager step after two warm-up steps (the
        first calls of a shape load and pick cuDNN's kernels)."""
        fn()
        fn()
        prof = device_busy(fn)
        return {"wall_ms": prof["wall_ms"], "device_ms": prof["device_busy_ms"],
                "top": prof["top"][:3]}

    def mm_step_fn(mode, compute_dtype):
        cfg = mmgan_loop.MMGANConfig(compute_dtype=compute_dtype)
        st, sch = mmgan_loop.init_state_for_config(cfg, 1, device=DEVICE)
        real, beats = batch(0, DEVICE)
        fake = batch(1, DEVICE)[0]
        n1, n2, aux = mmgan_loop.draw_step_inputs(0, 1, base.batch_size, base.noise_dim, DEVICE)
        rng = np.random.RandomState(5)
        mats = torch.from_numpy(rng.rand(base.batch_size, 64, 64).astype(np.float32)).to(DEVICE)
        vec = torch.from_numpy(rng.rand(base.batch_size, 20).astype(np.float32)).to(DEVICE)
        if mode == "surrogate":
            s_st = mmgan_loop.init_surrogate_for_config(cfg, DEVICE)
            fn = steps.make_mmgan_train_step_surrogate(
                *sch, instance_noise=(2.0, 16), instance_noise_floor=0.5, r1_gamma=1.0,
                moment_match=1.0, moment_match_cond=1.0)
            return lambda: fn(st, s_st, real, fake, mats, vec, n1, n2, beats, aux)
        if mode == "reinforce":
            fn = steps.make_mmgan_train_step_reinforce(*sch, base.reinforce_sigma)
            return lambda: fn(st, real, fake, mats, vec, n1, n2, beats, aux)
        fn = steps.make_mmgan_train_step(*sch, g_update=mode)
        return lambda: fn(st, real, fake, n1, n2, beats, aux)

    mm_step_work = {mode: {dt: step_work(mm_step_fn(mode, dt)) for dt in ("bf16", "float32")}
                    for mode in ("none", "direct", "surrogate", "reinforce")}

    # GAN-DES
    corpus = os.path.join(work_dir, "gandes_corpus")
    counted = {"clips": 0, "slices": 0}
    real_m2w = gandes_loop.matrix_to_wav

    def counting_m2w(mats, **kw):
        counted["clips"] += len(mats)
        return real_m2w(mats, **kw)

    class Counting:
        def __iter__(self):
            data = MaestroDatasetGanDes(batch_size=30, input_folder=corpus, device=DEVICE)
            for b in DataLoader(data, batch_size=1, shuffle=True, collate_fn=my_collate):
                counted["slices"] += len(b)
                yield b

    def gd_run(name, max_steps, **kw):
        cfg = gandes_loop.GanDesConfig(**{
            "model_path": os.path.join(work_dir, name),
            "log_path": os.path.join(work_dir, name + "_logs") + "/",
            "out_dir": os.path.join(work_dir, name + "_out"), "des_parallel": 16,
            "write_wav": False, "profile": True, "display_step": 100, "save_step": 1,
            "resume": True, "compute_dtype": "bf16", **kw})
        np.random.seed(0)
        random.seed(0)
        t = time.perf_counter()
        state, hist = gandes_loop.train_gandes(Counting(), cfg, max_steps=max_steps,
                                               device=DEVICE)
        _sync()
        wall = time.perf_counter() - t
        prof = hist["profile"]
        n = prof["device_step"]["count"]
        return state, {"steps": n, "wall_s": round(wall, 3), "steps_per_s": round(n / wall, 4),
                       "host_des_p50_s": prof["host_des"]["p50_s"],
                       "device_step_p50_s": prof["device_step"]["p50_s"],
                       "d_loss": hist["disc"], "g_loss": hist["gen"],
                       "losses_finite": all(math.isfinite(v) for k in ("disc", "gen")
                                            for v in hist[k])}

    gandes_loop.matrix_to_wav = counting_m2w
    mel_power_cuda.launches = 0
    try:
        gd_state, gd_bf16 = gd_run("gd_bf16", 2)
        k2 = mel_power_cuda.launches
        bf16_counts = dict(counted)
        _, gd_f32 = gd_run("gd_f32", 2, compute_dtype="float32")
        gd_crossed, gd_crossed_f32 = gd_run("gd_bf16", 3, compute_dtype="float32")
    finally:
        gandes_loop.matrix_to_wav = real_m2w
    gd_float32 = all(_float32_state([s.gen, s.disc], [s.g_opt, s.d_opt])
                     for s in (gd_state, gd_crossed))
    gd_crossed_ok = gd_crossed.step == 3 and gd_crossed.disc.compute_dtype == torch.float32

    def gd_inputs(device, batch_size=8):
        rng = np.random.RandomState(0)
        real, fake = (torch.from_numpy(rng.rand(batch_size, 128, 216).astype(np.float32)
                                       * 4.0 - 4.0).to(device) for _ in range(2))
        noise = torch.from_numpy(rng.randn(batch_size, 100).astype(np.float32)).to(device)
        mats = torch.from_numpy(rng.rand(batch_size, 20, 20).astype(np.float32)).to(device)
        return real, fake, noise, mats

    def gd_one_step(device, mode):
        cfg = gandes_loop.GanDesConfig(compute_dtype="bf16")
        st = gandes_loop.init_state_for_config(cfg, device)
        real, fake, noise, mats = gd_inputs(device)
        if mode == "surrogate":
            s_st = gandes_loop.init_surrogate_for_config(cfg, device)
            m = steps.make_gandes_train_step_surrogate()(st, s_st, real, fake, mats, noise)[-1]
        elif mode == "reinforce":
            m = steps.make_gandes_train_step_reinforce(cfg.reinforce_sigma)(
                st, real, fake, mats, noise)[-1]
        else:
            m = steps.make_gandes_train_step()(st, real, fake)[-1]
        return {k: float(v) for k, v in m.items()}

    gd_vs_cpu = {}
    for mode in ("none", "surrogate", "reinforce"):
        card, cpu = gd_one_step(DEVICE, mode), gd_one_step("cpu", mode)
        rel = {k: _rel_err(card[k], cpu[k]) for k in card}
        gd_vs_cpu[mode] = {"card": card, "cpu": cpu, "rel_err": rel}
        if any(v > BF16_LOSS_RTOL for v in rel.values()):
            failures.append(f"GAN-DES {mode} card vs CPU losses {rel}")
    gd_state_k = gandes_loop.init_state_for_config(gandes_loop.GanDesConfig(compute_dtype="bf16"),
                                                   DEVICE)
    gd_real, gd_fake = gd_inputs(DEVICE, 30)[:2]
    gd_step = steps.make_gandes_train_step()
    gd_kernels = _gemm_conv_kernels(lambda: gd_step(gd_state_k, gd_real, gd_fake))

    def gd_busy(compute_dtype):
        cfg = gandes_loop.GanDesConfig(compute_dtype=compute_dtype)
        st = gandes_loop.init_state_for_config(cfg, DEVICE)
        forward = steps.make_gandes_gen_forward()
        busy_dir = os.path.join(work_dir, "busy_" + compute_dtype)
        os.makedirs(busy_dir, exist_ok=True)

        def loop_step(count):
            z = gandes_loop.draw_step_inputs(0, count, 30, cfg.z_dim, DEVICE)[0]
            fake = real_m2w(forward(st, z).cpu().numpy(), size=20, start=0, end=216,
                            log_path=busy_dir + "/", out_dir=busy_dir, parallel=16,
                            write_wav=False, device=DEVICE)
            gd_step(st, gd_real, fake)

        loop_step(0)
        return device_busy(lambda: loop_step(1))

    gd_busy_share = {"bf16": gd_busy("bf16"), "float32": gd_busy("float32")}

    def gd_step_fn(compute_dtype):
        st = gandes_loop.init_state_for_config(
            gandes_loop.GanDesConfig(compute_dtype=compute_dtype), DEVICE)
        return lambda: gd_step(st, gd_real, gd_fake)

    gd_step_work = {dt: step_work(gd_step_fn(dt)) for dt in ("bf16", "float32")}
    k2_all = mel_power_cuda.launches

    checks = {"mmgan_resume_bitwise": resume_equal, "mmgan_captured_eq_eager": captured_equal,
              "mmgan_float32_state": mm_float32, "mmgan_bf16_ckpt_into_f32": crossed_ok,
              "mmgan_bf16_kernels": bool(mm_kernels["bf16"]),
              "gandes_float32_state": gd_float32, "gandes_bf16_ckpt_into_f32": gd_crossed_ok,
              "gandes_bf16_kernels": bool(gd_kernels["bf16"]),
              "gandes_k2_eq_clips_plus_slices": (
                  k2 == bf16_counts["clips"] + bf16_counts["slices"] and k2 > 0),
              "losses_finite": all(r["losses_finite"] for r in (
                  none_3, surrogate, reinforce, crossed_f32, gd_bf16, gd_crossed_f32))}
    failures += [k for k, v in checks.items() if not v]
    row = {"phase": "train_bf16", "phase_s": round(time.perf_counter() - t_phase, 2),
           "checks": checks,
           "mmgan": {"none_2": none_2, "none_resumed_to_3": none_resumed, "none_3": none_3,
                     "float32_none_2": f32_none, "surrogate_all_knobs": surrogate,
                     "reinforce": reinforce, "bf16_ckpt_resumed_float32": crossed_f32,
                     "decode_path": {"none": none_3["decode_path"],
                                     "surrogate": surrogate["decode_path"],
                                     "reinforce": reinforce["decode_path"]},
                     "vs_cpu": mm_vs_cpu, "kernels": mm_kernels,
                     "loop_step_busy": mm_busy_share, "step_device_work": mm_step_work},
           "gandes": {"bf16_2": gd_bf16, "float32_2": gd_f32,
                      "bf16_ckpt_resumed_float32": gd_crossed_f32,
                      "k2_launches": k2, "fake_clips": bf16_counts["clips"],
                      "real_slices": bf16_counts["slices"], "vs_cpu": gd_vs_cpu,
                      "kernels": gd_kernels, "loop_step_busy": gd_busy_share,
                      "none_step_device_work": gd_step_work}}
    emit(row)
    if failures:
        raise AssertionError(f"train_bf16: {failures}")
    return k2_all


def _trace_kernels(logdir) -> list:
    """The device kernel names of the one Chrome trace in ``logdir``."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [ev["name"] for ev in events if ev.get("cat") == "kernel"]


def phase_trace(work_dir):
    """``train-gandes --trace-dir`` (one step, B = 30) and ``train-mmgan
    --trace-dir`` (one batch, B = 16) through ``cli.main`` on the card: each
    trace exists and names the step's cuDNN kernels, the GAN-DES one also
    ``mel_power``. Returns K2's launches."""
    from collections import Counter

    from gandes_tpu_torch import cli
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    d = os.path.join(work_dir, "trace_phase")
    os.makedirs(os.path.join(d, "logs"))
    mel_power_cuda.launches = 0
    try:
        os.chdir(d)
        t = time.perf_counter()
        cli.main(["train-gandes", "--midi-root", os.path.join(work_dir, "gandes_corpus"),
                  "--steps", "1", "--batch-size", "30", "--des-parallel", "16", "--np-seed",
                  "0", "--models-dir", "gmodels", "--trace-dir", "trace_gandes", "--device",
                  DEVICE])
        _sync()
        gandes_s = time.perf_counter() - t
        t = time.perf_counter()
        cli.main(["train-mmgan", "--data", os.path.join(work_dir, "windows.pkl"), "--epochs",
                  "1", "--max-batches", "1", "--des-parallel", "16", "--np-seed", "0",
                  "--models-dir", "mmodels", "--losses-dir", "mlosses", "--trace-dir",
                  "trace_mmgan", "--device", DEVICE])
        _sync()
        mmgan_s = time.perf_counter() - t
        traces = {name: _trace_kernels(name) for name in ("trace_gandes", "trace_mmgan")}
        sizes = {name: os.path.getsize(glob.glob(os.path.join(name, "*.pt.trace.json"))[0])
                 for name in traces}
    finally:
        os.chdir(cwd)
    launches = mel_power_cuda.launches

    def cudnn(names):
        return sorted({n[:100] for n in names if any(k in n.lower() for k in (
            "cudnn", "conv", "xmma", "implicit", "wgrad", "dgrad", "fprop"))})

    found = {name: {"kernels": len(k), "mel_power": sum("mel_power" in n for n in k),
                    "cudnn": cudnn(k)[:12],
                    "top": [f"{c} x {n[:80]}" for n, c in Counter(k).most_common(5)]}
             for name, k in traces.items()}
    row = {"phase": "trace", "phase_s": round(time.perf_counter() - t_phase, 2),
           "train_gandes_s": round(gandes_s, 3), "train_mmgan_s": round(mmgan_s, 3),
           "trace_bytes": sizes, "found": found, "k2_launches": launches}
    emit(row)
    if (not found["trace_gandes"]["mel_power"] or not found["trace_gandes"]["cudnn"]
            or not found["trace_mmgan"]["cudnn"] or launches <= 0):
        raise AssertionError(f"trace: {found}")
    return launches


def phase_doctor():
    """``python -m gandes_tpu_torch.cli doctor`` in a process of its own on
    the card: exit code 0 and every row ``ok``, K1 and K2 through their
    kernels."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gandes_tpu_torch.cli", "doctor", "--device",
                           DEVICE], cwd=repo, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t
    rows = [line for line in proc.stdout.splitlines()
            if line.strip() and line != "all checks passed"]
    status = {line[:22].strip(): line[22:].split()[0] for line in rows if len(line) > 22}
    row = {"phase": "doctor", "s": round(wall, 2), "rc": proc.returncode, "rows": rows,
           "stderr_tail": proc.stderr[-400:]}
    emit(row)
    kernel_rows = [r for r in rows if r.startswith(("mel front-end (K2)", "roll rasterizer (K1)"))]
    if (proc.returncode != 0 or len(rows) != 9 or set(status.values()) != {"ok"}
            or len(kernel_rows) != 2
            or not all(("K2 (mel_power.cu)" in r or "K1 (roll_rasterize.cu)" in r)
                       for r in kernel_rows)):
        raise AssertionError(f"doctor: rc {proc.returncode}, {rows}")


def phase_generate_gandes(work_dir):
    """``generate-gandes``'s generation function on phase ``train_gandes``'s
    newest checkpoint, n = 4, on the card: 4 WAVs, K2 4 times, finite mels of
    shape (4, 128, 216). Then the command through ``cli.main``: with
    matplotlib it writes ``spectrogram.png``; without it exits non-zero
    naming matplotlib after writing the WAVs. Returns K2's launches."""
    import importlib.util

    import torch

    from gandes_tpu_torch import cli
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda

    t_phase = time.perf_counter()
    ckpt = max(glob.glob(os.path.join(work_dir, "straight", "gen_*")),
               key=lambda p: int(os.path.basename(p).split("_")[1]))
    cwd = os.getcwd()
    d = os.path.join(work_dir, "generate_phase")
    os.makedirs(os.path.join(d, "logs"))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    try:
        os.chdir(d)
        mel_power_cuda.launches = 0
        t = time.perf_counter()
        specs = cli.generate_gandes(ckpt, n=4, seed=0, out_dir="gen", device=DEVICE)
        _sync()
        gen_s = time.perf_counter() - t
        fn_launches = mel_power_cuda.launches
        wavs = sorted(os.listdir(os.path.join("gen", "wav")))
        argv = ["generate-gandes", "--torch-checkpoint", ckpt, "--n", "4", "--out-dir", "cli",
                "--device", DEVICE]
        exit_code, message = 0, ""
        if has_mpl:
            cli.main(argv)
        else:
            try:
                cli.main(argv)
            except SystemExit as e:  # the command's own exit: no matplotlib
                exit_code, message = e.code, str(e.code)
        cli_wavs = sorted(os.listdir(os.path.join("cli", "wav")))
        spectrogram = os.path.exists(os.path.join("cli", "spectrogram.png"))
    finally:
        os.chdir(cwd)
    launches = mel_power_cuda.launches
    row = {"phase": "generate_gandes", "phase_s": round(time.perf_counter() - t_phase, 2),
           "checkpoint": os.path.basename(ckpt), "generate_s": round(gen_s, 3),
           "function_k2_launches": fn_launches, "wavs": wavs,
           "mel_shape": list(specs.shape), "finite": bool(torch.isfinite(specs).all()),
           "matplotlib": has_mpl, "cli_wavs": cli_wavs, "cli_exit": exit_code,
           "cli_message": message, "spectrogram_png": spectrogram, "k2_launches": launches}
    emit(row)
    expected_cli = (spectrogram if has_mpl
                    else (exit_code not in (0, None) and "matplotlib" in message
                          and not spectrogram))
    if (fn_launches != 4 or len(wavs) != 4 or row["mel_shape"] != [4, 128, 216]
            or not row["finite"] or len(cli_wavs) != 4 or not expected_cli
            or launches != 8):
        raise AssertionError(f"generate_gandes: {row}")
    return launches


def phase_composite(work_dir):
    """``MultiModalGAN`` at ``MMGANConfig()`` width on the card with
    ``decode=None``: a train-mode forward (B = 3, a CPU copy's aux and
    routing seed) through its own ``matrix_to_midi`` returns finite (3, 1)
    logits and a failed count; the same forward on the CPU copy is printed
    beside (the decode may flip notes on last-bit differences of G);
    ``generate_midi`` writes ``generation.mid``. ``SimNN`` on the card vs a
    CPU copy (atol 1e-4)."""
    import copy

    import numpy as np
    import torch

    from gandes_tpu_torch.models import MultiModalGAN, SimNN

    d = os.path.join(work_dir, "composite")
    kw = dict(instrument=0, start=100, end=150, log_path=os.path.join(d, "logs") + "/",
              out_dir=os.path.join(d, "midi"))
    os.makedirs(kw["log_path"])
    cpu_model = MultiModalGAN(**kw)
    model = copy.deepcopy(cpu_model).to(DEVICE)
    rng = np.random.RandomState(3)
    noise1, noise2, aux = (rng.randn(3, 50).astype(np.float32) for _ in range(3))
    beats = np.zeros((3, 50), np.float32)
    t = time.perf_counter()
    np.random.seed(3)
    logits, failed = model(noise1, noise2, beats, count=1, aux=aux)
    forward_s = time.perf_counter() - t
    np.random.seed(3)
    cpu_logits, cpu_failed = cpu_model(noise1, noise2, beats, count=1, aux=aux)
    gap = float((logits.detach().cpu() - cpu_logits.detach()).abs().max())
    rolls = model.generate_midi(noise1[:1], noise2[:1], beats[:1])
    with open(os.path.join(kw["out_dir"], "generation.mid"), "rb") as f:
        head = f.read(4)
    simnn = SimNN(10)
    x = torch.from_numpy(rng.randn(2, 1, 64, 64).astype(np.float32))
    with torch.no_grad():
        heads_gap = max(float((a.cpu() - b).abs().max())
                        for a, b in zip(copy.deepcopy(simnn).to(DEVICE)(x.to(DEVICE)), simnn(x)))
    row = {"phase": "composite", "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()), "failed": failed,
           "cpu_failed": cpu_failed, "logits_cuda_vs_cpu": gap, "forward_s": round(forward_s, 3),
           "generation_mid": head.decode(errors="replace"), "roll_shape": list(rolls[0].shape),
           "simnn_cuda_vs_cpu": heads_gap}
    emit(row)
    if (row["logits_shape"] != [3, 1] or not row["finite"] or not 0 <= failed <= 3
            or head != b"MThd" or row["roll_shape"] != [2, 128, 50] or heads_gap > 1e-4):
        raise AssertionError(f"composite: {row}")


BENCH_METRICS = (
    "mmgan_train_step_mfu_pct", "mmgan_fused_train_steps_per_sec_sustained",
    "mmgan_full_pipeline_steps_per_sec", "mmgan_train_steps_per_sec_scan64",
    "des_engine_customers_per_sec_logged", "mel_5s_216f_ms", "piano_roll_ms_per_roll",
    "mmgan_host_stage_s_per_batch", "mmgan_train_step_samples_per_sec_B1024",
    "mmgan_train_step_mfu_pct_B1024", "mmgan_train_step_samples_per_sec_B1024_bf16",
    "serve_warm_latency_p50_s", "mmgan_fused_train_steps_per_sec")


def phase_bench(smi):
    """``python -m gandes_tpu_torch.cli bench --all`` in its own process
    (``GANDES_BENCH_DEADLINE_S=240``): exit 0, no row failed or skipped on
    stderr, every metric of ``BENCH_METRICS`` present and finite, the
    headline the last line, and K2 and K1 each launched in that run (the
    counts it notes on stderr as ``# launches mel_power N roll_rasterize M``;
    they start at 0 in the new process). Returns (K2, K1) launches."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GANDES_BENCH_DEADLINE_S="240",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gandes_tpu_torch.cli", "bench", "--all",
                           "--device", DEVICE], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=330)
    wall = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    by_name = {r["metric"]: r for r in rows}
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
    bad_stderr = [ln for ln in notes if "row failed" in ln or "row skipped" in ln]
    missing = [m for m in BENCH_METRICS
               if m not in by_name or not math.isfinite(by_name[m]["value"])]
    counted = [ln.split() for ln in notes if ln.startswith("# launches ")]
    launches = (int(counted[-1][3]), int(counted[-1][5])) if counted else (0, 0)
    row = {"phase": "bench", "nvidia_smi": smi, "s": round(wall, 2), "rc": proc.returncode,
           "rows": rows, "stderr_notes": notes,
           "launches": {"mel_power": launches[0], "roll_rasterize": launches[1]}}
    emit(row)
    headline_last = bool(rows) and lines[-1].startswith("{") \
        and json.loads(lines[-1])["metric"] == BENCH_METRICS[-1]
    if (proc.returncode != 0 or bad_stderr or missing or not headline_last
            or min(launches) < 1):
        raise AssertionError(f"bench: rc {proc.returncode}, missing {missing}, stderr "
                             f"{bad_stderr}, headline last {headline_last}, launches "
                             f"{launches}; {proc.stderr[-1500:]}")
    return launches


def phase_demo(work_dir):
    """``python -m gandes_tpu_torch.demo --out OUT`` in its own process on the
    card: exit 0; the preset WAVs, ``mmgan/generation.mid`` (``MThd``) and
    ``generation.wav`` (``RIFF``) non-empty; the plots written where
    matplotlib is installed, else each named as skipped."""
    import importlib.util

    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(work_dir, "demo")
    os.makedirs(d)
    out = os.path.join(d, "demo_out")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gandes_tpu_torch.demo", "--out", out,
                           "--device", DEVICE], cwd=d, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t
    files = {os.path.relpath(p, out): os.path.getsize(p)
             for p in glob.glob(os.path.join(out, "**", "*"), recursive=True)
             if os.path.isfile(p)}
    heads = {}
    for name in ("mmgan/generation.mid", "generation.wav"):
        if name in files:
            with open(os.path.join(out, name), "rb") as f:
                heads[name] = f.read(4)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    plots = ("piano_roll.png", "spectrogram.png", "simulation.gif")
    row = {"phase": "demo", "s": round(wall, 2), "rc": proc.returncode, "files": files,
           "matplotlib": has_mpl, "stdout_tail": proc.stdout[-600:],
           "stderr_tail": proc.stderr[-600:]}
    emit(row)
    plots_ok = (all(files.get(p, 0) > 0 for p in plots) if has_mpl
                else all(f"{p} skipped: matplotlib" in proc.stdout for p in plots))
    presets = [f"preset_{n}/wav/output_0.wav" for n in ("piano", "marimba", "organ")]
    if (proc.returncode != 0 or heads.get("mmgan/generation.mid") != b"MThd"
            or heads.get("generation.wav") != b"RIFF" or not plots_ok
            or not all(files.get(p, 0) > 0 for p in presets)
            or not all(size > 0 for size in files.values())):
        raise AssertionError(f"demo: {row}")


def _mesh_fused_rank(ckpt_path, inputs, work_dir, device):
    """One rank of phase ``mesh``'s fused-step check (run on every rank of a
    (2, 1) mesh): the fused step with ``callback_device=mesh`` and the
    sharded two-phase path from two copies of one sharded state, after the
    same numpy seed on rank 0. Returns, on rank 0, whether every output is
    bitwise equal."""
    import copy

    import numpy as np
    import torch

    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi
    from gandes_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_state, unshard_state
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train import mmgan_loop
    from gandes_tpu_torch.train.fused_callback import make_mmgan_full_step_io
    from gandes_tpu_torch.train.steps import make_mmgan_gen_forward, make_mmgan_train_step

    mesh = make_mesh(dp=2, tp=1, device=device)
    cfg = mmgan_loop.MMGANConfig()
    template, (g_sched, d_sched) = mmgan_loop.init_state_for_config(cfg, device=mesh.device)
    state = shard_state(ckpt.restore_state(ckpt_path, template), mesh)
    rows = shard_batch({k: torch.from_numpy(v).to(mesh.device) for k, v in inputs.items()}, mesh)
    B, count = len(inputs["real"]), 3
    paths = dict(log_path=os.path.join(work_dir, "mesh_fused_logs") + "/",
                 out_dir=os.path.join(work_dir, "mesh_fused_midi"))
    args = (rows["noise1"], rows["noise2"], rows["beats"], rows["aux"])
    if mesh.lead:
        np.random.seed(3)
    fused = make_mmgan_full_step_io(g_sched, d_sched, batch_size=B, des_parallel=16,
                                    callback_device=mesh, **paths)
    s1, mats1, _, m1 = fused(copy.deepcopy(state), rows["real"], *args[:3], count, args[3])

    def decode(m, v):
        rolls, failed = matrix_to_midi(m.cpu().numpy()[:, None], v.cpu().numpy(),
                                       adj_size=cfg.adj_size, instrument=cfg.instrument,
                                       start=cfg.start, end=cfg.start + cfg.sequence_length,
                                       count=count, parallel=16, **paths)
        return torch.from_numpy(np.stack(rolls)).float(), failed

    if mesh.lead:
        np.random.seed(3)
    s2 = copy.deepcopy(state)
    mats2, vec2 = make_mmgan_gen_forward()(s2, *args)
    fake, failed = mesh.host_stage(decode, (B, 2, 128, cfg.sequence_length), mats2, vec2)
    s2, m2 = make_mmgan_train_step(g_sched, d_sched, mesh=mesh)(s2, rows["real"], fake)
    m2 = {**mesh.mean_metrics(m2), "failed_simulations": failed}
    full1, full2 = unshard_state(s1), unshard_state(s2)
    sd1, sd2 = full1.model.state_dict(), full2.model.state_dict()
    equal = (torch.equal(mats1, mats2)
             and all(float(m1[k]) == float(m2[k]) for k in m2)
             and all(torch.equal(sd1[k], sd2[k]) for k in sd2)
             and all(torch.equal(a[k], b[k]) for a, b in zip(full1.d_opt.state.values(),
                                                            full2.d_opt.state.values())
                     for k in a))
    return {"bitwise": equal, "d_loss": float(m1["d_loss"]),
            "failed": int(m1["failed_simulations"]), "rank0_rows": len(rows["real"])}


def _mesh_f64_rank(inputs, steps, device, mesh_shape=None):
    """Phase ``mesh``'s float64 check: ``steps`` MM-GAN ``surrogate`` steps
    from ``MMGANConfig()``'s initial states converted to float64, each the
    train-mode G forward then the step on ``inputs`` (global numpy; this
    rank's rows under ``mesh_shape``, one device without). Returns G's
    global outputs at each step, the unsharded model's tensors and G's
    Adam first moments."""
    import numpy as np
    import torch

    from gandes_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_state, unshard_state
    from gandes_tpu_torch.train import mmgan_loop
    from gandes_tpu_torch.train import steps as st

    mesh = None if mesh_shape is None else make_mesh(dp=mesh_shape[0], tp=mesh_shape[1],
                                                     device=device)
    dev = torch.device(device) if mesh is None else mesh.device
    t = {k: torch.from_numpy(v).to(dev, torch.float64) for k, v in inputs.items()}
    rows = t if mesh is None else shard_batch(t, mesh)
    cfg = mmgan_loop.MMGANConfig()
    # made on the CPU (Adams that keep a float learning rate), then moved
    state, scheds = mmgan_loop.init_state_for_config(cfg, device="cpu")
    state.model.to(dev, torch.float64)
    s_state = mmgan_loop.init_surrogate_for_config(cfg, device="cpu")
    s_state.model.to(dev, torch.float64)
    if mesh is not None:
        state, s_state = shard_state(state, mesh), shard_state(s_state, mesh)
    step = st.make_mmgan_train_step_surrogate(*scheds, balance_seed=cfg.seed, mesh=mesh)
    g_in = [rows[k] for k in ("noise1", "noise2", "beats", "aux")]
    outs = []
    for _ in range(steps):
        mats, vec = st.make_mmgan_gen_forward()(state, *g_in)
        outs.append([(o if mesh is None else mesh.gather_rows(o)).cpu().numpy()
                     for o in (mats, vec)])
        state, s_state, _ = step(state, s_state, rows["real"], rows["fake"], mats, vec, *g_in)
    if mesh is not None:
        state = unshard_state(state)
    g = st.g_parameters(state.model)
    return {"outs": outs,
            "sd": {k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
            "g_mu": [state.g_opt.state[p]["exp_avg"].cpu().numpy() for p in g],
            "dtype": str(next(state.model.parameters()).dtype)}


def phase_mesh(work_dir):
    """Phase 22 (module docstring). Returns K2's launches on the GAN-DES
    mesh run."""
    import random

    import numpy as np
    import torch

    from gandes_tpu_torch.data.datasets import DataLoader, MaestroDatasetGanDes, my_collate
    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.parallel import launch
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train import gandes_loop, mmgan_loop
    from gandes_tpu_torch.train.steps import g_parameters

    t_phase = time.perf_counter()
    ds = MaestroDatasetPickle(os.path.join(work_dir, "windows.pkl"), data_dir=".")
    paths = {"log_path": os.path.join(work_dir, "mesh_logs") + "/",
             "midi_out_dir": os.path.join(work_dir, "mesh_midi")}
    real_m2m = mmgan_loop.matrix_to_midi

    def mmgan_run(name, mesh_shape, replay=None, max_batches=3, **kw):
        """A ``train_mmgan`` run; ``replay`` (count -> the one-device run's
        host-stage inputs and outputs) makes rank 0's host stage return the
        one-device run's rolls, and records how far its G outputs are from
        that run's."""
        calls = {}

        def host(mats, vec, **k):
            if replay is None:
                calls[k["count"]] = (mats, vec, real_m2m(mats, vec, **k))
                return calls[k["count"]][2]
            m0, v0, out = replay[k["count"]]
            calls[k["count"]] = max(float(np.abs(mats - m0).max()),
                                    float(np.abs(vec - v0).max()))
            return out

        cfg = mmgan_loop.MMGANConfig(**{
            **paths, "num_epochs": 1, "profile": True, "des_parallel": 16, "resume": False,
            "models_dir": os.path.join(work_dir, "mesh_" + name),
            "losses_dir": os.path.join(work_dir, "mesh_" + name + "_l"),
            "mesh_shape": mesh_shape, **kw})
        mmgan_loop.matrix_to_midi = host
        try:
            np.random.seed(0)
            t = time.perf_counter()
            state, hist = mmgan_loop.train_mmgan(ds, cfg, max_batches=max_batches, device=DEVICE)
            _sync()
            wall = time.perf_counter() - t
        finally:
            mmgan_loop.matrix_to_midi = real_m2m
        return state, hist, wall, calls

    def flat(params):
        return torch.cat([p.detach().flatten() for p in params])

    def gaps(one, mesh, steps, lr):
        h = {k: (np.asarray(one[1][k], np.float64), np.asarray(mesh[1][k], np.float64))
             for k in ("disc", "gen")}
        rel = {k: float(np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-12)))
               for k, (a, b) in h.items()}
        diff = (flat(one[0].model.discriminator.parameters())
                - flat(mesh[0].model.discriminator.parameters())).abs()
        g_diff = (flat(g_parameters(one[0].model)) - flat(g_parameters(mesh[0].model))).abs()
        out_gaps = [mesh[3][c] for c in sorted(mesh[3])]
        row = {"disc_rel_gap": rel["disc"], "gen_rel_gap": rel["gen"],
               "d_param_max_gap": float(diff.max()),
               "d_param_share_above_1e-4": float((diff > 1e-4).float().mean()),
               "g_output_gap_per_host_stage": out_gaps,
               "g_param_max_gap": float(g_diff.max()),
               "g_param_share_above_1e-4": float((g_diff > 1e-4).float().mean())}
        ok = (max(rel.values()) <= 1e-3 and row["d_param_share_above_1e-4"] <= 1e-3
              and row["d_param_max_gap"] <= 4 * lr * steps and len(out_gaps) == steps
              and out_gaps[0] <= 2e-4)
        return row, ok

    def timing(run):
        prof = run[1]["profile"]
        return {"wall_s": run[2], "steps_per_s": prof["device_step"]["count"] / run[2],
                "host_des_p50_s": prof["host_des"]["p50_s"],
                "device_step_p50_s": prof["device_step"]["p50_s"]}

    out = {"note": "every rank shares cuda:0 (gloo): overhead, not scaling"}
    for mode in ("none", "surrogate"):
        one = mmgan_run(f"{mode}_one", None, g_update=mode)
        mesh = mmgan_run(f"{mode}_mesh", (2, 2), replay=one[3], g_update=mode)
        row, ok = gaps(one, mesh, 3, mmgan_loop.MMGANConfig().lr)
        # the replaying ranks run no DES: their host_des is gather, replay and broadcast
        row.update({"one_device": timing(one),
                    "ranks_device_step_p50_s": [r["device_step_p50_s"] for r in mesh[1]["mesh"]],
                    "losses_finite": all(math.isfinite(v) for k in ("disc", "gen")
                                         for e in mesh[1][k] for v in e)})
        out[f"mmgan_{mode}"] = row
        if not (ok and row["losses_finite"] and len(mesh[1]["mesh"]) == 4
                and all(r["backend"] == "gloo" for r in mesh[1]["mesh"])):
            raise AssertionError(f"mesh: MM-GAN {mode} (2, 2) vs one device: {row}")
        if mode == "none":  # the times: a (2, 2) run whose rank 0 runs the DES itself
            timed = mmgan_run("none_timed", (2, 2), g_update="none")
            out["mmgan_none_timing"] = {"one_device": row["one_device"], "mesh_wall_s": timed[2],
                                        "ranks": timed[1]["mesh"]}
            if len(timed[1]["mesh"]) != 4 or not all(
                    math.isfinite(v) for e in timed[1]["disc"] for v in e):
                raise AssertionError(f"mesh: MM-GAN none (2, 2) with DES: {timed[1]}")

    # the surrogate step in float64 on the card: the mesh's math to rounding
    rng = np.random.RandomState(7)
    B = mmgan_loop.MMGANConfig().batch_size
    f64_in = {"noise1": rng.randn(B, 50), "noise2": rng.randn(B, 50), "aux": rng.randn(B, 50),
              "beats": rng.rand(B, 50),
              "real": np.stack([np.stack(ds[i][:2]) for i in range(B)]).astype(np.float64),
              "fake": rng.rand(B, 2, 128, 50) * 50}
    f64_one = _mesh_f64_rank(f64_in, 3, DEVICE)
    f64_mesh = launch.run(_mesh_f64_rank, 4, (f64_in, 3, DEVICE, (2, 2)), device=DEVICE)
    top = max(float(np.abs(m).max()) for m in f64_one["g_mu"])
    f64 = {"dtype": f64_mesh["dtype"], "steps": 3,
           "g_output_gap_per_step": [max(float(np.abs(a - b).max()) for a, b in zip(x, y))
                                     for x, y in zip(f64_mesh["outs"], f64_one["outs"])],
           "param_max_gap": max(float(np.abs(f64_mesh["sd"][k] - v).max())
                                for k, v in f64_one["sd"].items()),
           "g_mu_max_rel_gap": max(float(np.max(np.abs(a - b) / (np.abs(b) + 1e-5 * top)))
                                   for a, b in zip(f64_mesh["g_mu"], f64_one["g_mu"]))}
    out["mmgan_surrogate_f64"] = f64
    if not (f64["dtype"] == "torch.float64" and max(f64["g_output_gap_per_step"]) <= 1e-9
            and f64["param_max_gap"] <= 1e-9 and f64["g_mu_max_rel_gap"] <= 1e-7):
        raise AssertionError(f"mesh: float64 surrogate (2, 2) vs one device: {f64}")

    # GAN-DES over (2, 1) on phase train_gandes' corpus: K2 on rank 0's card
    corpus = os.path.join(work_dir, "gandes_corpus")
    if not os.path.isdir(corpus):
        write_corpus(corpus, n_files=4, seconds=150.0, seed=1)
    gcfg = gandes_loop.GanDesConfig(
        model_path=os.path.join(work_dir, "mesh_gandes"), write_wav=False, des_parallel=16,
        log_path=os.path.join(work_dir, "mesh_gandes_logs") + "/", save_step=100,
        out_dir=os.path.join(work_dir, "mesh_gandes_out"), profile=True, mesh_shape=(2, 1))
    counted = {"slices": 0}

    def loader():
        dset = MaestroDatasetGanDes(batch_size=gcfg.batch_size, input_folder=corpus,
                                    device=DEVICE)
        for batch in DataLoader(dset, batch_size=1, shuffle=True, collate_fn=my_collate):
            counted["slices"] += len(batch)
            yield batch

    np.random.seed(0)
    random.seed(0)
    mel_power_cuda.launches = 0
    t = time.perf_counter()
    gstate, ghist = gandes_loop.train_gandes(loader(), gcfg, max_steps=2, device=DEVICE)
    _sync()
    gd = {"wall_s": time.perf_counter() - t, "k2_launches_rank0": mel_power_cuda.launches,
          "fake_clips": 2 * gcfg.batch_size, "real_slices": counted["slices"],
          "d_loss": ghist["disc"], "g_loss": ghist["gen"], "ranks": ghist["mesh"],
          "step": gstate.step}
    out["gandes_2x1"] = gd
    k2_expected = gd["fake_clips"] + gd["real_slices"] if DEVICE == "cuda" else 0
    if (gd["k2_launches_rank0"] != k2_expected or gd["step"] != 2
            or not all(math.isfinite(v) for v in ghist["disc"] + ghist["gen"])):
        raise AssertionError(f"mesh: GAN-DES (2, 1): {gd}")

    # a one-rank mesh owns the card: nccl
    state, hist, wall, _ = mmgan_run("nccl", (1, 1), max_batches=1)
    out["nccl_1x1"] = {"ranks": hist["mesh"], "d_loss": hist["disc"], "wall_s": wall}
    if (hist["mesh"][0]["backend"] != ("nccl" if DEVICE == "cuda" else "gloo")
            or not math.isfinite(hist["disc"][0][0])):
        raise AssertionError(f"mesh: (1, 1): {out['nccl_1x1']}")

    # the fused step with callback_device under (2, 1), bitwise the two-phase path
    cfg = mmgan_loop.MMGANConfig()
    path = ckpt.save_state(os.path.join(work_dir, "mesh_fused_init"),
                           mmgan_loop.init_state_for_config(cfg, device="cpu")[0])
    rng = np.random.RandomState(5)
    inputs = {k: rng.randn(cfg.batch_size, cfg.noise_dim).astype(np.float32)
              for k in ("noise1", "noise2", "aux")}
    inputs["beats"] = rng.rand(cfg.batch_size, cfg.max_beat_length).astype(np.float32)
    inputs["real"] = np.stack([np.stack(ds[i][:2]) for i in range(cfg.batch_size)]
                              ).astype(np.float32)
    os.makedirs(os.path.join(work_dir, "mesh_fused_midi"), exist_ok=True)
    fused = launch.run(_mesh_fused_rank, 2, (path, inputs, work_dir, DEVICE), device=DEVICE)
    out["fused_callback_device_2x1"] = fused
    if not fused["bitwise"] or fused["rank0_rows"] != cfg.batch_size // 2:
        raise AssertionError(f"mesh: fused step vs two-phase: {fused}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "mesh", **out})
    return gd["k2_launches_rank0"]


def _densest_launch(extracted, chunk=8):
    """The events of the pickler's densest launch: the ``chunk`` files of
    ``extracted`` (in the pickler's grouping) whose padded E is largest."""
    from gandes_tpu_torch.data.datasets import pad_file_events

    chunks = [extracted[i:i + chunk] for i in range(0, len(extracted), chunk)]
    return pad_file_events(max(chunks, key=lambda grp: max(len(e[0]) for e in grp)))


def _clip_wave(audio):
    """A GAN-DES clip's render as its mel takes it: the int16 round trip of
    ``bridge/gandes_decode.py``, cropped to 216 dynamic hops of ``len //
    215``. Returns (wave, hop)."""
    import torch

    q = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16).to(torch.float32) / 32768.0
    hop = int(q.shape[0]) // 215
    return q[:216 * hop].contiguous(), hop


def phase_examples(work_dir):
    """Phase 23 (module docstring). Returns (K2, K1) launches on the
    harnesses' paths."""
    import contextlib
    import io
    import pickle
    import random
    from unittest import mock

    import numpy as np

    from gandes_tpu_torch.bridge import gandes_decode
    from gandes_tpu_torch.data import datasets
    from gandes_tpu_torch.examples import (
        ingest_bench,
        ref_schedule_run,
        train_gandes_demo,
        train_surrogate_demo,
    )
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda
    from gandes_tpu_torch.train import gandes_loop, mmgan_loop

    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "examples")
    failures, rows, logs = [], {}, {}
    counted = {"slices": 0, "clips": 0, "failed": 0, "seen": 0, "audio": None,
               "in_training": False, "extracted": None, "split": [], "t_mode": 0.0}
    real = {"getitem": datasets.MaestroDatasetGanDes.__getitem__,
            "m2w": gandes_decode.matrix_to_wav, "mel": gandes_decode._mel_from_device_audio,
            "m2m": mmgan_loop.matrix_to_midi, "raster": datasets._rasterize_file_batch,
            "train": gandes_loop.train_gandes, "pickle": datasets.build_window_pickle}

    # independent counts of what the harnesses ran: the real slices and the
    # clips each mel call took (K2 once each), the MM-GAN loop's failed
    # sims, the pickler's per-file events, one training clip's audio
    def getitem(self, index):
        out = real["getitem"](self, index)
        counted["slices"] += int(out.shape[0])
        return out

    def m2w(*a, **k):
        out = real["m2w"](*a, **k)
        counted["clips"] += int(out.shape[0])
        return out

    def mel(audio, sr):
        if counted["audio"] is None and counted["in_training"]:
            counted["audio"] = audio.detach().clone()
        return real["mel"](audio, sr)

    def train(*a, **k):
        counted["in_training"] = True
        try:
            return real["train"](*a, **k)
        finally:
            counted["in_training"] = False

    def m2m(*a, **k):
        rolls, failed = real["m2m"](*a, **k)
        counted["failed"] += int(failed)
        counted["seen"] += len(rolls)
        return rolls, failed

    def pickle_mode(*a, **k):
        counted["t_mode"] = time.perf_counter()
        return real["pickle"](*a, **k)

    def raster(extracted, *a, **k):
        # the fast modes parse every file (a process pool in workers mode)
        # before their first K1 launch; the rasterize time is the time spent
        # inside the batches' generator (K1, the copies back)
        counted["extracted"] = extracted
        split = {"parse_s": time.perf_counter() - counted["t_mode"], "rasterize_s": 0.0}
        counted["split"].append(split)
        batches = real["raster"](extracted, *a, **k)

        def timed():
            while True:
                t = time.perf_counter()
                try:
                    item = next(batches)
                except StopIteration:
                    return
                finally:
                    split["rasterize_s"] += time.perf_counter() - t
                yield item

        return timed()

    def harness(name, fn):
        """Run one harness with its stdout kept in a log; return its value
        and wall seconds."""
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            value = fn()
        logs[name] = buf.getvalue()
        with open(os.path.join(root, f"{name}.log"), "w") as f:
            f.write(logs[name])
        return value, round(time.perf_counter() - t, 2)

    os.makedirs(root)
    with contextlib.ExitStack() as patches:
        for owner, name, fn in ((datasets.MaestroDatasetGanDes, "__getitem__", getitem),
                                (gandes_decode, "matrix_to_wav", m2w),
                                (gandes_loop, "matrix_to_wav", m2w),
                                (gandes_decode, "_mel_from_device_audio", mel),
                                (mmgan_loop, "matrix_to_midi", m2m),
                                (datasets, "_rasterize_file_batch", raster),
                                (datasets, "build_window_pickle", pickle_mode),
                                (gandes_loop, "train_gandes", train)):
            patches.enter_context(mock.patch.object(owner, name, fn))
        # 1. ingestion at the JAX harness's defaults (200 files x 6 pieces,
        # workers = cpu count): K1 in both fast modes
        rasterize_cuda.launches = 0
        (summary, k1), s = harness("ingest", lambda: ingest_bench.run(
            os.path.join(root, "ingest"), device=DEVICE))
        k1_total = rasterize_cuda.launches
        extracted = counted["extracted"]
        n_files = summary["corpus_files"]
        want = -(-n_files // 8)
        fast = [m for m in k1 if m != "sequential"]
        rows["ingest"] = {"summary": summary, "k1_launches": k1, "s": s,
                          "workers": os.cpu_count(),
                          "parse_vs_rasterize_s": dict(zip(fast, counted["split"]))}
        if k1["sequential"] != 0 or any(k1[m] != want for m in fast) or len(fast) != 2:
            failures.append(f"ingest: K1 launches {k1}, want {want} per fast mode")
        if not summary["identical_outputs"]:
            failures.append("ingest: pickles differ")

        # 2. the MM-GAN outcome demo at out 24 24 surrogate 1e-4 (144 steps)
        counted.update(failed=0, seen=0)
        results, s = harness("surrogate_demo", lambda: train_surrogate_demo.run(
            os.path.join(root, "surrogate_demo"), 24, 24, "surrogate", 1e-4, device=DEVICE))
        train_line = next(json.loads(ln) for ln in logs["surrogate_demo"].splitlines()
                          if ln.startswith('{"train_s"'))
        rows["surrogate_demo"] = {
            "s": s, **train_line, "steps": results["steps"], "gap_initial": results["gap_initial"],
            "gap_final": results["gap_final"], "failed_sims_eval": results["failed_sims_eval"],
            "failed_sims_training": counted["failed"], "sims_training": counted["seen"],
            "disc_loss_last_epoch": results["disc_loss_last_epoch"],
            "gen_loss_last_epoch": results["gen_loss_last_epoch"]}
        curves = results["disc_loss_per_epoch"] + results["gen_loss_per_epoch"]
        if results["steps"] < 24 or not all(math.isfinite(v) for v in curves):
            failures.append(f"surrogate demo: {results['steps']} steps, losses {curves[-4:]}")

        # 3. the GAN-DES outcome demo at 16 nets, reinforce lr 1e-3, d_lr
        # 1e-5, B = 16, steps cut to 16: K2 per real slice and per clip
        mel_power_cuda.launches = 0
        counted.update(slices=0, clips=0)
        random.seed(0)
        results, s = harness("gandes_demo", lambda: train_gandes_demo.run(
            os.path.join(root, "gandes_demo"), 16, 16, "reinforce", 1e-3, 1e-5, device=DEVICE))
        k2 = mel_power_cuda.launches
        train_line = next(json.loads(ln) for ln in logs["gandes_demo"].splitlines()
                          if ln.startswith('{"train_s"'))
        rows["gandes_demo"] = {
            "s": s, **train_line, "steps": results["steps"], "gap_initial": results["gap_initial"],
            "gap_final": results["gap_final"], "real_slices": counted["slices"],
            "clips": counted["clips"], "k2_launches": k2, "failed_sims": None,
            "disc_loss_last10": results["disc_loss_last10"],
            "gen_loss_last10": results["gen_loss_last10"]}
        losses = results["disc_losses"] + results["gen_losses"]
        if results["steps"] != 16 or not all(math.isfinite(v) for v in losses):
            failures.append(f"gandes demo: {results['steps']} steps")
        if k2 <= 0 or k2 != counted["slices"] + counted["clips"]:
            failures.append(f"gandes demo: K2 launches {k2} != real slices {counted['slices']}"
                            f" + clips {counted['clips']}")
        if counted["audio"] is None:
            failures.append("gandes demo: no training clip reached the mel")

        # 4. the reference schedule on one 256-net chunk (~1,100 windows),
        # 32 steps an epoch, epoch 1 then a call to epoch 2 that resumes
        ref_dir = os.path.join(root, "refsched")
        ref_kw = dict(target_windows=1024, steps_per_epoch=32, device=DEVICE)
        counted.update(failed=0, seen=0)
        np.random.seed(0)
        (_, h1, done1), s1 = harness("refsched_1", lambda: ref_schedule_run.run(
            ref_dir, 1, **ref_kw))
        (_, h2, done2), s2 = harness("refsched_2", lambda: ref_schedule_run.run(
            ref_dir, 2, **ref_kw))
        with open(os.path.join(ref_dir, "windows.pkl"), "rb") as f:
            n_windows = len(pickle.load(f))
        done_lines = [ln for name in ("refsched_1", "refsched_2")
                      for ln in logs[name].splitlines() if ln.startswith("DONE:")]
        resumed = ("Loaded model from models/mmgan_64_64_epoch_1" in logs["refsched_2"]
                   and len(h2["disc"]) == 1 and done2["steps"] == ref_kw["steps_per_epoch"]
                   and os.path.isdir(os.path.join(ref_dir, "models", "mmgan_64_64_epoch_2"))
                   and os.path.isfile(os.path.join(ref_dir, "losses",
                                                   "disc_losses_epoch_2.pkl")))
        rows["refsched"] = {"s": [s1, s2], "windows": n_windows, "done": done_lines,
                            "epoch_losses": [
                                {"disc": float(np.mean(h["disc"][0])),
                                 "gen": float(np.mean(h["gen"][0]))} for h in (h1, h2)],
                            "s_per_step": [round(d["wall_s"] / d["steps"], 4)
                                           for d in (done1, done2)],
                            "failed_sims": counted["failed"], "sims": counted["seen"],
                            "resumed_at_epoch_2": resumed}
        if n_windows < 1024 or done1["steps"] != ref_kw["steps_per_epoch"] or not resumed:
            failures.append(f"refsched: {n_windows} windows, {done1['steps']} steps, "
                            f"resumed {resumed}")

    for name, row in rows.items():
        emit({"phase": "examples", "harness": name, **row})
    # each kernel against its plain version at this phase's own shapes
    k1_row = _roll_row("ingest_densest", _densest_launch(extracted), 300, 0, timed=True)
    k2_row = (_mel_row("gandes_demo_clip", *_clip_wave(counted["audio"]))
              if counted["audio"] is not None else None)
    emit({"phase": "examples", "kernel_checks": [k1_row, k2_row],
          "phase_s": round(time.perf_counter() - t_phase, 2)})
    if not (k1_row["equal"] and k1_row["repeat_equal"]):
        failures.append("K1 disagrees with its plain version at the ingest's densest chunk")
    if k2_row is None or not k2_row["ok"]:
        failures.append("K2 disagrees with its plain version on a GAN-DES demo clip")
    if failures:
        raise AssertionError(f"examples: {failures}")
    return k2, k1_total


def main() -> int:
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import gandes_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: gandes_tpu_torch is not importable from {repo}: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    phase_build()
    if sys.argv[1:] in (["--only", "sf2"], ["--only", "mesh"], ["--only", "examples"]):
        with tempfile.TemporaryDirectory() as work:
            if sys.argv[2] == "sf2":
                phase_sf2(work)
            elif sys.argv[2] == "examples":
                phase_examples(work)
            else:
                phase_pickle(work)
                phase_mesh(work)
        print(f"total_s {time.perf_counter() - t_start:.1f}")
        print(smi)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    rows = phase_kernel()
    roll_rows = phase_kernel_roll()
    launches = phase_serve()
    phase_slice()
    mel_launches = launches["mel_power"] + phase_gandes_parallel()
    with tempfile.TemporaryDirectory() as work:
        roll_launches = phase_pickle(work)
        phase_serve_mmgan()
        seq = phase_train_mmgan(work)
        phase_train_fast(work, seq)
        gandes_launches, gandes_state = phase_train_gandes(work)
        mel_launches += gandes_launches
        mmgan_models = phase_train_mmgan_modes(work)
        mel_launches += phase_eval_metrics(work, mmgan_models, gandes_state)
        mel_launches += phase_sf2(work)
        mel_launches += phase_train_bf16(work)
        mel_launches += phase_trace(work)
        phase_doctor()
        mel_launches += phase_generate_gandes(work)
        phase_composite(work)
        bench_mel, bench_roll = phase_bench(smi)
        mel_launches += bench_mel
        roll_launches += bench_roll
        phase_demo(work)
        mel_launches += phase_mesh(work)
        examples_mel, examples_roll = phase_examples(work)
        mel_launches += examples_mel
        roll_launches += examples_roll

    r = next(row for row in rows if row["case"] == "serve_2^22")  # the serve clips' bucket
    # the pickler's own events for one launch
    k = next(row for row in roll_rows if row["case"] == "midi_order")
    kernels = [{"name": "mel_power", "route": "cuda",
                "source": "gandes_tpu_torch/ops/csrc/mel_power.cu",
                "replaces": "gandes_tpu/ops/pallas_mel.py:101",
                # the serve path's, the parallel matrix_to_wav's, GAN-DES
                # training's (fake clips and real slices), eval-metrics'
                # (real slices and each checkpoint's fake clips), the
                # SF2 paths' (requests, matrix_to_wav, train-gandes), bf16
                # GAN-DES training's, the traced train-gandes step's,
                # generate-gandes', the bench's mel row, the GAN-DES
                # mesh run's rank 0 and the GAN-DES demo's (real slices
                # and clips)
                "launches": mel_launches, "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]},
               # library_ms null: no single PyTorch call rasterizes ordered,
               # last-writer-wins spans (index_put_ with duplicate indices
               # leaves the winner unspecified)
               {"name": "roll_rasterize", "route": "cuda",
                "source": "gandes_tpu_torch/ops/csrc/roll_rasterize.cu",
                "replaces": "gandes_tpu/ops/pallas_roll.py:95",
                "launches": roll_launches,
                "max_abs_err": max(x["max_abs_err"] for x in roll_rows),
                "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}]
    emit({"kernels": kernels})
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
