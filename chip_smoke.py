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
              function's least work (a real FFT per frame).
              K1 (roll_rasterize) at the JAX kernel tests' shapes, the
              pickler's (8, 4096, 300), a dense (8, 16384, 300) and a long
              roll (2, 4096, 2000): bitwise (``torch.equal``); bytes-bound
              (16 B per event in, 4 B per roll cell out).
4. serve    — launch counts set to 0; ``GenerationService(model="gandes")`` at
              full width on ``cuda`` with a warmup request, then an HTTP
              server on 127.0.0.1:0 answering POST /generate/gandes (n=4,
              seeds 0, 1, 0) and GET /healthz; counts read. Checks RIFF WAVs,
              mel_shape [4, 128, 216], byte-identical replies for the repeated
              seed, and that the serve path launched every kernel.
   profile  — the device busy share of one more request: the union of the
              device-side intervals (kernels, copies, memsets) in a
              torch.profiler trace over the request's host wall time.
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
              breakdown.
7. serve_mmgan — ``GenerationService(model="mmgan")`` at full width (G1
              100-256-128-64-4096, G2 100-256-128-64-20) on ``cuda`` with a
              warmup request, then HTTP POST /generate/mmgan (n=4, seeds 0,
              1, 0) and GET /healthz. Checks MIDI (``MThd``), equal bytes for
              the repeated seed wherever neither slot failed (the DES budget
              is wall-clock, so each slot's failed flag is printed), different
              songs for seeds 0 and 1; G1/G2 on the card vs a CPU copy (atol
              1e-5); each reply's MIDI equal to the host decode of the card's
              generator outputs.

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
    by their count. The trace may drop an event at the edge of its window,
    so the count may fall short of ``reps``; it may not exceed it (one
    launch per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and kernel_name in ev.name]
    if not reps // 2 <= len(events) <= reps:
        raise AssertionError(f"{kernel_name}: {len(events)} device events for {reps} calls")
    return sum(ev.time_range.end - ev.time_range.start for ev in events) / 1e3 / len(events), \
        len(events)


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


def phase_kernel():
    import numpy as np
    import torch

    from gandes_tpu_torch.music.mel import amplitude_to_db_torch, mel_filterbank
    from gandes_tpu_torch.ops.mel_power import kernel, mel_power_cuda, mel_power_reference

    sr, n_fft = 44100, 2048
    # (label, samples, hop, htk, norm_slaney): the fixed-hop cases of the
    # JAX package's kernel tests, the blank clip's slaney variant, and the
    # serve path's dynamic hop len // 215 at pow2 buckets up to the synth's
    # 190 s timeline cap (2^23 samples)
    cases = [("hop512", 44100, 512, True, False), ("hop1025", 220500, 1025, True, False),
             ("hop220", 44100, 220, True, False), ("blank_slaney", 220500, 512, False, True)]
    cases += [(f"serve_2^{p}", 1 << p, (1 << p) // 215, True, False) for p in (18, 20, 22, 23)]
    rng = np.random.RandomState(0)
    rows = []
    for label, n, hop, htk, slaney in cases:
        t = np.arange(n) / sr
        wav_np = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)
        wav = torch.from_numpy(wav_np).cuda()
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
        library_ms = cuda_ms(library)
        frames = int(out.shape[1])
        # the device memory K2's constants hold for this n_fft and filterbank
        k = kernel()
        consts = (*k.tables(n_fft, wav.device),
                  *k.filterbank(sr, n_fft, 128, 20, 8300, htk, slaney, wav.device)[:2])
        bound_ms, bound_by = mel_bound_ms(n, hop, frames, int(torch.count_nonzero(fb)), n_fft,
                                          128)
        row = {"phase": "kernel", "name": "mel_power", "case": label, "samples": n, "hop": hop,
               "frames": frames, "max_abs_err": float(err.max()),
               "max_rel_err": float((err / ref.abs().clamp(min=1e-30)).max()),
               "db_err": db_err, "repeat_equal": repeat_equal,
               "ok": ok_power and db_err <= 0.05 and repeat_equal, "ms": ms,
               "device_ms": kernel_ms, "traced_launches": traced, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "below_library": ms < library_ms,
               "constants_bytes": sum(t.numel() * t.element_size() for t in consts)}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"mel_power {label}: kernel disagrees with its plain version "
                                 f"or with itself")
    return rows


def roll_bound_ms(B, E, T) -> tuple[float, str]:
    """Least time for one rasterizer call: each event read once (4 int32),
    each roll cell written once (f32), over the HBM rate; its few integer
    operations per event and cell are far below the card's rate."""
    return 1e3 * (16 * B * E + 4 * B * 2 * 128 * T) / HBM_BYTES_PER_S, "bytes"


def _roll_events(B, E, T, start, seed, pad_from=None):
    """tests/test_pallas_roll.py's generator (notes in [-1, 128), ons past
    the crop on both sides, spans of -2..19 steps, velocities from -1)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    notes = rng.randint(-1, 128, (B, E)).astype(np.int32)
    if pad_from is not None:
        notes[:, pad_from:] = -1
    ons = rng.randint(0, T + start + 10, (B, E)).astype(np.int32)
    offs = (ons + rng.randint(-2, 20, (B, E))).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    return notes, ons, offs, vels


def phase_kernel_roll():
    import numpy as np
    import torch

    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda, rasterize_events_reference

    last_writer = (np.array([[60, 60, 60, 60, 64, 64]], np.int32),
                   np.array([[10, 10, 10, 10, 5, 5]], np.int32),
                   np.array([[30, 20, 15, 12, 40, 8]], np.int32),
                   np.array([[100, 90, 0, -1, 70, 0]], np.int32))
    # (label, events, T, start, timed): tests/test_pallas_roll.py's shapes,
    # then the pickler's, a dense one and a roll too long for one CTA per sample
    cases = [("jax_3x32", _roll_events(3, 32, 50, 5, 0), 50, 5, False),
             ("jax_2x128", _roll_events(2, 128, 50, 100, 1), 50, 100, False),
             ("jax_1x16", _roll_events(1, 16, 96, 0, 2), 96, 0, False),
             ("last_writer", last_writer, 50, 0, False),
             ("pad_tail", _roll_events(4, 256, 50, 0, 3, pad_from=37), 50, 0, False),
             ("pickler", _roll_events(8, 4096, 300, 0, 4), 300, 0, True),
             ("dense", _roll_events(8, 16384, 300, 0, 5), 300, 0, True),
             ("long_roll", _roll_events(2, 4096, 2000, 0, 6), 2000, 0, True)]
    rows = []
    for label, events, T, start, timed in cases:
        ev = [torch.from_numpy(a).cuda() for a in events]
        B, E = ev[0].shape
        out = rasterize_cuda(*ev, num_steps=T, start=start)
        ref = rasterize_events_reference(*ev, num_steps=T, start=start)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "name": "roll_rasterize", "case": label, "B": B, "E": E,
               "T": T, "start": start, "equal": bool(torch.equal(out, ref)),
               "max_abs_err": float((out - ref).abs().max()), "cells_set": int(ref.count_nonzero())}
        if timed:
            row["ms"] = cuda_ms(lambda: rasterize_cuda(*ev, num_steps=T, start=start))
            row["device_ms"], row["traced_launches"] = device_ms(
                lambda: rasterize_cuda(*ev, num_steps=T, start=start), "roll_rasterize_kernel")
            row["plain_ms"] = cuda_ms(lambda: rasterize_events_reference(
                *ev, num_steps=T, start=start))
            row["bound_ms"], row["bound_by"] = roll_bound_ms(B, E, T)
            row["library_ms"] = None
        emit(row)
        rows.append(row)
        if not row["equal"]:
            raise AssertionError(f"roll_rasterize {label}: kernel disagrees with its plain version")
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


def profile_request(service):
    """Device busy share of one more request (n=4, seed 2) from a
    torch.profiler trace: the union of the device-side event intervals
    (kernels, copies, memsets; the host-side aten ops that launched them
    are left out, so no device time counts twice) over the request's host
    wall time, and the device events that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        service.generate(n=4, seed=2)
        _sync()
        wall_ms = 1e3 * (time.perf_counter() - t)
    device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
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
    emit({"phase": "profile", "wall_ms": round(wall_ms, 3), "device_events": len(device),
          "device_busy_ms": round(busy_ms, 3), "device_busy_share": round(busy_ms / wall_ms, 4),
          "top": [{"name": k[:80], "ms": round(us / 1e3, 3), "count": c}
                  for k, (us, c) in top]})
    if not device:
        raise AssertionError("the profiled request shows no device-side event")


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


def phase_pickle():
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
        n_dev = build_window_pickle(root, os.path.join(tmp, "device.pkl"), sample_size=300,
                                    sequence_length=50, device_rasterize=True, device=DEVICE)
        _sync()
        device_s = time.perf_counter() - t
        launches = rasterize_cuda.launches

        t = time.perf_counter()
        n_host = build_window_pickle(root, os.path.join(tmp, "host.pkl"), sample_size=300,
                                     sequence_length=50)
        host_s = time.perf_counter() - t
        dev_digest = _windows_digest(os.path.join(tmp, "device.pkl"))
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
    rows = phase_kernel()
    roll_rows = phase_kernel_roll()
    launches = phase_serve()
    phase_slice()
    roll_launches = phase_pickle()
    phase_serve_mmgan()

    r = next(row for row in rows if row["case"] == "serve_2^22")  # the serve clips' bucket
    k = next(row for row in roll_rows if row["case"] == "pickler")
    kernels = [{"name": "mel_power", "route": "cuda",
                "source": "gandes_tpu_torch/ops/csrc/mel_power.cu",
                "replaces": "gandes_tpu/ops/pallas_mel.py:101",
                "launches": launches["mel_power"], "max_abs_err": max(x["max_abs_err"] for x in rows),
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
