#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``gandes_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the last line:

1. device   — CUDA must be available; prints ``nvidia-smi``'s name and power
              limit.
2. build    — builds every kernel of the serve path from this checkout's
              sources (nvcc for ``ops/csrc/mel_power.cu``, g++ for the DES
              core, started together) and prints the build seconds.
3. kernel   — holds each kernel against its plain PyTorch version on the card
              at the serve path's shapes (rtol 2e-3 / atol 1e-4 in power,
              0.05 dB after ``amplitude_to_db_torch``) and times kernel,
              plain version and the one-call library equivalent with CUDA
              events (median of 30 after 5 warmup launches); the bound
              counts the function's least work (a real FFT per frame), and
              the DFT-as-GEMM roofline of the kernel's own algorithm is
              printed beside it.
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

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Bounds use the H100 SXM's published
peaks: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

import base64
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


def mel_dft_gemm_bound_ms(n_frames, n_fft=2048, n_mels=128) -> float:
    """Roofline of the kernel's own algorithm, not of the function: the DFT
    as two dense products against the cos/-sin bases (4 n_fft operations per
    bin and frame), the power, and a dense mel product, over the f32 peak."""
    n_freqs = n_fft // 2 + 1
    return 1e3 * n_frames * n_freqs * (4 * n_fft + 3 + 2 * n_mels) / F32_PEAK_FLOPS


def phase_build():
    from gandes_tpu_torch.des import native
    from gandes_tpu_torch.ops import mel_power

    t0 = time.perf_counter()
    results = {}

    def build_des():
        results["des"] = native.native_available()

    des = threading.Thread(target=build_des)
    des.start()
    k = mel_power.kernel()
    t_mel = time.perf_counter() - t0
    des.join()
    ptxas = [ln.strip() for ln in k.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "mel_power_s": round(t_mel, 2),
          "all_s": round(time.perf_counter() - t0, 2), "native_des": results["des"],
          "ptxas": ptxas})
    if not results["des"]:
        raise RuntimeError("native DES core failed to build (g++)")


def phase_kernel():
    import numpy as np
    import torch

    from gandes_tpu_torch.music.mel import amplitude_to_db_torch, mel_filterbank
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda, mel_power_reference

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
        plain_ms = cuda_ms(lambda: mel_power_reference(wav, sr, **kw))
        library_ms = cuda_ms(library)
        frames = int(out.shape[1])
        bound_ms, bound_by = mel_bound_ms(n, hop, frames, int(torch.count_nonzero(fb)), n_fft,
                                          128)
        row = {"phase": "kernel", "name": "mel_power", "case": label, "samples": n, "hop": hop,
               "frames": frames, "max_abs_err": float(err.max()),
               "max_rel_err": float((err / ref.abs().clamp(min=1e-30)).max()),
               "db_err": db_err, "ok": ok_power and db_err <= 0.05, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "dft_gemm_bound_ms": mel_dft_gemm_bound_ms(frames, n_fft, 128)}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"mel_power {label}: kernel disagrees with its plain version")
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
    launches = phase_serve()
    phase_slice()

    r = next(row for row in rows if row["case"] == "serve_2^22")  # the serve clips' bucket
    kernels = [{"name": "mel_power", "route": "cuda",
                "source": "gandes_tpu_torch/ops/csrc/mel_power.cu",
                "replaces": "gandes_tpu/ops/pallas_mel.py:101",
                "launches": launches["mel_power"], "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}]
    emit({"kernels": kernels})
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
