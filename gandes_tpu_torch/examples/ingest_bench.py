"""MAESTRO-volume ingestion throughput (the port of
``examples/ingest_bench.py``).

The reference pickles its training windows from MAESTRO v3.0.0 (~1,276
files / 81 MB of MIDI) with a sequential per-file loop. MAESTRO is not in
the repository, so this harness builds a synthetic corpus at that shape —
``data/maestro-v3.0.0/<year>/*.midi``, N multi-minute files, each the
time-concatenation of ``concat`` simulator MIDIs (every base piece comes
from the DES -> MidiGenerator pipeline, ``bridge/sim_demo.py``) — then
times ``build_window_pickle`` end to end in three modes:

* ``sequential``: the host path (the reference's algorithm);
* ``workers<N>``: a process pool parses, then the batched rasterizer runs on
  ``device`` (kernel K1 on a CUDA device, one launch per 8 files);
* ``device_rasterize``: the same batched rasterizer from one process.

The three pickles must be identical (sha256 over every window; the check
raises). Prints one JSON line per mode (windows, seconds, MB/s over the
corpus bytes), then K1's launches per mode, then the summary line.

    python -m gandes_tpu_torch.examples.ingest_bench WORKDIR [n_files] [concat] [workers]

Runs on ``cuda``; ``run(..., device="cpu")`` takes K1's plain version.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import pickle
import sys
import time

import numpy as np


def build_corpus(workdir: str, n_files: int, concat: int, n_base: int = 40):
    """``data/maestro-v3.0.0/<year>/*.midi`` under ``workdir`` from
    ``n_base`` concatenated sim MIDIs (numpy seeds 10,000 + i for the bases,
    ``RandomState(7)`` for the choice of pieces); existing files are kept.
    Returns ``(root, total_bytes)``."""
    from gandes_tpu_torch.bridge.sim_demo import sim_to_wav
    from gandes_tpu_torch.music.midi import MetaMessage, MidiFile, MidiTrack

    base_dir = os.path.join(workdir, "base")
    os.makedirs(base_dir, exist_ok=True)
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for i in range(n_base):
            out = os.path.join("base", f"net_{i}")
            if os.path.exists(os.path.join(out, "midi", "output.mid")):
                continue
            np.random.seed(10_000 + i)
            sim_to_wav(matrices=[None], size=32, use_same_instrument=i % 16,
                       log_path="logs/", out_dir=out, render=False)
    finally:
        os.chdir(cwd)
    bases = [MidiFile(os.path.join(base_dir, f"net_{i}", "midi", "output.mid"))
             for i in range(n_base)]

    root = os.path.join(workdir, "data", "maestro-v3.0.0")
    rng = np.random.RandomState(7)
    total_bytes = 0
    for f in range(n_files):
        d = os.path.join(root, str(2004 + (f % 15)))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"MIDI-Unprocessed_{f:04d}_R1_ORIG_MID--AUDIO_{f}.midi")
        if not os.path.exists(path):
            out = MidiFile(ticks_per_beat=bases[0].ticks_per_beat)
            track = MidiTrack()
            out.tracks.append(track)
            for j in rng.choice(n_base, size=concat, replace=False):
                for msg in bases[j].tracks[0]:
                    if msg.type == "end_of_track":
                        continue
                    track.append(msg)
            track.append(MetaMessage("end_of_track", time=0))
            out.save(path)
        total_bytes += os.path.getsize(path)
    with open(os.path.join(root, "maestro-v3.0.0.json"), "w") as fh:
        fh.write("{}")
    return root, total_bytes


def windows_digest(path: str) -> str:
    """sha256 over every window's roll, durations and beats, in order."""
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    h = hashlib.sha256()
    for roll, dur, beats in data:
        for a in (roll, dur, beats):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def run(workdir: str, n_files: int = 200, concat: int = 6, workers: int | None = None,
        device="cuda"):
    """Build the corpus, pickle it in the three modes (the pickles stay in
    ``workdir`` as ``windows_<mode>.pkl``) and check they are identical.
    Files already in ``workdir`` are kept. Returns ``(summary, launches)``:
    the summary line's dict and K1's launches per mode (the
    ``rasterize_cuda`` counter's increase)."""
    from gandes_tpu_torch.data.datasets import build_window_pickle
    from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda

    workers = workers or max(2, os.cpu_count())
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    root, total_bytes = build_corpus(workdir, n_files, concat)
    n_found = len(glob.glob(os.path.join(root, "**", "*.mid*"), recursive=True))
    print(f"corpus: {n_found} files, {total_bytes / 1e6:.1f} MB "
          f"({time.perf_counter() - t0:.0f}s to build)", flush=True)

    results, digests, launches = {}, {}, {}
    for mode, kw in (("sequential", {}), (f"workers{workers}", {"workers": workers}),
                     ("device_rasterize", {"device_rasterize": True})):
        out_pkl = os.path.join(workdir, f"windows_{mode}.pkl")
        before = rasterize_cuda.launches
        t = time.perf_counter()
        n = build_window_pickle(root, out_pkl, sequence_length=50, device=device, **kw)
        dt = time.perf_counter() - t
        launches[mode] = rasterize_cuda.launches - before
        results[mode] = {"windows": n, "seconds": round(dt, 2),
                         "mb_per_s": round(total_bytes / 1e6 / dt, 3)}
        digests[mode] = windows_digest(out_pkl)
        print(json.dumps({"mode": mode, **results[mode]}), flush=True)
    if len(set(digests.values())) != 1:
        raise AssertionError(f"pickles diverge: {digests}")
    print(json.dumps({"launches": {"roll_rasterize": launches}}), flush=True)
    summary = {"corpus_files": n_found, "corpus_mb": round(total_bytes / 1e6, 1),
               "identical_outputs": True, "results": results}
    print(json.dumps(summary), flush=True)
    return summary, launches


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(argv[0],
        n_files=int(argv[1]) if len(argv) > 1 else 200,
        concat=int(argv[2]) if len(argv) > 2 else 6,
        workers=int(argv[3]) if len(argv) > 3 else None)


if __name__ == "__main__":
    main()
