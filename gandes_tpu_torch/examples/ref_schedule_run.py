"""Reference-schedule MM-GAN training run (the port of
``examples/ref_schedule_run.py``).

Matches the reference's data and step scale (its committed
``losses/gen_losses_epoch_1.pkl``: 337 steps an epoch at batch 16 on 5,392
MAESTRO windows, trained to epoch 36 and past): builds a corpus of at
least 5,392 windows with the port's own tooling (random DES networks ->
MIDI -> 50-step piano-roll windows, 256 networks at a time; MAESTRO is not
in the repository), then trains MM-GAN in ``surrogate`` mode (lr 1e-3, D at
1e-4, ``des_parallel=16``) for 40 epochs = 13,480 steps, a checkpoint every
epoch. Resumable: a second call continues from the newest epoch checkpoint
(an existing pickle with enough windows is reused).

    python -m gandes_tpu_torch.examples.ref_schedule_run WORKDIR [epochs]
        [--instance-noise S] [--instance-noise-anneal E] [--instance-noise-floor F]
        [--r1-gamma G] [--r1-mode exact|fd] [--r1-fd-eps E] [--moment-match L]
        [--moment-match-cond L] [--seed N] [--np-seed N]

The flags are the adversarial-balance knobs of ``MMGANConfig``; their
defaults leave the step as it is. ``--np-seed`` seeds the global numpy
stream (the DES routing) before training. A thread prints the process's
RSS every two minutes, and the run ends with ``DONE: <steps> steps in <s>s
(<s/step>), max RSS <MB> MB``. The JAX harness's ``--recycle-every``
(epochs in fresh processes, for a client-side host-to-device leak of the
TPU runtime) is not taken.

``GANDES_REFSCHED_WINDOWS`` and ``GANDES_REFSCHED_STEPS`` shrink the corpus
and the epoch (defaults 5,392 and 337). Runs on ``cuda``; ``run(...,
device="cpu")`` from Python runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import resource
import sys
import threading
import time

import numpy as np

# the reference's window count (337 x 16) and epoch length
TARGET_WINDOWS = int(os.environ.get("GANDES_REFSCHED_WINDOWS", "5392"))
STEPS_PER_EPOCH = int(os.environ.get("GANDES_REFSCHED_STEPS", "337"))
RSS_EVERY_S = 120.0


def build_corpus(workdir: str, target_windows: int | None = None) -> str:
    """``workdir/windows.pkl`` with at least ``target_windows`` (default
    ``TARGET_WINDOWS``) windows: sim MIDIs of nets 0, 1, ... (numpy seed i for
    net i), 256 at a time, pickled by the sequential pickler after each
    chunk. An existing pickle that is large enough is reused."""
    from gandes_tpu_torch.bridge.sim_demo import sim_to_wav
    from gandes_tpu_torch.data.datasets import build_window_pickle

    target = TARGET_WINDOWS if target_windows is None else target_windows
    pkl = os.path.join(workdir, "windows.pkl")
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            n = len(pickle.load(f))
        if n >= target:
            print(f"corpus: reusing {pkl} ({n} windows)", flush=True)
            return pkl
    midi_dir = os.path.join(workdir, "midis")
    os.makedirs(midi_dir, exist_ok=True)
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    t0 = time.perf_counter()
    seed, n = 0, 0
    # windows per net vary (~4 on average): whole chunks until the target
    while n < target:
        chunk_end = seed + 256
        while seed < chunk_end:
            np.random.seed(seed)
            out = os.path.join(workdir, f"net_{seed}")
            sim_to_wav(matrices=[None], size=32, use_same_instrument=seed % 16,
                       log_path=os.path.join(workdir, "logs") + "/", out_dir=out, render=False)
            os.replace(os.path.join(out, "midi", "output.mid"),
                       os.path.join(midi_dir, f"net_{seed}.mid"))
            seed += 1
        n = build_window_pickle(midi_dir, pkl, sequence_length=50)
        print(f"corpus: {seed} nets -> {n} windows ({time.perf_counter() - t0:.0f}s)",
              flush=True)
    return pkl


def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1])
    return 0


def _watch_rss(stop: threading.Event, t0: float, every_s: float) -> None:
    """One ``[rss]`` line per ``every_s`` until ``stop`` is set, so the run
    log shows whether memory stays flat over thousands of DES round trips."""
    while not stop.wait(every_s):
        print(f"[rss] {_rss_kb()} kB t={time.perf_counter() - t0:.0f}s", flush=True)


def run(workdir: str, epochs: int = 40, *, seed: int = 0, np_seed: int | None = None,
        target_windows: int | None = None, steps_per_epoch: int | None = None,
        device="cuda", **balance):
    """Build (or reuse) the corpus, then train to ``epochs`` from the newest
    checkpoint under ``workdir/models``. ``balance`` takes ``MMGANConfig``'s
    balance fields (``instance_noise_sigma``, ``r1_gamma``, ...). The paths
    (``models/``, ``losses/``, ``logs/``) are relative to ``workdir``, as in
    the JAX harness, which runs from there. Returns ``(state, history,
    done)``, ``done`` the DONE line's numbers."""
    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, train_mmgan

    steps = STEPS_PER_EPOCH if steps_per_epoch is None else steps_per_epoch
    os.makedirs(workdir, exist_ok=True)
    pkl = build_corpus(workdir, target_windows)
    cwd = os.getcwd()
    os.chdir(workdir)
    stop = threading.Event()
    try:
        if np_seed is not None:
            np.random.seed(np_seed)
        ds = MaestroDatasetPickle(os.path.basename(pkl), data_dir=".")
        cfg = MMGANConfig(batch_size=16, start=0, num_epochs=epochs, save_interval=1,
                          g_update="surrogate", lr=1e-3, d_lr=1e-4, des_parallel=16,
                          resume=True, print_interval=50, seed=seed, **balance)
        t0 = time.perf_counter()
        threading.Thread(target=_watch_rss, args=(stop, t0, RSS_EVERY_S), daemon=True).start()
        # steps_per_epoch pins both the epoch length and the StepLR(30, 0.1)
        # boundary to the reference's epochs (the corpus overshoots the
        # window target by up to a chunk, so len(loader) > steps)
        state, hist = train_mmgan(ds, cfg, steps_per_epoch=steps, max_batches=steps,
                                  device=device)
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        os.chdir(cwd)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    n_steps = sum(len(e) for e in hist["disc"])
    print(json.dumps({"epoch_mean_losses": [
        {"disc": float(np.mean(d)), "gen": float(np.mean(g))}
        for d, g in zip(hist["disc"], hist["gen"])]}), flush=True)
    print(f"DONE: {n_steps} steps in {wall:.0f}s ({wall / max(n_steps, 1):.2f} s/step), "
          f"max RSS {rss_mb:.0f} MB", flush=True)
    return state, hist, {"steps": n_steps, "wall_s": wall, "max_rss_mb": rss_mb}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gandes_tpu_torch.examples.ref_schedule_run")
    ap.add_argument("workdir")
    ap.add_argument("epochs", nargs="?", type=int, default=40)
    ap.add_argument("--instance-noise", type=float, default=0.0)
    ap.add_argument("--instance-noise-anneal", type=float, default=None)
    ap.add_argument("--instance-noise-floor", type=float, default=0.0)
    ap.add_argument("--r1-gamma", type=float, default=0.0)
    ap.add_argument("--r1-mode", choices=["exact", "fd"], default="exact")
    ap.add_argument("--r1-fd-eps", type=float, default=0.5)
    ap.add_argument("--moment-match", type=float, default=0.0)
    ap.add_argument("--moment-match-cond", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--np-seed", type=int, default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    run(args.workdir, args.epochs, seed=args.seed, np_seed=args.np_seed,
        instance_noise_sigma=args.instance_noise,
        instance_noise_anneal_epochs=args.instance_noise_anneal,
        instance_noise_floor=args.instance_noise_floor, r1_gamma=args.r1_gamma,
        r1_mode=args.r1_mode, r1_fd_eps=args.r1_fd_eps, moment_match=args.moment_match,
        moment_match_cond=args.moment_match_cond)


if __name__ == "__main__":
    main()
