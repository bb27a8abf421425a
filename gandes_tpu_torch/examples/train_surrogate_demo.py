"""MM-GAN training outcome through the DES (the port of
``examples/train_surrogate_demo.py``).

The reference's generators receive exactly zero gradient through the DES,
so its training can only drift. This harness measures whether a G-training
mode (``g_update='surrogate'``, a learned differentiable DES surrogate
fitted online, or ``'reinforce'``) pulls the generated rolls toward the
data, with the DES in the loop:

1. synthesize a dataset of DES-generated MIDI (``n_nets`` random queueing
   networks -> ``sim_to_wav`` MIDIs -> 50-step piano-roll windows);
2. measure the initial real-vs-generated gap (``eval/metrics.py``);
3. train MM-GAN (``train_mmgan``) with the chosen ``g_update``;
4. measure again; write ``RESULTS.json`` (the JAX harness's keys) and, where
   matplotlib imports, ``loss_curves.png``.

    python -m gandes_tpu_torch.examples.train_surrogate_demo [workdir] [epochs]
        [n_nets] [g_update] [d_lr]

Runs on ``cuda``; ``GANDES_DEMO_CPU=1`` runs it on the CPU (``run(...,
device="cpu")`` from Python). The eval noise (``noise1``, ``noise2`` and
G1's aux block) is one ``torch.Generator`` draw seeded with the eval seed
(99), a different stream from the JAX harness's ``jax.random`` keys, so the
outcome numbers are the port's own. The eval batch is four training
batches (64 at the default B = 16, as in the JAX harness) and the host
stage runs B sims at a time (16, as there).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np


def build_dataset(workdir: str, n_nets: int = 24) -> str:
    """``n_nets`` sim MIDIs (numpy seed i for net i) pickled into 50-step
    windows by the sequential pickler; returns the pickle's path."""
    from gandes_tpu_torch.bridge.sim_demo import sim_to_wav
    from gandes_tpu_torch.data.datasets import build_window_pickle

    midi_dir = os.path.join(workdir, "midis")
    os.makedirs(midi_dir, exist_ok=True)
    for seed in range(n_nets):
        np.random.seed(seed)
        out_dir = os.path.join(workdir, f"net_{seed}")
        # windows come from the .mid: no synth pass
        sim_to_wav(matrices=[None], size=32, use_same_instrument=seed % 16,
                   log_path=os.path.join(workdir, "logs") + "/", out_dir=out_dir, render=False)
        os.replace(os.path.join(out_dir, "midi", "output.mid"),
                   os.path.join(midi_dir, f"net_{seed}.mid"))
    pkl = os.path.join(workdir, "windows.pkl")
    n = build_window_pickle(midi_dir, pkl, sequence_length=50)
    print(f"dataset: {n} windows from {n_nets} simulated networks")
    return pkl


def eval_noise(cfg, batch: int, seed: int):
    """``(noise1, noise2, aux)``, each (batch, noise_dim) float32: one
    ``torch.Generator`` draw seeded with ``seed``."""
    import torch

    return tuple(torch.randn(3, batch, cfg.noise_dim,
                             generator=torch.Generator().manual_seed(seed)))


def generated_rolls(state, cfg, batch: int, seed: int, workdir: str, *, noise=None,
                    parallel: int = 16):
    """Eval-mode G1/G2 (``eval_forward``) -> DES (``force_roll``: every roll
    decoded, no artifacts; ``parallel`` sims at a time) -> ``(rolls (batch,
    2, 128, 50), failed)``. ``noise`` replaces ``eval_noise(cfg, batch,
    seed)``."""
    import torch

    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi
    from gandes_tpu_torch.train.mmgan_loop import eval_forward

    noise1, noise2, aux = eval_noise(cfg, batch, seed) if noise is None else noise
    beats = torch.zeros(batch, cfg.max_beat_length)
    out1, out2 = eval_forward(state.model, noise1, noise2, beats, aux=aux)
    rolls, failed = matrix_to_midi(
        out1.cpu().numpy()[:, None], out2.cpu().numpy(), adj_size=cfg.adj_size,
        instrument=cfg.instrument, start=cfg.start, end=cfg.start + cfg.sequence_length,
        force_roll=True, log_path=os.path.join(workdir, "logs") + "/",
        out_dir=os.path.join(workdir, "eval_midi"), parallel=parallel)
    return np.stack(rolls), failed


def gap(real_rolls, fake_rolls) -> dict:
    """``compare_distributions`` of the two sides' roll metrics and
    pitch-class histograms, as floats."""
    from gandes_tpu_torch.eval.metrics import (
        compare_distributions,
        pitch_class_histogram,
        roll_metrics,
    )

    rm = dict(roll_metrics(real_rolls), pitch_classes=pitch_class_histogram(real_rolls))
    fm = dict(roll_metrics(fake_rolls), pitch_classes=pitch_class_histogram(fake_rolls))
    return {k: float(v) for k, v in compare_distributions(rm, fm).items()}


def loss_curves(path: str, disc, gen, xlabel: str, title: str) -> None:
    """D's and G's loss curves side by side in ``path`` where matplotlib
    imports; without it, names the plot as skipped."""
    if importlib.util.find_spec("matplotlib") is None:
        print(f"{os.path.basename(path)} skipped: matplotlib is not installed")
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 2, figsize=(9, 3.2))
    ax[0].plot(disc)
    ax[0].set_title(f"D loss / {xlabel}")
    ax[1].plot(gen)
    ax[1].set_title(f"G loss / {xlabel} ({title})")
    for a in ax:
        a.set_xlabel(xlabel)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def run(workdir: str = "surrogate_demo", epochs: int = 20, n_nets: int = 24,
        g_update: str = "surrogate", d_lr: float | None = None, *, batch_size: int = 16,
        device="cuda") -> dict:
    """The whole harness; returns the ``RESULTS.json`` dict."""
    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, init_state_for_config, train_mmgan

    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    pkl = build_dataset(workdir, n_nets)
    ds = MaestroDatasetPickle(pkl, data_dir=".")
    n_eval = 4 * batch_size
    real = np.stack([np.stack([r, d]) for r, d, _ in
                     (ds[i] for i in range(min(n_eval, len(ds))))])

    cfg = MMGANConfig(
        batch_size=batch_size, start=0, sequence_length=50, num_epochs=epochs,
        g_update=g_update, des_parallel=16, resume=False,
        # the reference's lr 0.01 collapses the game within ~30 steps once G
        # is live; 1e-3 keeps D and G balanced on this small set, and an
        # optional slower D (d_lr) holds the balance over a longer run
        lr=1e-3, d_lr=d_lr, surrogate_lr=1e-3,
        models_dir=os.path.join(workdir, "models"),
        losses_dir=os.path.join(workdir, "losses"),
        log_path=os.path.join(workdir, "logs") + "/",
        midi_out_dir=os.path.join(workdir, "midi"),
        seed=0,
    )
    parallel = min(16, batch_size)

    state0, _ = init_state_for_config(cfg, device=device)
    fake0, failed0 = generated_rolls(state0, cfg, n_eval, seed=99, workdir=workdir,
                                     parallel=parallel)
    gap0 = gap(real, fake0)
    print("initial gap:", json.dumps(gap0))

    np.random.seed(0)
    t = time.perf_counter()
    state, history = train_mmgan(ds, cfg, device=device)
    train_s = time.perf_counter() - t

    fake1, failed1 = generated_rolls(state, cfg, n_eval, seed=99, workdir=workdir,
                                     parallel=parallel)
    gap1 = gap(real, fake1)
    print("final gap:  ", json.dumps(gap1))

    disc_curve = [float(np.mean(e)) for e in history["disc"]]
    gen_curve = [float(np.mean(e)) for e in history["gen"]]
    steps = sum(len(e) for e in history["disc"])
    results = {
        "epochs": epochs,
        "g_update": g_update,
        "d_lr": d_lr,
        "steps": steps,
        "disc_loss_first_epoch": disc_curve[0],
        "disc_loss_last_epoch": disc_curve[-1],
        "gen_loss_first_epoch": gen_curve[0],
        "gen_loss_last_epoch": gen_curve[-1],
        "disc_loss_per_epoch": disc_curve,
        "gen_loss_per_epoch": gen_curve,
        "gap_initial": gap0,
        "gap_final": gap1,
        "failed_sims_eval": [int(failed0), int(failed1)],
    }
    with open(os.path.join(workdir, "RESULTS.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"train_s": round(train_s, 3),
                      "steps_per_s": round(steps / train_s, 3), "device": str(device)}))
    loss_curves(os.path.join(workdir, "loss_curves.png"), disc_curve, gen_curve, "epoch",
                g_update)
    improved = sum(gap1[k] < gap0[k] for k in gap0)
    print(f"gap improved on {improved}/{len(gap0)} metrics -> {workdir}/RESULTS.json")
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(argv[0] if len(argv) > 0 else "surrogate_demo",
        epochs=int(argv[1]) if len(argv) > 1 else 20,
        n_nets=int(argv[2]) if len(argv) > 2 else 24,
        g_update=argv[3] if len(argv) > 3 else "surrogate",
        d_lr=float(argv[4]) if len(argv) > 4 else None,
        device="cpu" if os.environ.get("GANDES_DEMO_CPU") else "cuda")


if __name__ == "__main__":
    main()
