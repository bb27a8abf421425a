"""GAN-DES training outcome through the DES (the port of
``examples/train_gandes_demo.py``), the other family's counterpart of
``train_surrogate_demo``.

The reference's GAN-DES generator receives exactly zero gradient (the
detach at `GAN_DES/SIMNN.py:299`), so its training can only drift. This
harness measures whether a G-training mode pulls the generated mel
distribution toward the data, with the whole DES -> MIDI -> synth -> mel
chain in the loop:

1. synthesize a dataset of DES-generated MIDI (``n_nets`` random queueing
   networks -> ``sim_to_wav`` MIDIs);
2. measure the initial real-vs-generated mel gap (``eval/metrics.py::
   mel_metrics``, the statistics ``eval-metrics --family gandes`` reports);
3. train GAN-DES (``train_gandes``) with the chosen ``g_update``;
4. measure again; write ``RESULTS.json`` (the JAX harness's keys) and, where
   matplotlib imports, ``loss_curves.png``.

    python -m gandes_tpu_torch.examples.train_gandes_demo [workdir] [steps] [n_nets]
        [g_update] [lr] [d_lr]

``g_update`` in {none, surrogate, reinforce} (default surrogate); ``lr``
defaults to 2e-4 (the reference's 2e-5 moves G too slowly to measure in a
short run; the ``none`` baseline takes the same lr); ``d_lr`` optionally
slows the discriminator. Every mel runs on the device: kernel K2 once per
real slice (the eval pool and the training set) and once per generated
clip on a CUDA device.

Runs on ``cuda``; ``GANDES_DEMO_CPU=1`` runs it on the CPU (``run(...,
device="cpu")`` from Python). The eval noise is a ``torch.Generator`` draw
seeded with the eval seed (99), a different stream from the JAX harness's
``jax.random.key(99)``; the outcome numbers are the port's own. The eval
pool is three training batches (48 at the default B = 16, as in the JAX
harness) and the host stage runs B sims at a time (16, as there).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from gandes_tpu_torch.examples.train_surrogate_demo import loss_curves


def build_dataset(workdir: str, n_nets: int = 16) -> str:
    """``n_nets`` sim MIDIs (numpy seed i for net i) in ``workdir/midis``;
    returns that directory."""
    from gandes_tpu_torch.bridge.sim_demo import sim_to_wav

    midi_dir = os.path.join(workdir, "midis")
    os.makedirs(midi_dir, exist_ok=True)
    for seed in range(n_nets):
        np.random.seed(seed)
        out_dir = os.path.join(workdir, f"net_{seed}")
        # mels render from the .mid through the training loop's synth
        sim_to_wav(matrices=[None], size=32, use_same_instrument=seed % 16,
                   log_path=os.path.join(workdir, "logs") + "/", out_dir=out_dir, render=False)
        os.replace(os.path.join(out_dir, "midi", "output.mid"),
                   os.path.join(midi_dir, f"net_{seed}.mid"))
    print(f"dataset: {n_nets} simulated-network MIDIs")
    return midi_dir


def real_mels(midi_dir: str, n: int, device="cuda"):
    """Up to ``n`` full-window mel slices, round-robin over the MIDIs
    (``collect_real_mels``, seed 0), as one tensor on ``device``."""
    from gandes_tpu_torch.data.datasets import collect_real_mels

    mels, n_files = collect_real_mels(midi_dir, n, seed=0, device=device)
    print(f"real side drawn from {n_files} network MIDIs")
    return mels


def eval_noise(cfg, n: int, seed: int):
    """(n, z_dim) float32: a ``torch.Generator`` draw seeded with ``seed``."""
    import torch

    return torch.randn(n, cfg.z_dim, generator=torch.Generator().manual_seed(seed))


def generated_mels(state, cfg, n: int, seed: int, workdir: str, *, noise=None,
                   parallel: int = 16):
    """Eval-mode DCGAN (``gandes_eval_forward``) -> ``matrix_to_wav`` after
    ``np.random.seed(seed)`` (``parallel`` sims at a time, no WAVs) ->
    (n, 128, 216) mel-dB on the generator's device. ``noise`` replaces
    ``eval_noise(cfg, n, seed)``."""
    import torch

    from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
    from gandes_tpu_torch.train.loading import gandes_eval_forward

    device = next(state.gen.parameters()).device
    z = torch.as_tensor(eval_noise(cfg, n, seed) if noise is None else noise)
    mats = gandes_eval_forward(state.gen)(z.to(device, torch.float32))
    np.random.seed(seed)
    return matrix_to_wav(
        mats.cpu().numpy(), size=20, start=0, end=cfg.mel_shape[1], write_wav=False,
        parallel=parallel, log_path=os.path.join(workdir, "logs") + "/",
        out_dir=os.path.join(workdir, "eval_out"), number_of_customers=cfg.number_of_customers,
        max_sim_time=cfg.max_sim_time, device=device)


def gap(real, fake) -> dict:
    """``compare_distributions`` of the two sides' ``mel_metrics``, as
    floats."""
    from gandes_tpu_torch.eval.metrics import compare_distributions, mel_metrics

    return {k: float(v) for k, v in
            compare_distributions(mel_metrics(real), mel_metrics(fake)).items()}


def run(workdir: str = "gandes_demo", steps: int = 128, n_nets: int = 16,
        g_update: str = "surrogate", lr: float = 2e-4, d_lr: float | None = None, *,
        batch_size: int = 16, device="cuda") -> dict:
    """The whole harness; returns the ``RESULTS.json`` dict."""
    from gandes_tpu_torch.data.datasets import DataLoader, MaestroDatasetGanDes, my_collate
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig, build_gandes, train_gandes
    from gandes_tpu_torch.train.steps import init_gandes_state

    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    midi_dir = build_dataset(workdir, n_nets)
    cfg = GanDesConfig(
        batch_size=batch_size, lr=lr, d_lr=d_lr, g_update=g_update, des_parallel=16,
        write_wav=False, pad_batches=True,
        n_epochs=-(-steps // n_nets),  # the loop stops at max_steps
        model_path=os.path.join(workdir, "models") + "/",
        log_path=os.path.join(workdir, "logs") + "/",
        out_dir=os.path.join(workdir, "train_out"),
        # a checkpoint every 32 steps at most, so a long run leaves
        # eval-metrics --checkpoints-dir a grid to select from
        save_step=max(min(steps // 4, 32), 1), display_step=16, seed=0,
    )
    parallel = min(16, batch_size)
    n_eval = 3 * batch_size
    launches0 = mel_power_cuda.launches

    real = real_mels(midi_dir, n_eval, device=device)
    print(f"real side: {real.shape[0]} mel slices of {real.shape[-1]} frames")

    gen, disc = build_gandes(cfg)  # the loop's own initial weights
    state0 = init_gandes_state(gen.to(device), disc.to(device), cfg.lr)
    gap0 = gap(real, generated_mels(state0, cfg, n_eval, seed=99, workdir=workdir,
                                    parallel=parallel))
    print("initial gap:", json.dumps(gap0))

    dataset = MaestroDatasetGanDes(batch_size=cfg.batch_size, input_folder=midi_dir,
                                   device=device)
    loader = DataLoader(dataset, batch_size=1, shuffle=True, collate_fn=my_collate)
    np.random.seed(0)
    t = time.perf_counter()
    state, history = train_gandes(loader, cfg, max_steps=steps, device=device)
    train_s = time.perf_counter() - t

    gap1 = gap(real, generated_mels(state, cfg, n_eval, seed=99, workdir=workdir,
                                    parallel=parallel))
    print("final gap:  ", json.dumps(gap1))

    results = {
        "steps": len(history["disc"]), "g_update": g_update, "lr": lr, "d_lr": d_lr,
        "disc_loss_first10": float(np.mean(history["disc"][:10])),
        "disc_loss_last10": float(np.mean(history["disc"][-10:])),
        "gen_loss_first10": float(np.mean(history["gen"][:10])),
        "gen_loss_last10": float(np.mean(history["gen"][-10:])),
        "disc_losses": history["disc"], "gen_losses": history["gen"],
        "gap_initial": gap0, "gap_final": gap1,
    }
    with open(os.path.join(workdir, "RESULTS.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"train_s": round(train_s, 3),
                      "steps_per_s": round(len(history["disc"]) / train_s, 3),
                      "device": str(device),
                      "launches": {"mel_power": mel_power_cuda.launches - launches0}}))
    loss_curves(os.path.join(workdir, "loss_curves.png"), history["disc"], history["gen"],
                "step", g_update)
    improved = sum(gap1[k] < gap0[k] for k in gap0)
    print(f"gap improved on {improved}/{len(gap0)} metrics -> {workdir}/RESULTS.json")
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(argv[0] if len(argv) > 0 else "gandes_demo",
        steps=int(argv[1]) if len(argv) > 1 else 128,
        n_nets=int(argv[2]) if len(argv) > 2 else 16,
        g_update=argv[3] if len(argv) > 3 else "surrogate",
        lr=float(argv[4]) if len(argv) > 4 else 2e-4,
        d_lr=float(argv[5]) if len(argv) > 5 else None,
        device="cpu" if os.environ.get("GANDES_DEMO_CPU") else "cuda")


if __name__ == "__main__":
    main()
