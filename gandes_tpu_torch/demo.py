"""End-to-end demo of the port — the reference `demo.ipynb` as a script, the
counterpart of ``examples/demo.py``.

    python -m gandes_tpu_torch.demo [--checkpoint models/mmgan_64_64_epoch_N]
        [--out demo_out] [--seed 0] [--play] [--sound-font FONT.sf2] [--device cuda]

Renders random queueing networks with instrument presets to WAV
(``sim_to_wav``), generates a piece with the MM-GAN through the DES
(``generation.mid``), synthesizes it (``generation.wav``), takes its mel on
``--device`` (kernel K2 on a CUDA device), and draws the spectrogram, the
piano roll and the queue-length animation of the last simulation log.
Everything lands in ``--out``. ``--checkpoint`` takes a ``train-mmgan``
checkpoint directory or a reference-layout ``.pth`` (the JAX demo takes an
orbax directory: convert it with ``python -m gandes_tpu.cli export-torch``).
The plots need matplotlib, which the generation path does not: without it
the demo writes everything else and names each plot it skipped.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gandes_tpu_torch.demo")
    ap.add_argument("--checkpoint", default=None,
                    help="train-mmgan checkpoint directory or reference .pth")
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--play", action="store_true",
                    help="play the generated piece (pygame, like the reference notebook; "
                         "falls back to aplay/paplay)")
    ap.add_argument("--sound-font", default=None, help=".sf2 path: synthesize by sample playback")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    os.makedirs("logs", exist_ok=True)

    import torch

    from gandes_tpu_torch.bridge.sim_demo import sim_to_wav
    from gandes_tpu_torch.core.profiling import span
    from gandes_tpu_torch.data.audio import load_wav, play_wav, save_wav
    from gandes_tpu_torch.eval.visualize import (
        plot_spectrogram,
        simulation_log_to_gif,
        visualize_piano_roll,
    )
    from gandes_tpu_torch.music.mel import melspectrogram_db_tensor
    from gandes_tpu_torch.music.synth import render_midi
    from gandes_tpu_torch.train.loading import load_mmgan_state
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, generate_midi

    has_mpl = importlib.util.find_spec("matplotlib") is not None

    def plot(name, draw):
        if has_mpl:
            draw(os.path.join(args.out, name))
            print(f"  {name}")
        else:
            print(f"  {name} skipped: matplotlib is not installed")

    # 1. instrument-preset random networks (demo.ipynb cells 13-22)
    print("== random queueing networks with instrument presets ==")
    np.random.seed(args.seed)
    for name, program in [("piano", 0), ("marimba", 12), ("organ", 19)]:
        outs = sim_to_wav(matrices=[None], size=32, use_same_instrument=program,
                          out_dir=os.path.join(args.out, f"preset_{name}"), device=args.device)
        print(f"  {name}: {outs[0]}")

    # 2. MM-GAN generation through the DES (cells 25-28)
    print("== MM-GAN generation ==")
    cfg = MMGANConfig(start=100, sequence_length=50)
    model = load_mmgan_state(cfg, args.checkpoint, device=args.device)
    if args.checkpoint:
        print(f"  loaded {args.checkpoint}")
    rng = np.random.RandomState(args.seed)
    noise1 = rng.randn(1, cfg.noise_dim).astype(np.float32)
    noise2 = rng.randn(1, cfg.noise_dim).astype(np.float32)
    beats = np.zeros((1, cfg.max_beat_length), np.float32)
    np.random.seed(args.seed)
    rolls = generate_midi(model, cfg, noise1, noise2, beats,
                          out_dir=os.path.join(args.out, "mmgan"))
    mid_path = os.path.join(args.out, "mmgan", "generation.mid")
    print(f"  roll sum={rolls[0].sum():.0f} -> {mid_path}")
    plot("piano_roll.png", lambda p: visualize_piano_roll(rolls[0][0], save_path=p))

    # 3. synthesize + spectrogram (cells 2-4, 28)
    audio = render_midi(mid_path, sound_font=args.sound_font, device=args.device)
    wav_path = os.path.join(args.out, "generation.wav")
    save_wav(wav_path, audio)
    with span("mel"):
        mel = melspectrogram_db_tensor(torch.from_numpy(load_wav(wav_path)[0]).to(args.device))
    print(f"  {wav_path} ({len(audio) / 44100:.1f}s), mel {tuple(mel.shape)} on {mel.device}")
    plot("spectrogram.png", lambda p: plot_spectrogram(mel, save_path=p))

    # 3b. playback (cells 25-28 used pygame.mixer on generation output)
    if args.play:
        ok = play_wav(wav_path)
        print("  played generation.wav" if ok
              else "  no audio device available; wrote generation.wav")

    # 4. queue-length animation from the last sim log (simlog_to_vid.ipynb)
    if os.path.exists("logs/simulation.log"):
        plot("simulation.gif", lambda p: simulation_log_to_gif("logs/simulation.log",
                                                               out_path=p))

    print(f"done -> {args.out}/")


if __name__ == "__main__":
    main()
