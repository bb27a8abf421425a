"""Command line of the PyTorch/CUDA port: ``python -m gandes_tpu_torch.cli``.

Ported commands, with ``gandes_tpu/cli.py``'s flags plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions):

    python -m gandes_tpu_torch.cli pickle-dataset --midi-root DIR --out data/preprocessed_data_50.pkl [--device-rasterize]
    python -m gandes_tpu_torch.cli train-mmgan --data data/preprocessed_data_50.pkl --epochs 5
        [--des-parallel 16] [--fused-io]
    python -m gandes_tpu_torch.cli train-gandes --midi-root DIR --steps 20
        [--g-update none|surrogate|reinforce] [--des-parallel 16] [--resume]
    python -m gandes_tpu_torch.cli generate-mmgan [--torch-checkpoint mmgan_64_64_epoch_5.pth] --n 4
    python -m gandes_tpu_torch.cli serve --model mmgan|gandes|both [--torch-checkpoint gen.pt]

``--checkpoint`` (an orbax directory) needs JAX to read: convert it with
``python -m gandes_tpu.cli export-torch --model mmgan|gandes --checkpoint
DIR --out model.pt`` and pass ``--torch-checkpoint model.pt``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _reject_orbax(args, model):
    if args.checkpoint:
        raise SystemExit(
            "--checkpoint takes an orbax directory, which needs JAX to read; convert it "
            f"with `python -m gandes_tpu.cli export-torch --model {model} --checkpoint "
            f"{args.checkpoint} --out model.pt` and pass --torch-checkpoint model.pt")


def _cmd_pickle_dataset(args):
    from gandes_tpu_torch.data.datasets import build_window_pickle

    n = build_window_pickle(args.midi_root, args.out, sample_size=args.sample_size,
                            sequence_length=args.sequence_length, verbose=True,
                            workers=args.workers, device_rasterize=args.device_rasterize,
                            device=args.device)
    print(f"wrote {n} windows -> {args.out}")


def _cmd_train_mmgan(args):
    if args.np_seed is not None:
        # deterministic DES routing: the simulator consumes the global numpy
        # stream (reference parity)
        np.random.seed(args.np_seed)
    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, train_mmgan

    cfg = MMGANConfig(num_epochs=args.epochs, batch_size=args.batch_size, start=args.start,
                      sequence_length=args.sequence_length, lr=args.lr, d_lr=args.d_lr,
                      models_dir=args.models_dir, losses_dir=args.losses_dir,
                      faithful=args.faithful, g_update=args.g_update,
                      des_parallel=args.des_parallel, mesh_shape=args.mesh,
                      fused_io=args.fused_io, profile=args.profile, trace_dir=args.trace_dir,
                      compute_dtype=args.compute_dtype)
    dataset = MaestroDatasetPickle(args.data, data_dir=".")
    state, history = train_mmgan(dataset, cfg, max_batches=args.max_batches, device=args.device)
    print(f"done: {len(history['disc'])} epochs")


def _cmd_train_gandes(args):
    if args.np_seed is not None:
        # deterministic DES routing: the simulator consumes the global numpy
        # stream (reference parity)
        np.random.seed(args.np_seed)
    from gandes_tpu_torch.data.datasets import DataLoader, MaestroDatasetGanDes, my_collate
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig, train_gandes

    # the real side's mels are taken on the training device (K2 on the card)
    dataset = MaestroDatasetGanDes(batch_size=args.batch_size, input_folder=args.midi_root,
                                   sound_font=args.sound_font, device=args.device)
    loader = DataLoader(dataset, batch_size=1, shuffle=True, collate_fn=my_collate)
    cfg = GanDesConfig(batch_size=args.batch_size, model_path=args.models_dir, lr=args.lr,
                       d_lr=args.d_lr, resume=args.resume, g_update=args.g_update,
                       des_parallel=args.des_parallel, mesh_shape=args.mesh,
                       profile=args.profile, trace_dir=args.trace_dir,
                       # the fake path must render with the SAME synth as
                       # the real dataset, or D separates on timbre alone
                       sound_font=args.sound_font, compute_dtype=args.compute_dtype)
    state, history = train_gandes(loader, cfg, max_steps=args.steps, device=args.device)
    print(f"done: {len(history['disc'])} steps")


def _cmd_generate_mmgan(args):
    from gandes_tpu_torch.train.loading import load_mmgan_state
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, generate_midi

    _reject_orbax(args, "mmgan")
    cfg = MMGANConfig(start=args.start, sequence_length=args.sequence_length)
    model = load_mmgan_state(cfg, args.torch_checkpoint, device=args.device)
    rng = np.random.RandomState(args.seed)
    n_failed = 0
    for i in range(args.n):
        noise1 = rng.randn(1, cfg.noise_dim).astype(np.float32)
        noise2 = rng.randn(1, cfg.noise_dim).astype(np.float32)
        beats = np.zeros((1, cfg.max_beat_length), np.float32)
        np.random.seed(args.seed + i)
        src = os.path.join(args.out_dir, "generation.mid")
        if os.path.exists(src):
            os.remove(src)  # a stale file must not masquerade as sample i
        rolls = generate_midi(model, cfg, noise1, noise2, beats, out_dir=args.out_dir)
        if not os.path.exists(src):
            # timed-out/failed sim wrote no file — report, don't crash or
            # silently reuse a stale generation.mid
            print(f"sample {i}: simulation failed, no MIDI written")
            n_failed += 1
            continue
        name = "generation.mid" if args.n == 1 else f"generation_{i}.mid"
        if args.n > 1:
            os.replace(src, os.path.join(args.out_dir, name))
        print(f"generated roll sum={rolls[0].sum():.1f} -> {args.out_dir}/{name}")
        if args.wav:
            from gandes_tpu_torch.data.audio import save_wav
            from gandes_tpu_torch.music.synth import render_midi

            audio = render_midi(os.path.join(args.out_dir, name), device=args.device)
            wav_name = name.replace(".mid", ".wav")
            save_wav(os.path.join(args.out_dir, wav_name), audio)
            print(f"wrote {args.out_dir}/{wav_name}")
    if n_failed:
        print(f"{n_failed} of {args.n} sample(s) failed")
        if n_failed == args.n:
            raise SystemExit(1)  # nothing was generated


def _cmd_serve(args):
    from gandes_tpu_torch.serve import run_server

    _reject_orbax(args, "gandes" if args.model == "gandes" else "mmgan")
    run_server(model=args.model, torch_checkpoint=args.torch_checkpoint, host=args.host,
               port=args.port, warmup=not args.no_warmup, start=args.start,
               sequence_length=args.sequence_length, sound_font=args.sound_font,
               device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="gandes_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pickle-dataset", help="build the windowed roll pickle")
    sp.add_argument("--midi-root", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--sample-size", type=int, default=300)
    sp.add_argument("--sequence-length", type=int, default=50)
    sp.add_argument("--workers", type=int, default=None,
                    help="parse files on a process pool (fast path)")
    sp.add_argument("--device-rasterize", action="store_true",
                    help="rasterize rolls with the batched device kernel")
    sp.add_argument("--device", default="cuda",
                    help="torch device of the fast path's rasterizer (default cuda)")
    sp.set_defaults(fn=_cmd_pickle_dataset)

    sp = sub.add_parser("train-mmgan", help="train the MM-GAN")
    sp.add_argument("--data", required=True)
    sp.add_argument("--lr", type=float, default=0.01,
                    help="G (and default D) learning rate (reference: 0.01)")
    sp.add_argument("--d-lr", type=float, default=None,
                    help="separate D learning rate (GAN balance knob)")
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--start", type=int, default=100)
    sp.add_argument("--sequence-length", type=int, default=50)
    sp.add_argument("--models-dir", default="models")
    sp.add_argument("--losses-dir", default="losses")
    sp.add_argument("--max-batches", type=int, default=None)
    sp.add_argument("--faithful", action="store_true")
    sp.add_argument("--g-update", choices=["none", "direct", "surrogate", "reinforce"],
                    default="none",
                    help="'none' = reference semantics (G gets zero gradient); 'direct' = "
                         "straight-through G training; 'surrogate'/'reinforce' raise "
                         "(not ported yet)")
    sp.add_argument("--np-seed", type=int, default=None,
                    help="seed the global numpy stream (DES routing) at process start")
    sp.add_argument("--profile", action="store_true",
                    help="print a per-phase StepTimer table every print_interval batches")
    # the JAX command's flags for options that are not ported yet: given,
    # they raise NotImplementedError naming their ROADMAP.md Queue 1 item
    sp.add_argument("--mesh", default=None, help="not ported yet: raises")
    sp.add_argument("--des-parallel", type=int, default=None,
                    help="run the batch's DES sims on N threads (fast mode)")
    sp.add_argument("--fused-io", action="store_true",
                    help="one call per batch: G forward + host DES + train step (on CUDA two "
                         "graph replays around the host stage)")
    sp.add_argument("--trace-dir", default=None, help="not ported yet: raises")
    sp.add_argument("--compute-dtype", choices=["float32", "bf16"], default="float32",
                    help="bf16 is not ported yet: raises")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_train_mmgan)

    sp = sub.add_parser("train-gandes", help="train the GAN-DES spectrogram GAN")
    sp.add_argument("--midi-root", required=True)
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path: SF2 playback is not ported and raises (default: additive "
                         "synth)")
    sp.add_argument("--batch-size", type=int, default=30)
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--models-dir", default="models")
    sp.add_argument("--lr", type=float, default=2e-5,
                    help="Adam learning rate (reference default 2e-5)")
    sp.add_argument("--d-lr", type=float, default=None,
                    help="separate D learning rate (GAN balance knob; default: --lr)")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the newest gen_<step>_<ts> checkpoint under "
                         "--models-dir (full state incl. optimizers; the step-derived noise "
                         "streams continue at the saved step; the DES's global-numpy stream "
                         "is process-level, so pass --np-seed for a reproducible "
                         "continuation)")
    sp.add_argument("--g-update", choices=["none", "surrogate", "reinforce"], default="none",
                    help="'none' = reference semantics (G gets zero gradient); 'surrogate' = "
                         "learned matrix->mel surrogate; 'reinforce' = score-function "
                         "estimator through the real DES->synth->mel pipeline")
    sp.add_argument("--np-seed", type=int, default=None,
                    help="seed the global numpy stream (DES routing) at process start")
    sp.add_argument("--des-parallel", type=int, default=None,
                    help="run the batch's DES sims on N threads (fast mode)")
    sp.add_argument("--profile", action="store_true",
                    help="print a per-phase StepTimer table every display_step")
    # the JAX command's flags for options that are not ported yet: given,
    # they raise NotImplementedError naming their ROADMAP.md Queue 1 item
    sp.add_argument("--mesh", default=None, help="not ported yet: raises")
    sp.add_argument("--trace-dir", default=None, help="not ported yet: raises")
    sp.add_argument("--compute-dtype", choices=["float32", "bf16"], default="float32",
                    help="bf16 is not ported yet: raises")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_train_gandes)

    sp = sub.add_parser("generate-mmgan", help="generate a MIDI from a checkpoint")
    sp.add_argument("--checkpoint", default=None,
                    help="orbax checkpoint dir: rejected, see export-torch")
    sp.add_argument("--torch-checkpoint", default=None,
                    help="a reference .pth state_dict (author-trained weights)")
    sp.add_argument("--start", type=int, default=100)
    sp.add_argument("--sequence-length", type=int, default=50)
    sp.add_argument("--out-dir", default="./adj_sim_outputs/midi")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--n", type=int, default=1,
                    help=">1: batch-serve n samples (generation_<i>.mid)")
    sp.add_argument("--wav", action="store_true", help="also synthesize WAV")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_generate_mmgan)

    sp = sub.add_parser("serve", help="warm-model HTTP generation server")
    sp.add_argument("--model", choices=["mmgan", "gandes", "both"], default="mmgan",
                    help="'both' hosts the two model families in one process")
    sp.add_argument("--checkpoint", default=None,
                    help="orbax checkpoint dir: rejected, see export-torch")
    sp.add_argument("--torch-checkpoint", default=None,
                    help="a reference .pth/.pt state_dict (or export-torch output)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8472)
    sp.add_argument("--no-warmup", action="store_true")
    sp.add_argument("--start", type=int, default=100, help="MM-GAN roll crop start")
    sp.add_argument("--sequence-length", type=int, default=50, help="MM-GAN roll length")
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path: SF2 playback is not ported and raises")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
