"""Command line of the PyTorch/CUDA port: ``python -m gandes_tpu_torch.cli``.

Ported commands, with ``gandes_tpu/cli.py``'s flags plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions):

    python -m gandes_tpu_torch.cli pickle-dataset --midi-root DIR --out data/preprocessed_data_50.pkl [--device-rasterize]
    python -m gandes_tpu_torch.cli train-mmgan --data data/preprocessed_data_50.pkl --epochs 5
        [--des-parallel 16] [--fused-io] [--g-update none|direct|surrogate|reinforce]
        [--instance-noise S] [--instance-noise-anneal E] [--instance-noise-floor S]
        [--r1-gamma G] [--r1-mode exact|fd] [--r1-fd-eps E] [--moment-match L]
        [--moment-match-cond L] [--compute-dtype float32|bf16] [--trace-dir DIR]
    python -m gandes_tpu_torch.cli train-gandes --midi-root DIR --steps 20
        [--g-update none|surrogate|reinforce] [--des-parallel 16] [--resume]
        [--compute-dtype float32|bf16] [--trace-dir DIR]
    python -m gandes_tpu_torch.cli generate-mmgan [--torch-checkpoint models/mmgan_64_64_epoch_5] --n 4
    python -m gandes_tpu_torch.cli generate-gandes [--torch-checkpoint models/gen_5_<ts>] --n 4
        [--seed 0] [--out-dir adj_sim_outputs] [--sound-font FONT.sf2]
    python -m gandes_tpu_torch.cli doctor [--fluidsynth-ab FONT.sf2 [--ab-midi x.mid]]
    python -m gandes_tpu_torch.cli render-graph --model mmgan|gandes [--batch 4] [--out-dir graphs]
    python -m gandes_tpu_torch.cli serve --model mmgan|gandes|both [--torch-checkpoint gen.pt]
    python -m gandes_tpu_torch.cli sim-to-wav [--sound-font FluidR3_GM.sf2] [--size 32]
        [--instrument P] [--out-dir adj_sim_outputs] [--seed 0]
    python -m gandes_tpu_torch.cli eval-metrics --data data/preprocessed_data_50.pkl
        [--family mmgan|gandes] [--torch-checkpoint CKPT | --checkpoints-dir models]
        [--rank-by avg_rank|<gap key>] [--n 16] [--seed 0] [--des-parallel 16]
    python -m gandes_tpu_torch.cli bench [--all]

``--sound-font FONT.sf2`` (``serve``, ``train-gandes``, ``eval-metrics
--family gandes``, ``sim-to-wav``) renders the GAN-DES audio by SF2 sample
playback from that font (``music/sf2.py``) instead of the additive synth.

``eval-metrics`` prints a JSON object with the JAX command's keys. Its
generated side's noise (and, for MM-GAN, G1's aux input) comes from a
``torch.Generator`` seeded with ``--seed``, a different stream from the JAX
command's ``jax.random`` draws; its real side draws none. So does
``generate-gandes``'s noise.

``--compute-dtype bf16`` trains in bfloat16 mixed precision (params,
optimizer state and BatchNorm statistics stay float32); ``--trace-dir DIR``
writes a ``torch.profiler`` Chrome trace of the run into DIR. The plots of
``generate-gandes`` and ``render-graph`` need matplotlib, which the
training and serving paths do not.

``--checkpoint`` (an orbax directory) needs JAX to read: convert it with
``python -m gandes_tpu.cli export-torch --model mmgan|gandes --checkpoint
DIR --out model.pt`` and pass ``--torch-checkpoint model.pt``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

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
                      compute_dtype=args.compute_dtype,
                      instance_noise_sigma=args.instance_noise,
                      instance_noise_anneal_epochs=args.instance_noise_anneal,
                      r1_gamma=args.r1_gamma, moment_match=args.moment_match,
                      moment_match_cond=args.moment_match_cond, r1_mode=args.r1_mode,
                      r1_fd_eps=args.r1_fd_eps, instance_noise_floor=args.instance_noise_floor)
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


def generate_gandes(torch_checkpoint=None, n=1, seed=0, out_dir="adj_sim_outputs",
                    sound_font=None, device="cuda"):
    """``generate-gandes`` without its plot: ``n`` songs from the eval-mode
    DCGAN (``torch_checkpoint``: a reference ``gen_*.pt`` or a
    ``train-gandes`` ``gen_{step}_{ts}`` directory; else the seed-0 init)
    through ``matrix_to_wav`` on ``device`` (K2 once per clip), the WAVs
    under ``out_dir/wav``. The noise is a ``torch.Generator`` draw seeded
    with ``seed`` (the JAX command draws ``jax.random.normal(key(seed))``: a
    different stream); the DES's global numpy stream is seeded with ``seed``,
    as the JAX command seeds it. Returns the (n, 128, 216) mel-dB batch."""
    import torch

    from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig
    from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

    cfg = GanDesConfig()
    gen, _ = load_gandes_state(cfg, torch_checkpoint, device=device)
    noise = torch.randn(n, cfg.z_dim, generator=torch.Generator().manual_seed(seed))
    mats = gandes_eval_forward(gen)(noise.to(device))
    np.random.seed(seed)
    os.makedirs(out_dir, exist_ok=True)
    return matrix_to_wav(mats.cpu().numpy(), size=20, start=0, end=216, out_dir=out_dir,
                         sound_font=sound_font, device=device)


def _cmd_generate_gandes(args):
    import importlib.util

    from gandes_tpu_torch.eval.visualize import plot_spectrogram

    _reject_orbax(args, "gandes")
    specs = generate_gandes(args.torch_checkpoint, args.n, args.seed, args.out_dir,
                            args.sound_font, args.device)
    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit(f"generated {args.n} song(s): WAVs in {args.out_dir}/wav; "
                         "spectrogram.png needs matplotlib, which is not installed")
    plot_spectrogram(specs[0], save_path=os.path.join(args.out_dir, "spectrogram.png"))
    print(f"generated {args.n} song(s): WAVs + spectrogram.png in {args.out_dir}/")


def _doctor_rows(device) -> list:
    """The ``doctor`` checks on ``device``: ``(name, ok, seconds, detail)``
    rows. A kernel row runs the kernel on a CUDA device and its plain
    version on the CPU (the package's dispatch) against the plain version on
    the CPU: K2 at rtol 2e-3 / atol 1e-4 of the largest power, K1 bitwise."""
    import tempfile
    import time

    import torch

    rows = []

    def check(name, fn):
        t0 = time.perf_counter()
        try:
            detail = fn() or ""
            rows.append((name, True, time.perf_counter() - t0, detail))
        except Exception as e:
            rows.append((name, False, time.perf_counter() - t0, f"{type(e).__name__}: {e}"))

    def c_torch():
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("torch.cuda.is_available() is false (--device cpu checks "
                                   "the CPU)")
            return (f"{torch.cuda.get_device_name(device)}, {torch.cuda.device_count()} "
                    f"device(s), torch {torch.__version__}, CUDA {torch.version.cuda}")
        return f"cpu, {torch.get_num_threads()} thread(s), torch {torch.__version__}"

    def c_matmul():
        x = torch.eye(128, device=device)
        out = float((x @ x).sum())
        if out != 128.0:
            raise RuntimeError(f"(I @ I).sum() = {out}, not 128")
        return f"128x128 matmul on {device}"

    def c_native_engine():
        from gandes_tpu_torch.des.native import get_lib, native_available

        if not native_available():
            raise RuntimeError("C++ DES engine failed to build")
        get_lib()
        return "C++ DES engine built"

    def c_native_decoder():
        from gandes_tpu_torch.music.native_decode import native_decode_available

        if not native_decode_available():
            raise RuntimeError("C++ MIDI decoder failed to build")
        return "C++ log->MIDI decoder built"

    def c_engine_parity():
        from gandes_tpu_torch.des import Sim

        adj = np.array([[1.0, 1.0], [0.0, -1.0]])
        dists = [["exponential", 1.0], ["exponential", 0.8]]
        logs = []
        with tempfile.TemporaryDirectory() as tmp:
            for engine in ("python", "native"):
                np.random.seed(42)
                sim = Sim(adj, dists, [0, 20], seeds=[7], generate_log=True,
                          log_path=tmp + "/", logging_mode="Music", engine=engine)
                sim.run(number_of_customers=500)
                logs.append("\n".join(sim.music_lines()))
        if logs[0] != logs[1]:
            raise RuntimeError("python vs native event logs differ")
        return "python == native event log (500 customers)"

    def c_mel():
        from gandes_tpu_torch.music.mel import _mel_power_backend
        from gandes_tpu_torch.ops.mel_power import mel_power_cuda, mel_power_reference

        wave = torch.from_numpy(
            (0.3 * np.random.RandomState(0).randn(5 * 44100)).astype(np.float32))
        launches = mel_power_cuda.launches
        out = _mel_power_backend(wave.to(device), 44100, 2048, 1025, 128, 20, 8300,
                                 htk=True, norm_slaney=False)
        ref = mel_power_reference(wave, 44100, hop_length=1025)
        torch.testing.assert_close(out.cpu(), ref, rtol=2e-3, atol=1e-4 * float(ref.max()))
        ran = "K2 (mel_power.cu)" if mel_power_cuda.launches > launches else "plain version"
        return f"{ran} == plain version, (128, {ref.shape[1]}) power mel of a 5 s wave"

    def c_roll():
        from gandes_tpu_torch.music.piano_roll import rasterize_events
        from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda, rasterize_events_reference

        rng = np.random.RandomState(0)
        notes = rng.randint(-1, 128, (8, 4096))
        ons = rng.randint(0, 310, (8, 4096))
        offs = ons + rng.randint(-2, 20, (8, 4096))
        vels = rng.randint(-1, 127, (8, 4096))
        events = [torch.from_numpy(a.astype(np.int32)) for a in (notes, ons, offs, vels)]
        launches = rasterize_cuda.launches
        out = rasterize_events(*(e.to(device) for e in events), num_steps=300, start=0)
        ref = rasterize_events_reference(*events, num_steps=300, start=0)
        if not torch.equal(out.cpu(), ref):
            raise RuntimeError("the rolls differ")
        ran = "K1 (roll_rasterize.cu)" if rasterize_cuda.launches > launches else "plain version"
        return f"{ran} == plain version, bitwise, (8, 4096) events -> (8, 2, 128, 300)"

    def c_sf2():
        from gandes_tpu_torch.music import sf2 as m
        from gandes_tpu_torch.music.midi import Message, MetaMessage, MidiFile, MidiTrack

        with tempfile.TemporaryDirectory() as tmp:
            # one font engaging every generator family the synth honors
            gens = {m.G_SAMPLE_MODES: 1, m.G_HOLD_VOL: 1200, m.G_ATTACK_VOL: -6000,
                    m.G_RELEASE_VOL: -3000, m.G_PAN: 200, m.G_INITIAL_FILTER_FC: 9000,
                    m.G_INITIAL_FILTER_Q: 200, m.G_VIB_LFO_TO_PITCH: 50,
                    m.G_MOD_LFO_TO_VOL: 60, m.G_MOD_ENV_TO_PITCH: 300,
                    m.G_DECAY_MOD_ENV: -2000, m.G_MOD_ENV_TO_FILTER_FC: 1200,
                    m.G_MOD_LFO_TO_FILTER_FC: 600, m.G_REVERB_SEND: 300,
                    m.G_CHORUS_SEND: 300}
            path = m.build_sf2(
                tmp + "/t.sf2",
                samples=[{"name": "s", "data": np.sin(
                    2 * np.pi * np.arange(2000) / 50).astype(np.float32) * 0.5,
                    "sample_rate": 22050, "original_pitch": 60,
                    "loop_start": 200, "loop_end": 1800}],
                instruments=[{"name": "i", "zones": [{"sample": 0, "gens": gens}]}],
                presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}])
            synth = m.Sf2Synth(path, device=device)
            voices = synth.font.select_voices(0, 60, 100)
            if len(voices) != 1 or voices[0]["loop"] != 1:
                raise RuntimeError(f"zone selection returned {voices!r}")
            mid = MidiFile(type=0, ticks_per_beat=480)
            tr = MidiTrack()
            tr.append(MetaMessage("set_tempo", tempo=500000, time=0))
            tr.append(Message("note_on", note=60, velocity=100, time=0))
            tr.append(Message("note_on", note=67, velocity=80, time=96))
            tr.append(Message("note_off", note=60, velocity=0, time=192))
            tr.append(Message("note_off", note=67, velocity=0, time=96))
            tr.append(MetaMessage("end_of_track", time=0))
            mid.tracks.append(tr)
            audio = synth.render_midi(mid, sr=22050, min_seconds=1.0)
            if not np.all(np.isfinite(audio)):
                raise RuntimeError("render produced non-finite samples")
            peak = float(np.abs(audio).max())
            if not 1e-5 < peak <= 1.0 + 1e-6:
                raise RuntimeError(f"render peak {peak} out of range")
        return f"SoundFont parse + zone selection + full-matrix render on {device}"

    def c_reference():
        root = os.environ.get("GANDES_REFERENCE")
        if not root:
            return "GANDES_REFERENCE unset (the reference checkout's location)"
        if os.path.exists(os.path.join(root, "SIMULATOR", "simulation_v3.py")):
            return f"mounted at {root}"
        return f"not mounted at {root}"

    check("torch backend", c_torch)
    check("matmul", c_matmul)
    check("native DES engine", c_native_engine)
    check("native MIDI decoder", c_native_decoder)
    check("engine parity", c_engine_parity)
    check("mel front-end (K2)", c_mel)
    check("roll rasterizer (K1)", c_roll)
    check("soundfont synth", c_sf2)
    check("reference mount", c_reference)
    return rows


def _cmd_doctor(args):
    """Environment self-check on ``--device``: the torch backend, a matmul,
    the native builds, engine parity, both kernels against their plain
    versions, the SF2 render. A failed row fails the command."""
    import torch

    device = torch.device(args.device)
    if args.fluidsynth_ab:
        # ground-truth A/B vs a real FluidSynth binary: render the same MIDI
        # both ways, report mel-distance/onset/gain
        import json

        from gandes_tpu_torch.eval.fluidsynth_ab import find_fluidsynth, fluidsynth_ab

        if not find_fluidsynth():
            raise SystemExit("no fluidsynth binary on PATH (or $GANDES_FLUIDSYNTH) — run this "
                             "where FluidSynth is installed")
        report = fluidsynth_ab(args.fluidsynth_ab, midi_path=args.ab_midi, device=device)
        print(json.dumps(report, indent=1))
        if not report["ok"]:
            raise SystemExit("A/B FAILED: renders diverge beyond thresholds")
        print("A/B ok: renders agree within thresholds")
        return

    rows = _doctor_rows(device)
    width = max(len(r[0]) for r in rows)
    failed = 0
    for name, ok, dt, detail in rows:
        failed += not ok
        print(f"{name:<{width}}  {'ok' if ok else 'FAIL':<4}  {dt:6.1f}s  {detail}")
    if failed:
        raise SystemExit(f"{failed} check(s) failed")
    print("all checks passed")


def _cmd_render_graph(args):
    import torch

    from gandes_tpu_torch.eval.visualize import render_computation_graph

    os.makedirs(args.out_dir, exist_ok=True)
    outs = []

    def render(model, name, title, *example):
        outs.append(render_computation_graph(model.eval(), *example,
                                             save_path=os.path.join(args.out_dir, name),
                                             title=title))

    if args.model == "mmgan":
        from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, build_mmgan

        model = build_mmgan(MMGANConfig())
        z = torch.zeros(args.batch, 50)
        render(model.generator1, "graph_generator.png", "MM-GAN G1 (adjacency generator)", z, z)
        render(model.generator2, "graph_beat_generator.png",
               "MM-GAN G2 (sim-parameter generator)", z, z)
        render(model.discriminator, "graph_discriminator.png", "MM-GAN DiscriminatorCNN",
               torch.zeros(args.batch, 2, 128, 50))
    else:
        from gandes_tpu_torch.train.gandes_loop import GanDesConfig, build_gandes

        gen, disc = build_gandes(GanDesConfig())
        render(gen, "graph_generator.png", "GAN-DES DCGANGenerator", torch.zeros(args.batch, 100))
        render(disc, "graph_discriminator.png", "GAN-DES MelDiscriminator",
               torch.zeros(args.batch, 128, 216))
    print("\n".join(outs))


def _strip_torch_suffix(name: str):
    for suf in (".pth", ".pt"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def _mmgan_epoch_key(name: str):
    """mmgan_{a}_{b}_epoch_{e}[.pth] -> e (skips *_surrogate companions)."""
    parts = _strip_torch_suffix(name).rsplit("_epoch_", 1)
    return int(parts[1]) if len(parts) == 2 and parts[1].isdigit() else None


def _gandes_step_key(name: str):
    """gen_{step}_{timestamp}[.pt] -> step (skips *_surrogate companions)."""
    m = re.fullmatch(r"gen_(\d+)_[\d.]+", _strip_torch_suffix(name))
    return int(m.group(1)) if m else None


def _sweep_checkpoints(args, out, gaps_for, key_of, gap_keys):
    """Checkpoint selection: evaluate every checkpoint of a training run under
    ``--checkpoints-dir`` with the same noise, seed and data, rank them by
    ``--rank-by`` (a gap key, or 'avg_rank': the mean of the per-metric
    ranks) and report the best. For MM-GAN the key is the epoch, for GAN-DES
    the saved step. This package's checkpoint directories and the
    reference's torch files both sweep (``mmgan_{a}_{b}_epoch_{e}[.pth]`` /
    ``gen_{step}_{ts}[.pt]``); ``_surrogate`` companions are skipped."""
    rank_by = args.rank_by  # checked before the sweep: a typo must not cost one
    if rank_by != "avg_rank" and rank_by not in gap_keys:
        raise SystemExit(f"--rank-by must be 'avg_rank' or one of {sorted(gap_keys)}")
    epochs = {}
    for name in sorted(os.listdir(args.checkpoints_dir)):
        key = key_of(name)
        if key is not None:
            epochs[key] = os.path.join(args.checkpoints_dir, name)
    if not epochs:
        raise SystemExit(f"no checkpoints found in {args.checkpoints_dir}")
    per_epoch = {}
    for e in sorted(epochs):
        _, gaps, failed = gaps_for(epochs[e])
        per_epoch[e] = dict(gaps, failed_sims=failed)
    keys = [k for k in next(iter(per_epoch.values())) if k != "failed_sims"]
    ranks = {e: 0.0 for e in per_epoch}
    for k in keys:
        for r, e in enumerate(sorted(per_epoch, key=lambda e: per_epoch[e][k])):
            ranks[e] += r / max(1, len(per_epoch) - 1)
    for e in per_epoch:
        per_epoch[e]["avg_rank"] = ranks[e] / len(keys)
    best = min(per_epoch, key=lambda e: per_epoch[e][rank_by])
    out["per_epoch"] = {str(e): per_epoch[e] for e in sorted(per_epoch)}
    out["rank_by"] = rank_by
    out["best_epoch"] = best
    out["best_checkpoint"] = epochs[best]


def _means(metrics: dict) -> dict:
    return {k: float(v.mean()) for k, v in metrics.items() if k != "pitch_classes"}


def _eval_metrics_mmgan(args) -> tuple:
    """Real: ``--n`` windows of the pickle, evenly spaced across it (windows
    are grouped by source MIDI); generated: each checkpoint's eval-mode G1
    and G2 on the same windows' beats, decoded through the DES with every
    roll forced. Gaps over ``roll_metrics`` and the pitch-class histogram."""
    import torch

    from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi
    from gandes_tpu_torch.data.datasets import MaestroDatasetPickle
    from gandes_tpu_torch.eval.metrics import (
        compare_distributions,
        pitch_class_histogram,
        roll_metrics,
    )
    from gandes_tpu_torch.train.loading import load_mmgan_state
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, eval_forward

    ds = MaestroDatasetPickle(args.data, data_dir=".")
    take = min(args.n, len(ds))
    # floor(i * len / take) strictly increases: exactly `take` distinct windows
    pick = [(i * len(ds)) // take for i in range(take)]
    real = torch.from_numpy(np.stack([np.stack([ds[i][0], ds[i][1]]) for i in pick])).to(
        args.device)
    rm = dict(roll_metrics(real), pitch_classes=pitch_class_histogram(real))
    beats = np.stack([ds[i][2] for i in pick]).astype(np.float32)

    def gaps_for(torch_checkpoint):
        cfg = MMGANConfig()
        model = load_mmgan_state(cfg, torch_checkpoint, device=args.device)
        noise1, noise2, aux = torch.randn(3, take, cfg.noise_dim,
                                          generator=torch.Generator().manual_seed(args.seed))
        mats, vec = eval_forward(model, noise1, noise2, beats, aux=aux)
        np.random.seed(args.seed)
        rolls, failed = matrix_to_midi(
            mats.cpu().numpy()[:, None], vec.cpu().numpy(), adj_size=cfg.adj_size,
            instrument=cfg.instrument, start=cfg.start, end=cfg.start + cfg.sequence_length,
            force_roll=True, parallel=args.des_parallel)
        fake = torch.from_numpy(np.stack(rolls)).to(args.device)
        fm = dict(roll_metrics(fake), pitch_classes=pitch_class_histogram(fake))
        return _means(fm), compare_distributions(rm, fm), failed

    out = {"real": _means(rm), "n_real": take}
    return out, rm, gaps_for, _mmgan_epoch_key


def _eval_metrics_gandes(args) -> tuple:
    """Real: the MIDI directory's renders, ``--n`` 5 s mel slices round-robin
    across its files (D's actual input distribution, K2 once per slice on
    the card); generated: each checkpoint's eval-mode DCGAN through
    ``matrix_to_wav`` (K2 once per clip). Gaps over ``mel_metrics``."""
    import torch

    from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
    from gandes_tpu_torch.data.datasets import collect_real_mels
    from gandes_tpu_torch.eval.metrics import compare_distributions, mel_metrics
    from gandes_tpu_torch.train.gandes_loop import GanDesConfig
    from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

    try:
        real, n_files = collect_real_mels(args.data, args.n, sound_font=args.sound_font,
                                          seed=args.seed, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    print(f"eval-metrics: real side = {real.shape[0]} mel slices from {n_files} file(s)",
          file=sys.stderr)
    rm = mel_metrics(real)

    def gaps_for(torch_checkpoint):
        cfg = GanDesConfig()
        gen, _ = load_gandes_state(cfg, torch_checkpoint, device=args.device)
        noise = torch.randn(args.n, cfg.z_dim, generator=torch.Generator().manual_seed(args.seed))
        mats = gandes_eval_forward(gen)(noise.to(args.device))
        np.random.seed(args.seed)
        os.makedirs("logs", exist_ok=True)
        specs = matrix_to_wav(mats.cpu().numpy(), size=20, start=0, end=real.shape[-1],
                              write_wav=False, parallel=args.des_parallel,
                              sound_font=args.sound_font, device=args.device)
        fm = mel_metrics(specs)
        return _means(fm), compare_distributions(rm, fm), 0

    out = {"real": _means(rm), "n_real": int(real.shape[0]), "family": "gandes"}
    return out, rm, gaps_for, _gandes_step_key


def _cmd_eval_metrics(args):
    """Music-quality statistics of the dataset and of generated samples:
    with ``--torch-checkpoint``, one checkpoint's ``generated`` means and
    ``gaps``; with ``--checkpoints-dir``, every checkpoint's gaps and the
    best one by ``--rank-by``."""
    import json

    from gandes_tpu_torch.eval.metrics import compare_distributions

    _reject_orbax(args, args.family)
    family = _eval_metrics_gandes if args.family == "gandes" else _eval_metrics_mmgan
    out, rm, gaps_for, key_of = family(args)
    if args.checkpoints_dir:
        _sweep_checkpoints(args, out, gaps_for, key_of,
                           gap_keys=set(compare_distributions(rm, rm)))
    elif args.torch_checkpoint:
        out["generated"], out["gaps"], out["failed_sims"] = gaps_for(args.torch_checkpoint)
    print(json.dumps(out, indent=2, sort_keys=True))


def _cmd_serve(args):
    from gandes_tpu_torch.serve import run_server

    _reject_orbax(args, "gandes" if args.model == "gandes" else "mmgan")
    run_server(model=args.model, torch_checkpoint=args.torch_checkpoint, host=args.host,
               port=args.port, warmup=not args.no_warmup, start=args.start,
               sequence_length=args.sequence_length, sound_font=args.sound_font,
               device=args.device)


def _cmd_sim_to_wav(args):
    from gandes_tpu_torch.bridge.sim_demo import sim_to_wav

    np.random.seed(args.seed)
    outs = sim_to_wav(matrices=[None], size=args.size, use_same_instrument=args.instrument,
                      out_dir=args.out_dir, sound_font=args.sound_font or "FluidR3_GM.sf2",
                      device=args.device)
    print("\n".join(outs))


def _cmd_bench(args):
    from gandes_tpu_torch import bench

    bench.main((["--all"] if args.all else []) + ["--device", args.device])


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
                    help="'none' = reference semantics (G gets zero gradient); "
                         "'direct'/'surrogate' = straight-through G training; 'reinforce' = "
                         "score-function estimator through the real DES (unbiased, no "
                         "surrogate)")
    sp.add_argument("--np-seed", type=int, default=None,
                    help="seed the global numpy stream (DES routing) at process start")
    sp.add_argument("--instance-noise", type=float, default=0.0,
                    help="g_update='surrogate' balance knob: N(0, sigma^2) added to every D "
                         "input, annealed to the floor (roll units)")
    sp.add_argument("--instance-noise-anneal", type=float, default=None,
                    help="epochs over which instance noise anneals (default: the full run)")
    sp.add_argument("--r1-gamma", type=float, default=0.0,
                    help="g_update='surrogate' balance knob: R1 gradient penalty weight on the "
                         "real batch")
    sp.add_argument("--moment-match", type=float, default=0.0,
                    help="g_update='surrogate' location anchor: per-pitch mean-profile MSE "
                         "weight")
    sp.add_argument("--moment-match-cond", type=float, default=0.0,
                    help="g_update='surrogate' anchor on the eval's conditional moments "
                         "(velocity mean/std | onset, duration mean | sounding)")
    sp.add_argument("--r1-mode", choices=["exact", "fd"], default="exact",
                    help="R1 formulation: 'exact' (a double backward through D) or 'fd' (a "
                         "finite difference along one probe, two more D forwards)")
    sp.add_argument("--r1-fd-eps", type=float, default=0.5,
                    help="finite-difference step for --r1-mode fd (roll units)")
    sp.add_argument("--instance-noise-floor", type=float, default=0.0,
                    help="anneal instance noise to this sigma instead of 0 (permanent D noise "
                         "floor)")
    sp.add_argument("--profile", action="store_true",
                    help="print a per-phase StepTimer table every print_interval batches")
    # the JAX command's flag for multi-GPU training, not ported yet: given,
    # it raises NotImplementedError naming its ROADMAP.md Queue 1 item
    sp.add_argument("--mesh", default=None, help="not ported yet: raises")
    sp.add_argument("--des-parallel", type=int, default=None,
                    help="run the batch's DES sims on N threads (fast mode)")
    sp.add_argument("--fused-io", action="store_true",
                    help="one call per batch: G forward + host DES + train step (on CUDA two "
                         "graph replays around the host stage)")
    sp.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace here (a Chrome trace, *.pt.trace.json)")
    sp.add_argument("--compute-dtype", choices=["float32", "bf16"], default="float32",
                    dest="compute_dtype",
                    help="bf16: dense math in bfloat16 (tensor cores), params/optimizer/BN "
                         "stats stay float32; default keeps the reference's float32 numerics")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_train_mmgan)

    sp = sub.add_parser("train-gandes", help="train the GAN-DES spectrogram GAN")
    sp.add_argument("--midi-root", required=True)
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path: real and fake sides render by sample playback from "
                         "this soundfont (default: additive synth)")
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
    # the JAX command's flag for multi-GPU training, not ported yet: given,
    # it raises NotImplementedError naming its ROADMAP.md Queue 1 item
    sp.add_argument("--mesh", default=None, help="not ported yet: raises")
    sp.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace here (a Chrome trace, *.pt.trace.json)")
    sp.add_argument("--compute-dtype", choices=["float32", "bf16"], default="float32",
                    dest="compute_dtype",
                    help="bf16: dense math in bfloat16 (tensor cores), params/optimizer/BN "
                         "stats stay float32")
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

    sp = sub.add_parser("generate-gandes", help="GAN-DES: generate songs from a checkpoint")
    sp.add_argument("--checkpoint", default=None,
                    help="orbax checkpoint dir: rejected, see export-torch")
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path: render by sample playback from this soundfont (default: "
                         "additive synth)")
    sp.add_argument("--torch-checkpoint", default=None,
                    help="a reference gen_<step>_<ts>.pt state_dict or a train-gandes "
                         "checkpoint directory")
    sp.add_argument("--n", type=int, default=1)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out-dir", default="adj_sim_outputs")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_generate_gandes)

    sp = sub.add_parser("render-graph", help="render model computation graphs (aten-level "
                                             "fx graph PNG + text, the torchviz-dump analog)")
    sp.add_argument("--model", choices=["mmgan", "gandes"], default="mmgan")
    sp.add_argument("--batch", type=int, default=4)
    sp.add_argument("--out-dir", default="graphs")
    sp.set_defaults(fn=_cmd_render_graph)

    sp = sub.add_parser("doctor", help="environment self-check (device, native builds, "
                                       "engine parity, kernels)")
    sp.add_argument("--fluidsynth-ab", metavar="SF2", default=None,
                    help="A/B our SF2 renderer against a real fluidsynth binary with this font "
                         "(skips the other checks)")
    sp.add_argument("--ab-midi", default=None,
                    help="MIDI file for --fluidsynth-ab (default: built-in register-spanning "
                         "test piece)")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_doctor)

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
                    help=".sf2 path: WAV payloads render by sample playback")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_serve)

    sp = sub.add_parser("sim-to-wav", help="random queueing network -> WAV demo")
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path: render by sample playback from this soundfont (default: "
                         "FluidR3_GM.sf2 if present, else the additive synth)")
    sp.add_argument("--size", type=int, default=32)
    sp.add_argument("--instrument", type=int, default=None)
    sp.add_argument("--out-dir", default="adj_sim_outputs")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_sim_to_wav)

    sp = sub.add_parser("eval-metrics", help="music-quality statistics: dataset vs generated")
    sp.add_argument("--data", required=True,
                    help="windowed roll pickle (mmgan) or a MIDI dir (gandes)")
    sp.add_argument("--family", choices=("mmgan", "gandes"), default="mmgan",
                    help="model family: mmgan ranks piano-roll gaps, gandes ranks mel-spectral "
                         "gaps")
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path for the gandes audio path (real and generated sides)")
    sp.add_argument("--checkpoint", default=None,
                    help="orbax checkpoint dir: rejected, see export-torch")
    sp.add_argument("--torch-checkpoint", default=None,
                    help="a reference .pth/.pt state_dict or a train-mmgan / train-gandes "
                         "checkpoint directory")
    sp.add_argument("--checkpoints-dir", default=None,
                    help="evaluate every checkpoint in a training run's models/ dir and rank "
                         "them (mmgan: *_epoch_N, gandes: gen_<step>_<ts>)")
    sp.add_argument("--rank-by", default="avg_rank",
                    help="gap key to select the best epoch by, or 'avg_rank' (default): mean of "
                         "per-metric ranks")
    sp.add_argument("--n", type=int, default=16)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--des-parallel", type=int, default=None)
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_eval_metrics)

    sp = sub.add_parser("bench", help="run the headline benchmark (gandes_tpu_torch/bench.py)")
    sp.add_argument("--all", action="store_true", help="add the perf table's rows")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
