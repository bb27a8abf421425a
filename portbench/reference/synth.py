"""Frozen copy of the port's additive MIDI synthesizer (the GAN-DES cells
render without a sound font), for the benchmark's plain reference.

The JAX package's synthesizer runs in ``jax.numpy``, which the reference may
not load, so this copy is taken from the port itself: the exact WAV
comparison holds the port's synth to this snapshot of it, and catches a
later change of its output, not a fault that the snapshot already has."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.midi import MidiFile, iter_seconds

N_HARMONICS = 6
ATTACK_S = 0.005
RELEASE_S = 0.05
SUSTAIN = 0.75
DECAY_S = 0.08
MAX_NOTE_S = 2.0     # rendered note tail cap (envelope ~silent past this)
EVENT_BLOCK = 32     # events synthesized per block
# Timeline cap: the SMF/mido quirk treats the generators' ABSOLUTE note
# times as deltas, so a decoded timeline's length grows with the cumsum of
# event times — pathological logs imply hours of (almost entirely silent)
# audio. Events past the cap are dropped.
RENDER_MAX_S = 190.0  # largest bucket at 44.1 kHz: 2^23 samples


def midi_to_event_arrays(midi: MidiFile, max_events: int):
    """Absolute-seconds note events (note, vel, on, off, program) padded to
    max_events; unmatched note_ons are held 0.25 s."""
    notes, vels, ons, offs, progs = [], [], [], [], []
    open_ev: dict[tuple, int] = {}
    program = 0
    t = 0.0
    for msg, delta in iter_seconds(midi):
        t += delta
        if msg.type == "program_change":
            program = msg.program
        elif msg.type == "note_on" and msg.velocity > 0:
            open_ev[(msg.channel, msg.note)] = len(notes)
            notes.append(msg.note)
            vels.append(msg.velocity)
            ons.append(t)
            offs.append(-1.0)
            progs.append(program)
        elif msg.type in ("note_off", "note_on"):
            k = (msg.channel, msg.note)
            if k in open_ev:
                offs[open_ev.pop(k)] = t
    n = len(notes)
    arr = lambda x, d: np.asarray((x + [d] * (max_events - n))[:max_events])
    offs = [o if o >= 0 else ons[i] + 0.25 for i, o in enumerate(offs)]
    return (
        arr(notes, 0).astype(np.int32),
        arr(vels, 0).astype(np.float32),
        arr(ons, 0.0).astype(np.float32),
        arr(offs, 0.0).astype(np.float32),
        arr(progs, 0).astype(np.int32),
        n,
        (max(offs) if offs else 0.0),
    )


def _exp_f32(x: np.ndarray) -> np.ndarray:
    """float32 exp as the JAX package's CPU backend computes it: Cephes'
    range reduction and polynomial, each step a fused multiply-add (a
    product of two float32 is exact in float64, so a float64 multiply-add
    rounded once to float32 stands in for the fused one)."""
    f32, f64 = np.float32, np.float64

    def fma(a, b, c):
        return (np.asarray(a, f64) * f64(b) + np.asarray(c, f64)).astype(f32)

    x = np.clip(np.asarray(x, f32), f32(-88.3762626647949), f32(88.3762626647950))
    fx = np.floor(fma(x, f32(1.44269504088896341), f32(0.5)))
    x = fma(fx, -f32(0.693359375), x)
    x = fma(fx, f32(2.12194440e-4), x)
    y = np.full_like(x, f32(1.9875691500e-4))
    for p in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
              5.0000001201e-1):
        y = fma(y, x, f32(p))
    y = fma(y, (x * x).astype(f32), x) + f32(1.0)
    return (y * np.ldexp(f32(1.0), fx.astype(np.int32))).astype(f32)


# Angular frequency (rad/s) of each MIDI note, 2*pi * 440 * 2^((n - 69) / 12),
# in float32 with the reference's rounding: XLA on the CPU folds the JAX
# package's ``2*pi * (440 * jnp.exp2((n - 69) / 12)) * (t / sr)`` into
# ``(f32(440 * exp((n - 69) * f32(ln 2 / 12))) * f32(2*pi)) * (t * f32(1/sr))``
# with ``_exp_f32``. The phase reaches ~1e5 rad in float32, so a 1-ulp change
# in either factor moves a sample by ~1e-3 of its amplitude; the table and
# ``_render``'s ``t * (1/sr)`` keep the bits. (A render of at most
# EVENT_BLOCK events is one scan step, which XLA folds differently again:
# 1 ulp apart, as any other implementation of the formula would be.)
_NOTE_OMEGA = (np.float32(440.0) * _exp_f32(
    (np.arange(128, dtype=np.float32) - np.float32(69.0)) * np.float32(np.log(2.0) / 12.0)
)) * np.float32(2.0 * np.pi)


def _program_timbre(programs):
    """Per-event spectral shape from the GM program number: rolloff power
    in [1, 3] and a brightness tilt — cheap, deterministic variety."""
    p = programs.to(torch.float32)
    rolloff = 1.0 + (p % 32.0) / 16.0          # 1..3
    bright = 0.5 + (p % 8.0) / 8.0             # 0.5..1.4
    return rolloff, bright


def _render(notes, vels, ons, offs, progs, n_valid: int, L: int, W: int, sr: int, device):
    """Sparse render of the (E,) numpy event arrays into an (L,) buffer on
    ``device``: each event synthesizes a W-sample window (oscillator bank
    under ADSR), EVENT_BLOCK events at a time, and each window is added at
    its onset sample, event by event in order. That is the order of the
    reference's scatter-add, and a fixed order keeps the float sums, and so
    the WAV bytes, equal from run to run on the CPU and on the card (a
    parallel scatter-add sums overlapping notes in a varying order)."""
    E = notes.shape[0]
    # onset samples and validity on the host: they pick the slices to add
    on_samp = np.round(ons * np.float32(sr)).astype(np.int64)
    valid_np = (np.arange(E) < n_valid) & (vels > 0)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    omega = t(_NOTE_OMEGA)[t(notes).to(torch.int64)]
    vels, ons, offs, valid = t(vels), t(ons), t(offs), t(valid_np)
    amps = (vels / 127.0) ** 1.5 * 0.2
    rolloff, bright = _program_timbre(t(progs))

    h = torch.arange(1, N_HARMONICS + 1, dtype=torch.float32, device=device)  # (H,)
    h_w = bright[:, None] / (h[None, :] ** rolloff[:, None])                    # (E, H)
    h_w = h_w / torch.sum(h_w, dim=1, keepdim=True)

    dt = (torch.arange(W, device=device).to(torch.float32) * (1.0 / sr))[None, :]  # (1, W)
    durs = torch.clamp(offs - ons, max=MAX_NOTE_S)
    att = torch.clamp(dt / ATTACK_S, 0.0, 1.0)
    dec = 1.0 - (1.0 - SUSTAIN) * torch.clamp((dt - ATTACK_S) / DECAY_S, 0.0, 1.0)

    audio = torch.zeros(L + W, dtype=torch.float32, device=device)
    for b0 in range(0, E, EVENT_BLOCK):
        sl = slice(b0, b0 + EVENT_BLOCK)
        events = [e for e in range(b0, min(b0 + EVENT_BLOCK, E))
                  if valid_np[e] and on_samp[e] < L]
        if not events:
            continue
        w, a_, d, v, hw = omega[sl], amps[sl], durs[sl], valid[sl], h_w[sl]
        rel = torch.clamp(1.0 - (dt - d[:, None]) / RELEASE_S, 0.0, 1.0)
        env = att * dec * rel * v[:, None] * a_[:, None]                       # (EB, W)

        phase = w[:, None] * dt                                                # (EB, W)
        sig = torch.zeros_like(phase)
        for k in range(N_HARMONICS):
            sig = sig + hw[:, k : k + 1] * torch.sin((k + 1) * phase)
        windows = env * sig
        for e in events:
            audio[on_samp[e] : on_samp[e] + W] += windows[e - b0]
    audio = audio[:L]
    peak = torch.max(torch.abs(audio))
    return torch.where(peak > 1.0, audio / (peak + 1e-6), audio)


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def render_midi(midi_input, sr: int = 44100, max_events: int = 1024,
                min_seconds: float = 0.5, tail: float = 0.3,
                pad_to_bucket: bool = False, as_tensor: bool = False, device="cuda"):
    """Render a MidiFile (or path) to a float32 mono waveform.

    Returns numpy audio cropped to the true length (the whole pow2 bucket
    with ``pad_to_bucket``), or with ``as_tensor`` the bucketed buffer on
    ``device`` and the true sample count. An existing ``sound_font`` renders
    by SF2 sample playback (``max_events`` then bounds the extracted
    events; the font's voices are capped at 2048)."""
    midi = MidiFile(midi_input) if isinstance(midi_input, str) else midi_input
    events = midi_to_event_arrays(midi, max_events)
    return render_events(events, sr=sr, max_events=max_events,
                         min_seconds=min_seconds, tail=tail,
                         pad_to_bucket=pad_to_bucket, as_tensor=as_tensor, device=device)


def render_events(events, sr: int = 44100, max_events: int = 1024,
                  min_seconds: float = 0.5, tail: float = 0.3,
                  pad_to_bucket: bool = False, as_tensor: bool = False, device="cuda"):
    """Render pre-extracted event arrays (the ``midi_to_event_arrays``
    tuple, or the native decoder's identical output) — same soundfont
    dispatch and return conventions as :func:`render_midi`."""
    notes_l, vels_l, ons_l, offs_l, progs_l, n, end = events
    n = min(n, max_events)
    length_s = min(max(float(end) + tail, min_seconds), RENDER_MAX_S)
    L = _pow2(int(length_s * sr))
    max_dur = min(MAX_NOTE_S, float(np.max(offs_l[:n] - ons_l[:n]))) if n else 0.25
    W = _pow2(int((max_dur + RELEASE_S + ATTACK_S) * sr) + 1)
    E = max(_pow2(n), EVENT_BLOCK)
    audio = _render(notes_l[:E], vels_l[:E], ons_l[:E], offs_l[:E], progs_l[:E], n, L, W, sr,
                    device)
    if as_tensor:
        return audio, int(length_s * sr)
    audio = audio.cpu().numpy()
    return audio if pad_to_bucket else audio[: int(length_s * sr)]
