"""Additive MIDI synthesizer in PyTorch (replaces the reference's FluidSynth).

Port of ``gandes_tpu/music/synth.py``'s additive renderer. Each note event
becomes an oscillator bank (6 harmonics, program-shaped spectral rolloff)
under an ADSR envelope, synthesized over a W-sample local window and
added at its onset sample; the render is then peak-normalised.
This is the framework's instrument model, not a FluidR3 clone.

Sizes: the note window ``W`` and the padded event count ``E`` follow the
data (the JAX package's CPU sizing; its fixed device maxima only avoided
TPU recompiles). The timeline keeps its power-of-two length bucket ``L``:
``as_tensor=True`` callers get the bucketed buffer (zero tail), and the
GAN-DES mel is taken over that buffer.

``sound_font``: an existing ``.sf2`` renders by SF2 sample playback from
that font instead (``music/sf2.py``, the reference's FluidSynth +
FluidR3_GM pipeline), on the same ``device``; None, or the reference's
default font name when that file is absent, means this additive synth, as
in the JAX package; any other missing path raises.

``FluidSynth`` at the bottom is the midi2audio-compatible facade
(``FluidSynth(sound_font, sample_rate).midi_to_audio(mid, wav)``).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from gandes_tpu_torch.core.profiling import span
from gandes_tpu_torch.data.audio import save_wav
from gandes_tpu_torch.music.midi import MidiFile, iter_seconds

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
    parallel scatter-add sums overlapping notes in a varying order).

    On the card, where each of those adds is a kernel launch of its own,
    the windows are synthesized in blocks of up to ``_BATCH_SAMPLES``
    samples and, where the onsets rise in event order, ``_overlap_add``
    makes the same sums in a few passes: the same bits, since elementwise
    math on the card does not depend on a tensor's shape. On the CPU the
    blocks stay EVENT_BLOCK events (its vectorised sin can differ from its
    scalar one, which it uses at a chunk's tail) and the adds stay per
    event, which cost it little."""
    E = notes.shape[0]
    # onset samples and validity on the host: they pick the slices to add
    on_samp = np.round(ons * np.float32(sr)).astype(np.int64)
    valid_np = (np.arange(E) < n_valid) & (vels > 0)
    used = valid_np & (on_samp < L)
    starts = on_samp[used]
    batched = (_batched(device) and E * W <= _BATCH_LIMIT
               and bool(np.all(starts >= 0)) and bool(np.all(np.diff(starts) >= 0)))
    block = max(EVENT_BLOCK, _BATCH_SAMPLES // W) if batched else EVENT_BLOCK

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

    if batched:
        rows = torch.empty((E, W), dtype=torch.float32, device=device)  # event e's window
    else:
        audio = torch.zeros(L + W, dtype=torch.float32, device=device)
    for b0 in range(0, E, block):
        sl = slice(b0, b0 + block)
        events = [e for e in range(b0, min(b0 + block, E)) if used[e]]
        if not events:
            continue
        w, a_, d, v, hw = omega[sl], amps[sl], durs[sl], valid[sl], h_w[sl]
        rel = torch.clamp(1.0 - (dt - d[:, None]) / RELEASE_S, 0.0, 1.0)
        env = att * dec * rel * v[:, None] * a_[:, None]                       # (EB, W)

        phase = w[:, None] * dt                                                # (EB, W)
        sig = torch.zeros_like(phase)
        for k in range(N_HARMONICS):
            sig = sig + hw[:, k : k + 1] * torch.sin((k + 1) * phase)
        if batched:
            torch.mul(env, sig, out=rows[sl])
            continue
        windows = env * sig
        for e in events:
            audio[on_samp[e] : on_samp[e] + W] += windows[e - b0]
    if batched:
        audio = _overlap_add(rows, np.flatnonzero(used), starts, L)
    else:
        audio = audio[:L]
    peak = torch.max(torch.abs(audio))
    return torch.where(peak > 1.0, audio / (peak + 1e-6), audio)


_BATCH_SAMPLES = 1 << 24  # window samples synthesized at once on the card
_BATCH_LIMIT = 1 << 28    # the most window samples (events x W) it holds


def _batched(device) -> bool:
    return torch.device(device).type == "cuda"


def _overlap_add(rows, events, starts, L: int):
    """The timeline of length ``L`` on which window ``rows[events[i]]`` is
    added at sample ``starts[i]``, for onsets ``starts`` that never fall, in
    the order of the per-event adds: the windows that cover a sample are
    then a run of consecutive ``i``, so pass ``j`` adds, to each sample
    still covered, the ``j``-th window of its run. Each sample gets the same
    float adds in the same order as ``audio[start:start + W] += window``
    event by event, and the passes together touch each window's samples
    once."""
    W = rows.shape[1]
    device = rows.device
    audio = torch.zeros(L, dtype=torch.float32, device=device)
    if starts.size == 0:
        return audio
    depth = (np.searchsorted(starts, starts, side="right")
             - np.searchsorted(starts + W, starts, side="right"))  # the most, at an onset
    st = torch.from_numpy(starts).to(device)
    ev = torch.from_numpy(events).to(device)
    s = torch.arange(int(starts[0]), min(L, int(starts[-1]) + W), device=device)
    first = torch.searchsorted(st + W, s, right=True)      # first window that reaches past s
    left = torch.searchsorted(st, s, right=True) - first   # windows that cover s
    flat = rows.view(-1)
    for j in range(int(depth.max())):
        keep = torch.nonzero(left > j).squeeze(1)
        s, first, left = s[keep], first[keep], left[keep]
        i = first + j
        audio[s] += flat[ev[i] * W + (s - st[i])]
    return audio


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def render_midi(midi_input, sr: int = 44100, max_events: int = 1024,
                min_seconds: float = 0.5, tail: float = 0.3,
                pad_to_bucket: bool = False, as_tensor: bool = False,
                sound_font: str | None = None, device="cuda"):
    """Render a MidiFile (or path) to a float32 mono waveform.

    Returns numpy audio cropped to the true length (the whole pow2 bucket
    with ``pad_to_bucket``), or with ``as_tensor`` the bucketed buffer on
    ``device`` and the true sample count. An existing ``sound_font`` renders
    by SF2 sample playback (``max_events`` then bounds the extracted
    events; the font's voices are capped at 2048)."""
    with span("synth"):
        midi = MidiFile(midi_input) if isinstance(midi_input, str) else midi_input
        sound_font = _resolve_sound_font(sound_font)
        if sound_font:
            return _get_sf2_synth(sound_font, device=device).render_midi(
                midi, sr=sr, min_seconds=min_seconds, tail=tail, pad_to_bucket=pad_to_bucket,
                as_tensor=as_tensor, max_events=max_events)
        events = midi_to_event_arrays(midi, max_events)
        return render_events(events, sr=sr, max_events=max_events,
                             min_seconds=min_seconds, tail=tail,
                             pad_to_bucket=pad_to_bucket, as_tensor=as_tensor,
                             sound_font=sound_font, device=device)


def render_events(events, sr: int = 44100, max_events: int = 1024,
                  min_seconds: float = 0.5, tail: float = 0.3,
                  pad_to_bucket: bool = False, as_tensor: bool = False,
                  sound_font: str | None = None, device="cuda"):
    """Render pre-extracted event arrays (the ``midi_to_event_arrays``
    tuple, or the native decoder's identical output) — same soundfont
    dispatch and return conventions as :func:`render_midi`."""
    sound_font = _resolve_sound_font(sound_font)
    if sound_font:
        return _get_sf2_synth(sound_font, device=device).render_events(
            events, sr=sr, min_seconds=min_seconds, tail=tail, pad_to_bucket=pad_to_bucket,
            as_tensor=as_tensor)
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


# the reference's hardcoded soundfont name (sim_to_wav's default,
# `SIMULATOR/simulation_to_wav.py:7`): when THIS name is absent the render
# falls back to the additive synth silently — the reference repo ships
# without the font too. Any other missing path is a user error.
DEFAULT_SOUND_FONT = "FluidR3_GM.sf2"


def _resolve_sound_font(sound_font: str | None) -> str | None:
    """None/"" -> the additive synth; an existing path -> SF2 sample
    playback; a missing path raises (a typo'd --sound-font must not
    silently train, serve or evaluate on the wrong timbre) unless it is the
    reference's default font name, which may be absent."""
    if not sound_font:
        return None
    if os.path.isfile(sound_font):
        return sound_font
    if os.path.basename(sound_font) == DEFAULT_SOUND_FONT:
        return None
    raise FileNotFoundError(
        f"sound font not found: {sound_font!r} (pass None for the additive "
        f"synth; the default name {DEFAULT_SOUND_FONT!r} may be absent)")


_SF2_CACHE: dict = {}
_SF2_LOCK = threading.Lock()


def _get_sf2_synth(sound_font: str, interp: str = "cubic", device="cuda"):
    """Parsed font and device bank, one per (path, interpolation, device):
    every pipeline render of a font goes through here, so the real and fake
    sides of training share one bank and one interpolator. A lock keeps
    concurrent first requests (the threaded server) to one upload."""
    from gandes_tpu_torch.music.sf2 import Sf2Synth

    key = (sound_font, interp, torch.device(device))
    with _SF2_LOCK:
        synth = _SF2_CACHE.get(key)
        if synth is None:
            synth = _SF2_CACHE[key] = Sf2Synth(sound_font, interp=interp, device=device)
    return synth


class FluidSynth:
    """midi2audio-compatible facade (a ``from midi2audio import FluidSynth``
    drop-in). Given an existing ``.sf2`` it renders by sample playback from
    that font (``music/sf2.py``, the reference's FluidR3_GM pipeline,
    `GAN_DES/matrix_sim_process.py:114-125`); without one, the additive
    instrument model above. Renders run on ``device``."""

    def __init__(self, sound_font: str | None = None, sample_rate: int = 44100,
                 device="cuda"):
        self.sample_rate = sample_rate
        self.sound_font = sound_font
        self.device = device
        resolved = _resolve_sound_font(sound_font)
        self._sf2 = _get_sf2_synth(resolved, device=device) if resolved else None

    def midi_to_audio(self, midi_path: str, wav_path: str):
        if self._sf2 is not None:
            audio = self._sf2.render_midi(midi_path, sr=self.sample_rate)
        else:
            audio = render_midi(midi_path, sr=self.sample_rate, device=self.device)
        save_wav(wav_path, audio, self.sample_rate)


def midi_to_audio_fluidsynth(midi_file_path, audio_file_path, sound_font_path=None,
                             device="cuda"):
    """== reference ``midi_to_audio_fluidsynth`` (MMGAN_MIDI_DES/util.py:123-127):
    render at 22 050 Hz through the synth facade."""
    FluidSynth(sound_font_path, sample_rate=22050, device=device).midi_to_audio(
        midi_file_path, audio_file_path)
