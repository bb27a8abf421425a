"""Beat-grid extraction from a MIDI tempo map.

Replaces ``pretty_midi.PrettyMIDI(...).get_beats()`` (not available in this
environment) with the same algorithm: walk the tempo-change list, emitting
one beat every 60/bpm seconds, splitting beats proportionally across tempo
boundaries, stopping at the end time (last beat past the end is dropped).
Used by the piano-roll path (reference `MMGAN_MIDI_DES/datasets.py:57`).

Reference quirk preserved: for in-memory MidiFiles the reference constructs
``PrettyMIDI(mid.filename)`` with ``filename=None``, i.e. an *empty* MIDI —
``get_beats`` then returns an empty array (the MM-GAN fake path trains on
all-zero beat vectors). Callers pass ``None`` to reproduce that.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.midi import MidiFile, iter_seconds


def _tempo_changes_and_end(midi: MidiFile):
    """(times_sec, bpm) arrays (pretty_midi.get_tempo_changes semantics:
    default 120 bpm at t=0 unless a tempo is set there) plus the end time,
    in ONE merge-free pass (this is the pickler's per-file hot loop)."""
    times = [0.0]
    tempi = [120.0]
    elapsed = 0.0
    for msg, delta in iter_seconds(midi):
        elapsed += delta
        if msg.type == "set_tempo":
            bpm = 6e7 / msg.tempo
            if elapsed == 0.0:
                times[0], tempi[0] = 0.0, bpm
            else:
                times.append(elapsed)
                tempi.append(bpm)
    return np.asarray(times), np.asarray(tempi), elapsed


def _tempo_changes(midi: MidiFile):
    times, tempi, _end = _tempo_changes_and_end(midi)
    return times, tempi


def get_end_time(midi: MidiFile) -> float:
    return float(midi.length)


def get_beats(midi: MidiFile | None, start_time: float = 0.0) -> np.ndarray:
    if midi is None:
        return np.array([])
    tempo_change_times, tempi, end_time = _tempo_changes_and_end(midi)
    if end_time <= start_time:
        return np.array([])
    beats = [start_time]
    n = 0
    while n < len(tempo_change_times) - 1 and beats[-1] >= tempo_change_times[n + 1]:
        n += 1
    while beats[-1] < end_time:
        next_beat = beats[-1] + 60.0 / tempi[n]
        if n < len(tempo_change_times) - 1 and next_beat > tempo_change_times[n + 1]:
            next_beat = beats[-1]
            beat_remaining = 1.0
            while (
                n < len(tempo_change_times) - 1
                and next_beat + beat_remaining * 60.0 / tempi[n] >= tempo_change_times[n + 1]
            ):
                overshot_ratio = (tempo_change_times[n + 1] - next_beat) / (60.0 / tempi[n])
                next_beat += overshot_ratio * 60.0 / tempi[n]
                beat_remaining -= overshot_ratio
                n += 1
            next_beat += beat_remaining * 60.0 / tempi[n]
        beats.append(next_beat)
    return np.array(beats[:-1])
