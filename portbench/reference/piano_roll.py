"""Frozen copy of the JAX package's host piano-roll rasterizer
(``generate_piano_roll``, pure NumPy, which the port shares line for line),
for the benchmark's plain reference."""

from __future__ import annotations

import numpy as np

from portbench.reference.beats import get_beats
from portbench.reference.midi import MidiFile, iter_seconds


def generate_piano_roll(midi_input, sequence_length=100, beats_length=50, start=0, end=50):
    """Host rasterizer; same surface and quirks as the reference
    (`MMGAN_MIDI_DES/datasets.py:13-70`)."""
    if sequence_length is None:
        sequence_length = end + 20
    if isinstance(midi_input, str):
        midi = MidiFile(midi_input)
        beat_source = midi
    elif isinstance(midi_input, MidiFile):
        midi = midi_input
        # reference: PrettyMIDI(midi.filename) — None for in-memory files,
        # which yields an *empty* beat grid (quirk #2 feeding all-zero
        # beats during MM-GAN training).
        beat_source = MidiFile(midi.filename) if midi.filename else None
    else:
        raise ValueError("midi_input must be a file path or a MidiFile object")

    piano_roll = np.zeros((128, end - start))
    durations = np.zeros((128, end - start))
    try:
        my_time = 0.0
        note_on_time = np.zeros(128)
        for msg, delta in iter_seconds(midi):
            my_time += delta
            time_step = int(round(my_time))
            if time_step >= sequence_length:
                break
            if msg.type == "note_on":
                piano_roll[msg.note, time_step] = msg.velocity
                note_on_time[msg.note] = time_step
            elif msg.type == "note_off":
                note_off_time = int(round(note_on_time[msg.note]))
                durations[msg.note, note_off_time:time_step] = time_step - note_off_time
    except Exception:
        print(f"Error in processing midi file {midi_input}")

    if end < len(piano_roll):  # quirk: compares against the PITCH axis (128)
        piano_roll = piano_roll[:, start:end]
        durations = durations[:, start:end]
    else:
        piano_roll = piano_roll[:, :end]
        durations = durations[:, :end]

    beats = get_beats(beat_source)
    if len(beats) < beats_length:
        beats = np.pad(beats, (0, beats_length - len(beats)))
    elif len(beats) > beats_length:
        beats = beats[:beats_length]

    return piano_roll, durations, beats
