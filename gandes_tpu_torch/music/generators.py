"""Event-log -> MIDI generators.

Three variants, matching the reference pipelines note-for-note:

* ``MidiGeneratorV1`` — GAN-DES variant (`GAN_DES/sim_log_process_music.py:10-143`):
  fixed skip moduli 3/5/7, velocity 60 + id%67, notes stage on 'arrival' and
  emit note_on+note_off pairs on 'departure'. ``generate_midi`` (tempo/key
  preamble) exists but is never invoked by the reference script, so output files carry
  notes + end_of_track only.
* ``MidiGeneratorV0`` — standalone-simulator variant
  (`SIMULATOR/simulation_to_wav.py:107-226`): V1 plus an active
  program_change before each note_on/note_off.
* ``MidiGeneratorV2`` — MM-GAN variant (`MMGAN_MIDI_DES/sim_log_to_midi.py:14-226`):
  gen2-parameterized skip moduli / tempo / velocity base+var / key signature,
  monotonic time clamp, note_on at arrival + note_off at departure,
  ``clean_midi_file`` dedup, and the save-gating that leaves the in-memory
  MidiFile trackless unless ``lines % 100 == 0`` or ``generate=True``
  (reference :268-272 — the all-zero-roll training quirk, preserved).

``process_adjsim_log_*`` entry points keep the reference surfaces (<=5000 lines,
same regex — negative or scientific-notation times never match) and add an
in-memory ``lines=...`` fast path so the DES's buffered log can skip disk.
"""

from __future__ import annotations

import os
import random
import re

import numpy as np

from gandes_tpu_torch.core.profiling import span
from gandes_tpu_torch.music.midi import Message, MetaMessage, MidiFile, MidiTrack
from gandes_tpu_torch.music.piano_roll import generate_piano_roll

MUSIC_LINE_REGEX = (
    r"INFO:root:([0-9]*\.[0-9]+|[0-9]+) - ([0-9]*\.[0-9]+|[0-9]+) - "
    r"([0-9]*\.[0-9]+|[0-9]+) - (arrival|departure)"
)

# the reference evaluates its note_levels default ONCE at module import
# (a frozen global-RNG draw, `sim_log_process_music.py:159`); drawing per
# call would both use different values and perturb the global stream the
# DES routing depends on
_DEFAULT_NOTE_LEVELS = np.random.randint(0, 127, 16)


class LogLineProcessor:
    """Reference regex parser (`sim_log_to_midi.py:228-237`)."""

    def __init__(self, regex_format):
        self.regex_format = regex_format
        self._compiled = re.compile(regex_format)

    def process_line(self, line):
        match = self._compiled.match(line)
        if match:
            return match.group(1), match.group(2), match.group(3), match.group(4)
        return None


def _fold_queue_length(queue_length: int) -> int:
    """Queue-length folding into [0,127] (`sim_log_process_music.py:94-97`)."""
    if 127 <= queue_length < 2 * 127:
        return min(127, max(0, 2 * 127 - queue_length))
    if queue_length >= 2 * 127:
        return min(127, max(0, queue_length % 127))
    return queue_length


class _MidiGeneratorBase:
    def __init__(self, n, baseline, range_, instruments, note_levels):
        self.n = n
        self.baseline = baseline
        self.range = range_
        self.track = MidiTrack()
        self.mid = MidiFile()

        self.note_offsets = {}
        if note_levels is not None and len(note_levels) > 0:
            for i, note_level in enumerate(note_levels):
                self.note_offsets[str(i)] = int(note_level)
        else:
            for i in range(0, 32):
                self.note_offsets[str(i)] = random.randint(self.baseline - self.range, self.baseline + self.range)

        self.queue_lengths = {}

        self.instruments = {}
        if instruments is not None and len(instruments) > 0:
            for i, instrument in enumerate(instruments):
                self.instruments[str(i)] = int(instrument)
        else:
            for i in range(0, 32):
                self.instruments[str(i)] = random.randint(0, 100)

        self.future_events = {}


class MidiGeneratorV1(_MidiGeneratorBase):
    """GAN-DES generator; `GAN_DES/sim_log_process_music.py:10-143`."""

    PROGRAM_CHANGE_PER_NOTE = False

    def __init__(self, n, baseline=80, range=30, instruments=(), note_levels=()):
        super().__init__(n, baseline, range, instruments, note_levels)

    def generate_midi(self):
        # present for API parity; the reference script never calls it.
        self.mid.tracks.append(self.track)
        self.track.append(MetaMessage("set_tempo", tempo=1000000, time=0))
        self.track.append(MetaMessage("time_signature", numerator=4, denominator=4, time=0))
        self.track.append(MetaMessage("key_signature", key="C", time=0))
        self.track.append(Message("program_change", program=0, time=0))

    def process_line(self, processed_line):
        array1, array2, array3, array4 = processed_line
        midi_time = max(0, int(float(array1)))

        if array4 == "arrival" and (int(array2) % 3 == 0 or int(array2) % 5 == 0 or int(array2) % 7 == 0):
            self.queue_lengths[array3] = self.queue_lengths.get(array3, 0) + 1
            queue_length = _fold_queue_length(self.queue_lengths[array3])

            max_customer_id = max(1, (30 + queue_length) % 127)
            customer_id = int(array2)
            if max_customer_id <= customer_id < 2 * max_customer_id:
                customer_id = min(max_customer_id, max(0, 2 * max_customer_id - customer_id))
            elif customer_id >= 2 * max_customer_id:
                customer_id = min(max_customer_id, max(0, customer_id % max_customer_id))

            self.future_events[array3] = {
                "time": midi_time,
                "velocity": 60 + (int(customer_id) % 67),
                "service_time": int(queue_length),
            }

        elif array4 == "departure" and (int(array2) % 3 == 0 or int(array2) % 5 == 0 or int(array2) % 7 == 0):
            if array3 in self.future_events:
                fe = self.future_events[array3]
                on_time = max(0, int(fe["time"]))
                off_time = max(0, int(fe["time"] + (midi_time - fe["time"]) + max(0, fe["service_time"])))
                if self.PROGRAM_CHANGE_PER_NOTE:
                    self.track.append(Message("program_change", program=self.instruments[array3], time=on_time))
                self.track.append(
                    Message("note_on", channel=0, note=self.note_offsets[array3], velocity=int(fe["velocity"]), time=on_time)
                )
                if self.PROGRAM_CHANGE_PER_NOTE:
                    self.track.append(Message("program_change", program=self.instruments[array3], time=off_time))
                self.track.append(
                    Message("note_off", channel=0, note=self.note_offsets[array3], velocity=fe["velocity"], time=off_time)
                )
            if array3 in self.queue_lengths:
                self.queue_lengths[array3] -= 1
            else:
                self.queue_lengths[array3] = 0

        elif array4 == "processing" and (int(array2) % 3 == 0 or int(array2) % 5 == 0 or int(array2) % 7 == 0):
            # dead in practice: 'processing' lines never match the regex
            self.future_events[array3]["service_time"] += midi_time

    def save_midi(self, filename="output.mid"):
        self.finalize_in_memory()
        self.mid.save(filename)

    def finalize_in_memory(self):
        """The content side of ``save_midi`` (the track closed and attached)
        without the file write."""
        self.track.append(MetaMessage("end_of_track"))
        self.mid.tracks.append(self.track)


class MidiGeneratorV0(MidiGeneratorV1):
    """Standalone-simulator generator; `SIMULATOR/simulation_to_wav.py:107-226`
    — V1 with program_change emitted around every note pair."""

    PROGRAM_CHANGE_PER_NOTE = True


class MidiGeneratorV2(_MidiGeneratorBase):
    """MM-GAN generator; `MMGAN_MIDI_DES/sim_log_to_midi.py:14-226`."""

    def __init__(self, n, baseline=80, range=30, instruments=None, note_levels=None, gen2_output=None):
        super().__init__(n, baseline, range, instruments, note_levels)

        self.gen2_output = gen2_output
        self.skip_1 = max(2, int(gen2_output[0] * 10))
        self.skip_2 = max(2, int(gen2_output[1] * 10))
        self.skip_3 = max(2, int(gen2_output[2] * 10))
        self.base = int(gen2_output[3] * 90)
        if self.base < 50:
            self.base = 80
        self.tempo = min(int(gen2_output[4] * 1000000), 16777215)
        if self.tempo == 0:
            self.tempo = 500000
        self.var = int(gen2_output[5] * int(126 / 2))
        if self.var == 0:
            self.var = 30
        # quirk: the key signature reuses gen2_output[5] (reference :44-46)
        self.key_signature = ["C", "C#", "D", "E", "F", "F#", "G", "G#m", "A", "A#m", "B"][
            int(gen2_output[5] * 11) % 11
        ]

        self.generate_midi()
        self.previous_time = 0
        self.current_instrument = 0

    def generate_midi(self):
        # preamble appended to the track; the track itself joins the file
        # only in save_midi (the zero-roll gating quirk).
        self.track.append(MetaMessage("set_tempo", tempo=self.tempo, time=0))
        self.track.append(MetaMessage("time_signature", numerator=4, denominator=4, time=0))
        self.track.append(MetaMessage("key_signature", key=self.key_signature, time=0))
        self.track.append(Message("program_change", program=0, time=0))

    def _skip(self, array2):
        v = int(array2)
        return v % self.skip_1 == 0 or v % self.skip_2 == 0 or v % self.skip_3 == 0

    def process_line(self, processed_line):
        array1, array2, array3, array4 = processed_line
        midi_time = max(0, int(float(array1)))

        if midi_time < 200 and len(self.track) < 500:
            # monotonic clamp (reference :115-120: the simulator can emit
            # out-of-order/negative times for some distributions)
            if self.previous_time > midi_time:
                midi_time = self.previous_time

            if array4 == "arrival" and self._skip(array2):
                self.queue_lengths[array3] = self.queue_lengths.get(array3, 0) + 1
                queue_length = _fold_queue_length(self.queue_lengths[array3])

                max_customer_id = self.base + self.var
                customer_id = self.base - self.var + int(array2)
                if customer_id > max_customer_id:
                    customer_id = max_customer_id - (customer_id % max_customer_id)

                self.future_events[array3] = {
                    "time": int(midi_time),
                    "velocity": int(customer_id) % 126,
                    "service_time": int(queue_length),
                }

                on_time = int(max(self.previous_time, int(self.future_events[array3]["time"])))
                self.previous_time = on_time

                if self.current_instrument != self.instruments[array3]:
                    self.current_instrument = self.instruments[array3]
                    self.track.append(Message("program_change", program=self.instruments[array3], time=on_time))
                self.track.append(
                    Message(
                        "note_on",
                        channel=0,
                        note=int(self.note_offsets[array3]),
                        velocity=int(self.future_events[array3]["velocity"]),
                        time=on_time,
                    )
                )

            elif array4 == "departure" and self._skip(array2):
                if array3 in self.future_events:
                    fe = self.future_events[array3]
                    off_time = int(
                        max(self.previous_time, int(fe["time"] + (midi_time - fe["time"]) + max(0, fe["service_time"])))
                    )
                    self.previous_time = off_time
                    if self.current_instrument != self.instruments[array3]:
                        self.current_instrument = self.instruments[array3]
                        self.track.append(Message("program_change", program=self.instruments[array3], time=off_time))
                    self.track.append(
                        Message(
                            "note_off",
                            channel=0,
                            note=int(self.note_offsets[array3]),
                            velocity=int(fe["velocity"]),
                            time=off_time,
                        )
                    )
                if array3 in self.queue_lengths:
                    self.queue_lengths[array3] -= 1
                else:
                    self.queue_lengths[array3] = 0

            elif array4 == "processing" and self._skip(array2):
                self.future_events[array3]["service_time"] += midi_time

    def save_midi(self, filename):
        # exact reference cleanup (:182-199) including the mutate-while-
        # iterating removal pass (list.remove drops the first equal message,
        # and removal shifts iteration — both observable in outputs).
        self.finalize_in_memory()
        self.mid.save(filename)
        print("Successfully saved midi file")

    def finalize_in_memory(self):
        """The content side of ``save_midi`` (cleanup + track attach) without
        the file write — used by the opt-in ``force_roll`` decode mode, which
        needs the roll the reference would only materialize behind its save
        gate (`sim_log_to_midi.py:268-272`)."""
        for msg in self.track:
            if msg.time > 200:
                self.track.remove(msg)

        self.track.append(MetaMessage("end_of_track"))
        self.clean_midi_file()
        self.mid.tracks.append(self.track)

    def clean_midi_file(self):
        """Dedup stuck note_ons / orphan note_offs and drop long-delta
        messages (reference :203-220)."""
        note_on_times = {}
        msgs_to_remove = []
        for j, msg in enumerate(self.track):
            if msg.type == "note_on":
                if msg.note in note_on_times and note_on_times[msg.note] > 0:
                    msgs_to_remove.append(j)
                else:
                    note_on_times[msg.note] = msg.time
            elif msg.type == "note_off":
                if msg.note not in note_on_times or note_on_times[msg.note] == 0:
                    msgs_to_remove.append(j)
                else:
                    note_on_times[msg.note] = 0
            if msg.time > 200 and j not in msgs_to_remove:
                msgs_to_remove.append(j)
        for index in sorted(msgs_to_remove, reverse=True):
            self.track.pop(index)

    def sort_midi_file(self, midi_file):
        for track in midi_file.tracks:
            track.sort(key=lambda msg: msg.time)


# ------------------------------------------------------------- entry points


def _iter_log_lines(lines, log_file):
    if lines is not None:
        yield from lines
        return
    with open(log_file, "r") as f:
        yield from f


def process_adjsim_log_v1(
    n=5000,
    baseline=70,
    range=50,
    instruments=np.arange(0, 16),
    note_levels=None,
    lines=None,
    log_file="./logs/simulation.log",
    out_path="./adj_sim_outputs/midi/output.mid",
    generator_cls=MidiGeneratorV1,
    return_mid=False,
):
    """GAN-DES log->MIDI entry point (`GAN_DES/sim_log_process_music.py:159-185`):
    read <= 5000 lines, stage/emit notes, save, return the file path.
    ``return_mid=True`` additionally returns the in-memory MidiFile (encode
    and re-parse are inverse for these tracks, so rendering from it equals
    rendering from the written file — skipping the re-parse).
    ``out_path=None`` writes no file (the path returned is None)."""
    with span("midi"):
        if note_levels is None:
            note_levels = _DEFAULT_NOTE_LEVELS
        log_processor = LogLineProcessor(MUSIC_LINE_REGEX)
        maxn = 5000
        midi_generator = generator_cls(n=maxn, baseline=baseline, range=range,
                                       instruments=instruments, note_levels=note_levels)
        count = 0
        for line in _iter_log_lines(lines, log_file):
            count += 1
            if count > maxn:
                break
            processed = log_processor.process_line(line)
            if processed:
                midi_generator.process_line(processed)
        if out_path is None:
            midi_generator.finalize_in_memory()
        else:
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            midi_generator.save_midi(filename=out_path)
        if return_mid:
            return out_path, midi_generator.mid
        return out_path


def process_adjsim_log_v0(**kw):
    """Standalone-simulator entry point (`SIMULATOR/simulation_to_wav.py:241-266`)."""
    kw.setdefault("generator_cls", MidiGeneratorV0)
    kw.setdefault("log_file", "logs/simulation.log")
    kw.setdefault("out_path", "adj_sim_outputs/midi/output.mid")
    return process_adjsim_log_v1(**kw)


def process_adjsim_log_v2(
    n=5000,
    baseline=70,
    range=50,
    instruments=np.arange(0, 16),
    note_levels=None,
    gen2_output=None,
    count=0,
    start=0,
    end=30,
    generate=False,
    lines=None,
    log_file="./logs/simulation.log",
    out_dir="./adj_sim_outputs/midi",
    verbose=True,
    force_roll=False,
):
    """MM-GAN log->MIDI->piano-roll entry point (`MMGAN_MIDI_DES/sim_log_to_midi.py:241-277`).

    Returns ``(piano_roll, durations, beats)``. Save gating preserved: the
    MIDI (and therefore a non-empty roll) only materializes when the line
    count is a multiple of 100 or ``generate=True``. ``force_roll=True``
    (opt-in, off the reference surface) materializes the roll in memory even
    when the gate doesn't fire — same track cleanup, no file written — for
    training modes that need non-trivial fake rolls (surrogate G updates).
    """
    with span("midi"):
        if note_levels is None:
            note_levels = _DEFAULT_NOTE_LEVELS
        log_processor = LogLineProcessor(MUSIC_LINE_REGEX)
        count = 0
        maxn = 5000
        midi_generator = MidiGeneratorV2(
            n=maxn, baseline=baseline, range=range, instruments=instruments,
            note_levels=note_levels, gen2_output=gen2_output,
        )
        try:
            for line in _iter_log_lines(lines, log_file):
                count += 1
                if count > maxn:
                    break
                processed = log_processor.process_line(line)
                if processed:
                    midi_generator.process_line(processed)
        except Exception as e:
            raise ValueError("Error in processing log file") from e

        try:
            if count % 100 == 0 and not generate:
                os.makedirs(out_dir, exist_ok=True)
                midi_generator.save_midi(os.path.join(out_dir, "simulation.mid"))
            elif generate:
                os.makedirs(out_dir, exist_ok=True)
                midi_generator.save_midi(os.path.join(out_dir, "generation.mid"))
            elif force_roll:
                midi_generator.finalize_in_memory()
        except Exception as e:
            if verbose:
                print("Error in saving midi file")
            raise ValueError("Error in saving midi file") from e

        return generate_piano_roll(midi_generator.mid, start=start, end=end)
