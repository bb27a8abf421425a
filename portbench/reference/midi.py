"""Self-contained Standard MIDI File codec.

The reference stack sits on ``mido`` (MidiFile/MidiTrack/Message,
reference `GAN_DES/sim_log_process_music.py`, `MMGAN_MIDI_DES/sim_log_to_midi.py`,
`MMGAN_MIDI_DES/datasets.py:13-70`); that package is not part of this
environment, so this module implements the subset of SMF we need from
scratch, with mido-compatible *semantics* where the reference depends on
them:

* ``MidiFile.save`` interprets ``msg.time`` as **delta ticks**;
* iterating a ``MidiFile`` merges tracks and yields messages whose
  ``time`` is **delta seconds**, applying ``set_tempo`` changes after the
  tempo message is yielded (default tempo 500000, ticks_per_beat 480);
* ``Message.__eq__`` is value equality including ``time`` — the
  reference's ``track.remove(msg)`` cleanup loop depends on this;
* ``note_on`` with velocity 0 is kept as ``note_on`` (not converted to
  ``note_off``) because ``generate_piano_roll`` distinguishes the two.

Reading supports running status, sysex, and unknown meta events (kept
raw), enough to parse MAESTRO-style files and the reference's committed
``.mid`` artifacts.
"""

from __future__ import annotations

import struct

DEFAULT_TEMPO = 500000
DEFAULT_TICKS_PER_BEAT = 480

# channel-voice message specs: type -> (status nibble, field names)
_CHANNEL_SPECS = {
    "note_off": (0x80, ("note", "velocity")),
    "note_on": (0x90, ("note", "velocity")),
    "polytouch": (0xA0, ("note", "value")),
    "control_change": (0xB0, ("control", "value")),
    "program_change": (0xC0, ("program",)),
    "aftertouch": (0xD0, ("value",)),
    "pitchwheel": (0xE0, ("pitch",)),
}
_STATUS_TO_TYPE = {v[0]: k for k, v in _CHANNEL_SPECS.items()}

_FIELD_DEFAULTS = {
    "note": 0,
    "velocity": 64,
    "value": 0,
    "control": 0,
    "program": 0,
    "pitch": 0,
}

# key signature names indexed by (number of sharps (+) / flats (-), minor)
_KEYS_MAJOR = {
    -7: "Cb", -6: "Gb", -5: "Db", -4: "Ab", -3: "Eb", -2: "Bb", -1: "F",
    0: "C", 1: "G", 2: "D", 3: "A", 4: "E", 5: "B", 6: "F#", 7: "C#",
}
_KEYS_MINOR = {
    -7: "Abm", -6: "Ebm", -5: "Bbm", -4: "Fm", -3: "Cm", -2: "Gm", -1: "Dm",
    0: "Am", 1: "Em", 2: "Bm", 3: "F#m", 4: "C#m", 5: "G#m", 6: "D#m", 7: "A#m",
}
_KEY_TO_CODE = {v: (k, 0) for k, v in _KEYS_MAJOR.items()}
_KEY_TO_CODE.update({v: (k, 1) for k, v in _KEYS_MINOR.items()})


class Message:
    """A channel-voice MIDI message (mido-compatible surface)."""

    is_meta = False

    def __init__(self, type, channel=0, time=0, **fields):
        if type not in _CHANNEL_SPECS:
            raise ValueError(f"unknown message type {type!r}")
        self.type = type
        self.channel = channel
        self.time = time
        for name in _CHANNEL_SPECS[type][1]:
            setattr(self, name, fields.pop(name, _FIELD_DEFAULTS[name]))
        if fields:
            raise ValueError(f"unexpected fields for {type}: {sorted(fields)}")

    def _key(self):
        d = dict(self.__dict__)
        return (self.type, tuple(sorted(d.items())))

    def __eq__(self, other):
        return isinstance(other, (Message, MetaMessage)) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def copy(self, **overrides):
        d = dict(self.__dict__)
        d.update(overrides)
        t = d.pop("type")
        return Message(t, **d)

    def __repr__(self):
        fields = " ".join(f"{k}={v}" for k, v in self.__dict__.items() if k != "type")
        return f"Message('{self.type}' {fields})"

    def encode(self) -> bytes:
        status, names = _CHANNEL_SPECS[self.type]
        data = [status | (self.channel & 0x0F)]
        if self.type == "pitchwheel":
            v = self.pitch + 8192
            data += [v & 0x7F, (v >> 7) & 0x7F]
        else:
            data += [int(getattr(self, n)) & 0x7F for n in names]
        return bytes(data)


class MetaMessage:
    """A meta event (tempo, time/key signature, end_of_track, ...)."""

    is_meta = True

    def __init__(self, type, time=0, **fields):
        self.type = type
        self.time = time
        if type == "set_tempo":
            self.tempo = fields.pop("tempo", DEFAULT_TEMPO)
        elif type == "time_signature":
            self.numerator = fields.pop("numerator", 4)
            self.denominator = fields.pop("denominator", 4)
            self.clocks_per_click = fields.pop("clocks_per_click", 24)
            self.notated_32nd_notes_per_beat = fields.pop("notated_32nd_notes_per_beat", 8)
        elif type == "key_signature":
            self.key = fields.pop("key", "C")
        elif type == "end_of_track":
            pass
        elif type == "track_name":
            self.name = fields.pop("name", "")
        elif type == "unknown_meta":
            self.meta_type = fields.pop("meta_type", 0)
            self.data = fields.pop("data", b"")
        else:
            raise ValueError(f"unknown meta type {type!r}")
        if fields:
            raise ValueError(f"unexpected fields for {type}: {sorted(fields)}")

    def _key(self):
        return (self.type, tuple(sorted(self.__dict__.items())))

    def __eq__(self, other):
        return isinstance(other, (Message, MetaMessage)) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def copy(self, **overrides):
        d = dict(self.__dict__)
        d.update(overrides)
        t = d.pop("type")
        return MetaMessage(t, **d)

    def __repr__(self):
        fields = " ".join(f"{k}={v}" for k, v in self.__dict__.items() if k != "type")
        return f"MetaMessage('{self.type}' {fields})"

    def encode(self) -> bytes:
        if self.type == "set_tempo":
            body = struct.pack(">I", int(self.tempo))[1:]
            code = 0x51
        elif self.type == "time_signature":
            denom_pow = max(0, int(self.denominator).bit_length() - 1)
            body = bytes([self.numerator, denom_pow, self.clocks_per_click,
                          self.notated_32nd_notes_per_beat])
            code = 0x58
        elif self.type == "key_signature":
            sf, minor = _KEY_TO_CODE[self.key]
            body = struct.pack(">bB", sf, minor)
            code = 0x59
        elif self.type == "end_of_track":
            body = b""
            code = 0x2F
        elif self.type == "track_name":
            body = self.name.encode("latin1", "replace")
            code = 0x03
        else:
            body = self.data
            code = self.meta_type
        return bytes([0xFF, code]) + _encode_varlen(len(body)) + body


class MidiTrack(list):
    @property
    def name(self):
        for msg in self:
            if getattr(msg, "type", None) == "track_name":
                return msg.name
        return ""

    def copy(self):
        return MidiTrack(self)

    def __getitem__(self, item):
        out = super().__getitem__(item)
        return MidiTrack(out) if isinstance(item, slice) else out


def _encode_varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"variable-length quantity must be >= 0, got {value}")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _decode_varlen(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def tick2second(ticks, ticks_per_beat, tempo):
    return ticks * tempo * 1e-6 / ticks_per_beat


def second2tick(seconds, ticks_per_beat, tempo):
    return int(round(seconds * 1e6 * ticks_per_beat / tempo))


def _to_abstime(track):
    now = 0
    out = []
    for msg in track:
        now += msg.time
        out.append(msg.copy(time=now))
    return out


def _to_reltime(messages):
    now = 0
    out = []
    for msg in messages:
        out.append(msg.copy(time=msg.time - now))
        now = msg.time
    return out


def merge_tracks(tracks):
    """Merge to one track (absolute-time stable sort; single trailing
    end_of_track), matching mido's merge semantics."""
    messages = []
    for track in tracks:
        messages.extend(_to_abstime(track))
    messages.sort(key=lambda msg: msg.time)
    # drop intermediate end_of_track, keep one at the max time
    end_time = max((m.time for m in messages), default=0)
    messages = [m for m in messages if m.type != "end_of_track"]
    messages.append(MetaMessage("end_of_track", time=end_time))
    return MidiTrack(_to_reltime(messages))


def iter_seconds(midi: "MidiFile"):
    """Yield ``(msg, delta_seconds)`` over a MidiFile's merged message
    stream — semantically identical to ``for msg in midi`` (same tempo-map
    application, same tick2second floats) but without the three
    message-copy passes ``merge_tracks`` makes, for the common case of a
    single track with non-negative deltas and no interior end_of_track
    (every file/track the generators produce). Falls back to the full merge
    iteration otherwise. The hot host loops (synth event extraction, roll
    rasterization) are bound by this iteration cost."""
    fast = len(midi.tracks) == 1
    if fast:
        track = midi.tracks[0]
        last = len(track) - 1
        for i, m in enumerate(track):
            if m.time < 0 or (m.type == "end_of_track" and i != last):
                fast = False
                break
    if fast:
        tempo = DEFAULT_TEMPO
        for msg in midi.tracks[0]:
            if msg.time > 0:
                delta = tick2second(msg.time, midi.ticks_per_beat, tempo)
            else:
                delta = 0
            yield msg, delta
            if msg.type == "set_tempo":
                tempo = msg.tempo
    else:
        for msg in midi:
            yield msg, msg.time


class MidiFile:
    """SMF container; ``tracks`` of ``MidiTrack``; iteration yields
    seconds-domain messages (tempo map applied)."""

    def __init__(self, filename=None, type=1, ticks_per_beat=DEFAULT_TICKS_PER_BEAT):
        self.filename = filename
        self.type = type
        self.ticks_per_beat = ticks_per_beat
        self.tracks: list[MidiTrack] = []
        if filename is not None:
            with open(filename, "rb") as f:
                self._load(f.read())

    # ------------------------------------------------------------- writing

    def save(self, filename=None):
        data = self._encode()
        with open(filename or self.filename, "wb") as f:
            f.write(data)

    def _encode(self) -> bytes:
        chunks = [b"MThd", struct.pack(">IHHH", 6, self.type, len(self.tracks), self.ticks_per_beat)]
        for track in self.tracks:
            body = bytearray()
            for msg in track:
                body += _encode_varlen(max(0, int(msg.time)))
                body += msg.encode()
            chunks.append(b"MTrk")
            chunks.append(struct.pack(">I", len(body)))
            chunks.append(bytes(body))
        return b"".join(chunks)

    # ------------------------------------------------------------- reading

    def _load(self, data: bytes):
        if data[:4] != b"MThd":
            raise ValueError("not a MIDI file (missing MThd)")
        hlen, self.type, ntracks, division = struct.unpack(">IHHH", data[4:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        self.ticks_per_beat = division
        pos = 8 + hlen
        self.tracks = []
        for _ in range(ntracks):
            if data[pos:pos + 4] != b"MTrk":
                raise ValueError("bad track chunk")
            length = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            self.tracks.append(self._parse_track(data[pos + 8:pos + 8 + length]))
            pos += 8 + length

    @staticmethod
    def _parse_track(data: bytes) -> MidiTrack:
        track = MidiTrack()
        pos = 0
        running = None
        while pos < len(data):
            delta, pos = _decode_varlen(data, pos)
            status = data[pos]
            if status >= 0x80:
                pos += 1
                if status < 0xF0:
                    running = status
            else:
                if running is None:
                    raise ValueError("data byte with no running status")
                status = running
            if status == 0xFF:
                meta_type = data[pos]
                pos += 1
                length, pos = _decode_varlen(data, pos)
                body = data[pos:pos + length]
                pos += length
                track.append(_decode_meta(meta_type, body, delta))
            elif status in (0xF0, 0xF7):
                length, pos = _decode_varlen(data, pos)
                pos += length  # sysex skipped (kept out of the model)
                track.append(MetaMessage("unknown_meta", meta_type=status, data=b"", time=delta))
            else:
                kind = _STATUS_TO_TYPE[status & 0xF0]
                channel = status & 0x0F
                names = _CHANNEL_SPECS[kind][1]
                if kind == "pitchwheel":
                    lo, hi = data[pos], data[pos + 1]
                    pos += 2
                    msg = Message(kind, channel=channel, pitch=(hi << 7 | lo) - 8192, time=delta)
                else:
                    vals = [data[pos + i] for i in range(len(names))]
                    pos += len(names)
                    msg = Message(kind, channel=channel, time=delta, **dict(zip(names, vals)))
                track.append(msg)
        return track

    # ----------------------------------------------------------- iteration

    def __iter__(self):
        if self.type == 2:
            raise TypeError("can't merge tracks in type 2 (asynchronous) file")
        tempo = DEFAULT_TEMPO
        for msg in merge_tracks(self.tracks):
            if msg.time > 0:
                delta = tick2second(msg.time, self.ticks_per_beat, tempo)
            else:
                delta = 0
            yield msg.copy(time=delta)
            if msg.type == "set_tempo":
                tempo = msg.tempo

    @property
    def length(self) -> float:
        return sum(msg.time for msg in self)


def _decode_meta(meta_type: int, body: bytes, delta: int):
    if meta_type == 0x51 and len(body) == 3:
        return MetaMessage("set_tempo", tempo=(body[0] << 16) | (body[1] << 8) | body[2], time=delta)
    if meta_type == 0x58 and len(body) >= 2:
        return MetaMessage(
            "time_signature",
            numerator=body[0],
            denominator=2 ** body[1],
            clocks_per_click=body[2] if len(body) > 2 else 24,
            notated_32nd_notes_per_beat=body[3] if len(body) > 3 else 8,
            time=delta,
        )
    if meta_type == 0x59 and len(body) == 2:
        sf = struct.unpack(">b", body[:1])[0]
        table = _KEYS_MINOR if body[1] else _KEYS_MAJOR
        return MetaMessage("key_signature", key=table.get(sf, "C"), time=delta)
    if meta_type == 0x2F:
        return MetaMessage("end_of_track", time=delta)
    if meta_type == 0x03:
        return MetaMessage("track_name", name=body.decode("latin1", "replace"), time=delta)
    return MetaMessage("unknown_meta", meta_type=meta_type, data=bytes(body), time=delta)
