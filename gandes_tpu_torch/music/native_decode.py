"""ctypes bindings + build for the native v2 log->roll decoder
(``native/midi_decode.cpp``). Port of ``gandes_tpu/music/native_decode.py``:
the repository's unchanged C++ source is built with g++ at first use into
this package's ``_build/`` directory, keyed by content hash, as
``des/native.py`` builds the DES core.

:func:`decode_records_v2` is a drop-in for the in-memory
``process_adjsim_log_v2`` path when the sim ran on the native DES engine:
it consumes the engine's raw record arrays directly (no string
formatting, no regex) and returns the same ``(roll, durations, beats)``
bit-for-bit. Returns ``None`` whenever the fast path doesn't apply — the
caller then falls back to the Python decoder.

Scalar-parameter derivation (skip moduli, velocity base/var, tempo) stays
in Python with the exact numpy expressions ``MidiGeneratorV2.__init__``
uses, so dtype-dependent rounding (float32 generator outputs vs float64
test vectors) matches the Python decoder for any input dtype.
"""

from __future__ import annotations

import ctypes as C
import os
import threading

import numpy as np

from gandes_tpu_torch.des.native import build_native_lib

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "native", "midi_decode.cpp")

_lib = None
_build_failed = False
_BUILD_LOCK = threading.Lock()


def get_lib():
    """Build+load the decoder library once; safe to call concurrently from
    the parallel bridge's worker threads (lock + unique-tmp atomic build)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None or _build_failed:
            return _lib
        path = build_native_lib(_SRC, "libmidi")
        if path is None:
            _build_failed = True
            return None
        try:
            lib = C.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.midi_decode_v2.restype = C.c_int
        lib.midi_decode_v1.restype = C.c_int
        _lib = lib
    return _lib


def native_decode_available() -> bool:
    return get_lib() is not None


def decode_records_v1(sim, instruments, note_levels, out_path,
                      program_change_per_note=False, max_events=1024):
    """Native v1/v0 decode: the engine's raw records -> the ``output.mid``
    SMF bytes (byte-identical to ``process_adjsim_log_v1``'s file, which is
    written to ``out_path`` unless it is None) plus the synth event arrays
    (bit-identical to ``midi_to_event_arrays`` over that file). Returns
    ``(out_path, events_tuple)`` or ``None`` when ineligible."""
    lib = get_lib()
    if lib is None:
        return None
    pend = getattr(sim, "_pending_records", None)
    if pend is None or getattr(sim, "_pending_offset", 0) != 0:
        return None

    values, ids, servers, kinds = pend
    n_nodes = len(note_levels)
    if len(instruments) != n_nodes:
        return None
    if len(servers) and int(servers.max()) >= n_nodes:
        return None
    instruments_i = np.asarray([int(x) for x in instruments], np.int64)
    note_levels_i = np.asarray([int(x) for x in note_levels], np.int64)
    if len(note_levels_i) and (note_levels_i.min() < 0 or note_levels_i.max() > 127):
        return None
    if len(instruments_i) and (abs(instruments_i).max() >= 2**31):
        return None

    values = np.ascontiguousarray(values, np.float64)
    ids = np.ascontiguousarray(ids, np.int64)
    servers = np.ascontiguousarray(servers, np.int32)
    kinds = np.ascontiguousarray(kinds, np.uint8)

    smf_cap = 1 << 18
    smf = np.zeros(smf_cap, np.uint8)
    smf_len = C.c_int64(0)
    ev_notes = np.zeros(max_events, np.int32)
    ev_vels = np.zeros(max_events, np.float32)
    ev_ons = np.zeros(max_events, np.float32)
    ev_offs = np.zeros(max_events, np.float32)
    ev_progs = np.zeros(max_events, np.int32)
    ev_n = C.c_int64(0)
    ev_end = C.c_double(0.0)
    ptr = lambda a: a.ctypes.data_as(C.c_void_p)

    rc = lib.midi_decode_v1(
        ptr(values), ptr(ids), ptr(servers), ptr(kinds),
        C.c_int64(len(values)), C.c_int64(len(sim.log.lines)),
        ptr(instruments_i), ptr(note_levels_i), C.c_int32(n_nodes),
        C.c_int32(1 if program_change_per_note else 0), C.c_int32(max_events),
        ptr(smf), C.c_int64(smf_cap), C.byref(smf_len),
        ptr(ev_notes), ptr(ev_vels), ptr(ev_ons), ptr(ev_offs),
        ptr(ev_progs), C.byref(ev_n), C.byref(ev_end),
    )
    if rc != 0:
        return None

    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "wb") as f:
            f.write(smf[: smf_len.value].tobytes())
    events = (ev_notes, ev_vels, ev_ons, ev_offs, ev_progs,
              int(ev_n.value), float(ev_end.value))
    return out_path, events


def decode_records_v2(sim, instruments, note_levels, gen2_output,
                      start, end, beats_length=50):
    """Decode a native-engine sim's pending records to a piano roll.

    Mirrors ``process_adjsim_log_v2(...) -> generate_piano_roll`` for the
    in-memory (no MIDI artifact) path. Returns ``(roll, durations, beats)``
    or ``None`` when ineligible (no native lib, sim not run natively, or
    out-of-range node ids that the Python path would KeyError on).
    """
    lib = get_lib()
    if lib is None:
        return None
    pend = getattr(sim, "_pending_records", None)
    if pend is None or getattr(sim, "_pending_offset", 0) != 0:
        return None

    values, ids, servers, kinds = pend
    n_nodes = len(note_levels)
    if len(instruments) != n_nodes:
        return None
    if len(servers) and int(servers.max()) >= n_nodes:
        # the Python decoder would KeyError -> ValueError; keep that path
        return None

    # exact MidiGeneratorV2.__init__ scalar math (sim_log_to_midi.py:23-46),
    # evaluated on the caller's dtype
    g = gen2_output
    skip1 = max(2, int(g[0] * 10))
    skip2 = max(2, int(g[1] * 10))
    skip3 = max(2, int(g[2] * 10))
    base = int(g[3] * 90)
    if base < 50:
        base = 80
    tempo = min(int(g[4] * 1000000), 16777215)
    if tempo == 0:
        tempo = 500000
    var = int(g[5] * int(126 / 2))
    if var == 0:
        var = 30
    if base + var <= 0:
        # python raises ZeroDivisionError/uses signed % here; out of the
        # decoder's domain — fall back
        return None

    instruments_i = np.asarray([int(x) for x in instruments], np.int64)
    note_levels_i = np.asarray([int(x) for x in note_levels], np.int64)
    # out-of-range notes make the Python rasterizer IndexError into a
    # partial roll, and huge instruments overflow int32 — keep both on the
    # Python path rather than replicating those failure modes in C++
    if len(note_levels_i) and (note_levels_i.min() < 0 or note_levels_i.max() > 127):
        return None
    if len(instruments_i) and (abs(instruments_i).max() >= 2**31):
        return None

    start = int(start)
    end = int(end)
    W = end - start
    roll = np.zeros((128, W), np.float64)
    durations = np.zeros((128, W), np.float64)

    values = np.ascontiguousarray(values, np.float64)
    ids = np.ascontiguousarray(ids, np.int64)
    servers = np.ascontiguousarray(servers, np.int32)
    kinds = np.ascontiguousarray(kinds, np.uint8)
    ptr = lambda a: a.ctypes.data_as(C.c_void_p)

    rc = lib.midi_decode_v2(
        ptr(values), ptr(ids), ptr(servers), ptr(kinds),
        C.c_int64(len(values)), C.c_int64(len(sim.log.lines)),
        ptr(instruments_i), ptr(note_levels_i), C.c_int32(n_nodes),
        C.c_int64(skip1), C.c_int64(skip2), C.c_int64(skip3),
        C.c_int64(base), C.c_int64(tempo), C.c_int64(var),
        C.c_int32(start), C.c_int32(end), C.c_int32(100),  # seq_len default
        ptr(roll), ptr(durations),
    )
    if rc != 0:
        return None

    # generate_piano_roll's crop quirk: `end` is compared against the PITCH
    # axis (128), so end >= 128 keeps the whole width (datasets.py:49-54)
    if end < 128:
        roll = roll[:, start:end]
        durations = durations[:, start:end]
    else:
        roll = roll[:, :end]
        durations = durations[:, :end]

    beats = np.zeros(beats_length)  # in-memory MidiFile -> empty beat grid
    return roll, durations, beats
