"""SoundFont-2 sample playback in PyTorch.

Port of ``gandes_tpu/music/sf2.py``. The reference renders every WAV
through the FluidSynth binary with the FluidR3_GM soundfont
(`GAN_DES/matrix_sim_process.py:114-125`, `MMGAN_MIDI_DES/util.py:123-127`,
`GAN_DES/datasets.py:70,82`). This module is the sample-playback
equivalent: it parses the SoundFont 2 format (hydra: presets -> zones ->
generators -> instruments -> samples), selects per-note sample zones the
way a SoundFont player does, and renders by playing the font's own samples
on ``device`` -- pitch-shifted bank gathers (4-point cubic by default,
FluidSynth's default interpolation order, or linear) with loop folding
under the SF2 volume envelope, the LFOs and the modulation envelope, the
static or swept low-pass filter, and the reverb and chorus sends.

The host half (generator tables, modulators, the parser, voice resolution
and ``build_sf2``) is a copy of the JAX package's: its parse results and
voice columns are the same values. The render (``_render_sf2``) is torch
ops on an explicit device, in the JAX program's order: EVENT_BLOCK voices
at a time, blocks in order, each voice's window added at its onset sample
in voice order (a fixed order, so a render repeats bitwise on the card as
on the CPU). The scope notes below are the JAX package's.

Scope (documented, deliberate):

* Generators honored: key/vel ranges, sampleID, sampleModes (0/2 one-shot,
  1/3 continuous loop -- 3 is treated as 1, i.e. the loop also runs through
  the short release), overridingRootKey, coarse/fineTune + the sample
  header's pitchCorrection, scaleTuning, initialAttenuation, the sample
  start/end/loop address offsets (fine + coarse), the volume envelope
  (delay/attack/hold/decay/sustain/release, plus keynumToVolEnvHold/
  Decay key scaling), and the low-pass filter (initialFilterFc/
  initialFilterQ -- static per-voice cutoff/resonance, applied as a
  zero-phase 2-pole magnitude response in the frequency domain over the
  enveloped voice, with the spec's half-Q DC-gain drop). Preset-level
  generators add to instrument-level values per spec section 9.4.
* The volume envelope is the spec shape: linear-amplitude attack, hold,
  decay linear-in-dB to the sustain attenuation, release linear-in-dB at
  96 dB per ``release_s``. Velocity maps to gain as the spec's concave
  default modulator, amp = (vel/127)^2. FluidSynth's other defaults at
  initial controller state contribute a constant gain (about -4.2 dB), so
  absolute level differs from FluidSynth by that fixed factor.
* LFOs: vibLfoToPitch / modLfoToPitch warp the playback-position ramp by
  the closed-form integral of the spec's triangle LFO (2^cents linearized;
  depths clamp to +-1200 cents); modLfoToVolume is a triangle tremolo in
  centibels on the envelope; LFO frequencies and delays are honored.
* Mono render: stereo sample pairs are summed; pan (gen 17) folds down as
  the constant-power legs' mono sum, normalized so center pan is unity.
* Effects sends (gens 15/16): each voice mixes into reverb/chorus buses at
  its send fraction. The reverb is the Freeverb room model at FluidSynth's
  default knobs, collapsed (it is LTI) to a host-computed impulse response
  and FFT-convolved; the chorus is a 3-voice sine-modulated delay at
  FluidSynth's default speed/depth/level. CC 91/93 are never sent by the
  pipelines' MIDI, so only the font's own send values count.
* Modulation envelope (gens 25-32) drives the pitch (gen 7) through its
  closed-form integral, and with gens 10/11 the cutoff: fonts that sweep
  the cutoff render through a block-wise time-varying filter (periodic-Hann
  STFT at hop F/2, each frame filtered at its own cutoff), sweepless fonts
  keep the static-filter program.
* Custom modulators (imod/pmod) are evaluated at note-on state and collapse
  to static per-voice offsets on their destination generators (spec 9.5
  layering and supersession; controller sources read their MIDI initial
  values).
* keynum/velocity (gens 46/47) substitute for the MIDI key/velocity after
  zone selection; exclusiveClass (gen 57) chokes still-sounding voices of
  the same class at a new note-on (host-side scheduling).
* 24-bit banks: an sm24 chunk combines with smpl into s24 / 2^23 samples;
  16-bit fonts keep exact s16 / 2^15 values.
* FluidSynth's non-spec quirks (the 0.4x initialAttenuation scaling) are
  not cloned; this plays the font per the SF2 spec.

Static toggles: a font whose selected voices set no filter, LFO, mod-env
pitch, sweep, reverb or chorus generator runs exactly the program without
that feature (a Python branch over the same op sequence), so its render
does not change when the feature's code does.

``build_sf2`` writes a minimal valid soundfont (the tests' fixtures and
``chip_smoke.py``'s GM-scale font).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from gandes_tpu_torch.music.synth import _pow2  # one bucketing rule for both renderers

# ------------------------------------------------------------ generator ids
G_START_OFS = 0
G_END_OFS = 1
G_STARTLOOP_OFS = 2
G_ENDLOOP_OFS = 3
G_START_COARSE = 4
G_END_COARSE = 12
G_STARTLOOP_COARSE = 45
G_ENDLOOP_COARSE = 50
G_DELAY_VOL = 33
G_ATTACK_VOL = 34
G_HOLD_VOL = 35
G_DECAY_VOL = 36
G_SUSTAIN_VOL = 37
G_RELEASE_VOL = 38
G_INITIAL_FILTER_FC = 8
G_INITIAL_FILTER_Q = 9
G_CHORUS_SEND = 15
G_REVERB_SEND = 16
G_MOD_LFO_TO_PITCH = 5
G_VIB_LFO_TO_PITCH = 6
G_MOD_ENV_TO_PITCH = 7
G_MOD_LFO_TO_FILTER_FC = 10
G_MOD_ENV_TO_FILTER_FC = 11
G_MOD_LFO_TO_VOL = 13
G_DELAY_MOD_ENV = 25
G_ATTACK_MOD_ENV = 26
G_HOLD_MOD_ENV = 27
G_DECAY_MOD_ENV = 28
G_SUSTAIN_MOD_ENV = 29
G_RELEASE_MOD_ENV = 30
G_KEYNUM_TO_MOD_ENV_HOLD = 31
G_KEYNUM_TO_MOD_ENV_DECAY = 32
G_PAN = 17
G_DELAY_MOD_LFO = 21
G_FREQ_MOD_LFO = 22
G_DELAY_VIB_LFO = 23
G_FREQ_VIB_LFO = 24
G_KEY_RANGE = 43
G_VEL_RANGE = 44
G_INITIAL_ATT = 48
G_KEYNUM_TO_VOL_HOLD = 39
G_KEYNUM_TO_VOL_DECAY = 40
G_COARSE_TUNE = 51
G_FINE_TUNE = 52
G_SAMPLE_ID = 53
G_SAMPLE_MODES = 54
G_SCALE_TUNING = 56
G_ROOT_KEY = 58
G_INSTRUMENT = 41
G_KEYNUM = 46            # forced MIDI key number (instrument-only, spec 8.1.2)
G_VELOCITY = 47          # forced MIDI velocity (instrument-only)
G_EXCLUSIVE_CLASS = 57   # note-on chokes same-class voices (instrument-only)

_TIMECENT_GENS = (G_DELAY_VOL, G_ATTACK_VOL, G_HOLD_VOL, G_DECAY_VOL,
                  G_RELEASE_VOL, G_DELAY_MOD_LFO, G_DELAY_VIB_LFO,
                  G_DELAY_MOD_ENV, G_ATTACK_MOD_ENV, G_HOLD_MOD_ENV,
                  G_DECAY_MOD_ENV, G_RELEASE_MOD_ENV)
_DEFAULTS = {g: -12000 for g in _TIMECENT_GENS}
_DEFAULTS.update({G_INITIAL_FILTER_FC: 13500, G_INITIAL_FILTER_Q: 0,
                  G_SUSTAIN_VOL: 0, G_INITIAL_ATT: 0, G_COARSE_TUNE: 0,
                  G_FINE_TUNE: 0, G_SCALE_TUNING: 100, G_SAMPLE_MODES: 0,
                  G_ROOT_KEY: -1,
                  G_MOD_LFO_TO_PITCH: 0, G_VIB_LFO_TO_PITCH: 0,
                  G_MOD_LFO_TO_VOL: 0, G_PAN: 0,
                  G_FREQ_MOD_LFO: 0, G_FREQ_VIB_LFO: 0,
                  G_KEYNUM_TO_VOL_HOLD: 0, G_KEYNUM_TO_VOL_DECAY: 0,
                  G_CHORUS_SEND: 0, G_REVERB_SEND: 0,
                  G_MOD_ENV_TO_PITCH: 0, G_SUSTAIN_MOD_ENV: 0,
                  G_KEYNUM_TO_MOD_ENV_HOLD: 0, G_KEYNUM_TO_MOD_ENV_DECAY: 0,
                  G_MOD_LFO_TO_FILTER_FC: 0, G_MOD_ENV_TO_FILTER_FC: 0,
                  G_START_OFS: 0, G_END_OFS: 0, G_STARTLOOP_OFS: 0,
                  G_ENDLOOP_OFS: 0, G_START_COARSE: 0, G_END_COARSE: 0,
                  G_STARTLOOP_COARSE: 0, G_ENDLOOP_COARSE: 0})


def _q_from_peak(peak: float) -> float:
    """Invert the 2-pole low-pass peak gain P = Q / sqrt(1 - 1/(4Q^2)):
    the spec's initialFilterQ is the resonance height ABOVE DC, so P = 1
    (0 cB) must give the maximally flat response — this lands exactly on
    Butterworth Q = 1/sqrt(2), and ~P for strong resonance."""
    p2 = peak * peak
    return ((p2 + max(p2 * p2 - p2, 0.0) ** 0.5) / 2.0) ** 0.5


def _timecents_to_s(tc: int) -> float:
    # -12000 timecents == "instant" per spec (< 1 ms); clamp well below 0
    if tc <= -11999:
        return 0.0
    return float(2.0 ** (tc / 1200.0))


# ------------------------------------------------- modulators (spec 9.5)
#
# Custom modulators (imod/pmod records) evaluated at NOTE-ON state: the GAN
# pipelines' MIDI carries no CC / pitch-wheel / aftertouch traffic, so every
# modulator source is static for the life of a voice — note-on velocity and
# key number are live, every controller-backed source reads its MIDI
# initial value (CC7 volume 100, CC10 pan 64, CC11 expression 127, all
# others 0; pitch wheel centered, sensitivity 2 semitones). Each modulator
# therefore collapses to one scalar added to its destination generator
# before the existing conversion/clamping — the render is untouched.

# curve closed forms: exact matches of FluidSynth's fluid_concave/convex
# tables at every integer input (table[i] = -(200/960)*log10(i^2/127^2)
# mirrored/complemented), with the tables' endpoint clamps.
def _mod_concave(v: float) -> float:
    if v <= 0.0:
        return 0.0
    if v >= 127.0:
        return 1.0
    return min(1.0, -(400.0 / 960.0) * np.log10((127.0 - v) / 127.0))


def _mod_convex(v: float) -> float:
    if v <= 0.0:
        return 0.0
    if v >= 127.0:
        return 1.0
    return max(0.0, 1.0 + (400.0 / 960.0) * np.log10(v / 127.0))


# initial controller state (MIDI defaults, matching FluidSynth's
# fluid_channel_init_ctrl): everything 0 except volume/pan/expression
_INIT_CC = {7: 100, 10: 64, 11: 127}

# CC indexes spec 8.2.1 forbids as modulator sources (bank select, data
# entry, (N)RPN selects, channel-mode messages): a modulator naming one is
# invalid and ignored entirely, matching fluid_mod_check_cc_source.
_FORBIDDEN_CC = frozenset({0, 6, 32, 38, 98, 99, 100, 101}) | frozenset(
    range(120, 128))


def _mod_source_raw(enum: int, key: int, vel: int):
    """Raw 0..127 value of a modulator source enumerator at note-on, or
    None when the source index is unknown (spec 9.5.2: such modulators are
    ignored entirely)."""
    index = enum & 0x7F
    if enum & 0x80:  # CC flag: a MIDI controller at its initial value
        if index in _FORBIDDEN_CC:
            return None  # spec 8.2.1: invalid controller -> whole mod ignored
        return float(_INIT_CC.get(index, 0))
    if index == 0:    # "no controller" == full scale
        return 127.0
    if index == 2:
        return float(vel)
    if index == 3:
        return float(key)
    if index in (10, 13):  # poly / channel pressure: none sent
        return 0.0
    if index == 14:        # pitch wheel centered: 8192/16384 of full scale
        return 63.5
    if index == 16:        # pitch wheel sensitivity: 2 semitones of 128
        return 2.0
    return None  # link (127) or unknown source


def _mod_transform_source(v: float, enum: int) -> float:
    """Map a raw 0..127 source through the enumerator's direction /
    polarity / curve bits to [-1, 1] (the 16 cases of spec 8.2.4, matching
    fluid_mod.c's arrangement)."""
    negative = bool(enum & 0x100)
    bipolar = bool(enum & 0x200)
    curve = (enum >> 10) & 0x3F
    if curve == 0:  # linear
        x = v / 127.0
        if not bipolar:
            return 1.0 - x if negative else x
        return 1.0 - 2.0 * x if negative else 2.0 * x - 1.0
    if curve == 3:  # switch: half-scale threshold (FluidSynth's
        # val/range >= 0.5 on range 127) — 63.5, so the centered pitch
        # wheel (63.5 on this scale) reads HIGH like FluidSynth's
        # 8192/16384; same result as >= 64 for every integer CC value
        hi = v >= 63.5
        lo = -1.0 if bipolar else 0.0
        return (lo if hi else 1.0) if negative else (1.0 if hi else lo)
    fn = _mod_concave if curve == 1 else _mod_convex if curve == 2 else None
    if fn is None:
        return None  # unknown curve type: ignore the modulator (spec 9.5.2)
    if not bipolar:
        return fn(127.0 - v) if negative else fn(v)
    # bipolar center is half scale (63.5): fn(2v - 127) is FluidSynth's
    # concave(127 * 2 * (v/127 - 0.5)) exactly, and a centered wheel maps
    # to 0 on both curve halves
    if negative:
        return -fn(2.0 * (v - 63.5)) if v > 63.5 else fn(2.0 * (63.5 - v))
    return fn(2.0 * (v - 63.5)) if v > 63.5 else -fn(2.0 * (63.5 - v))


def _mod_value(mod: Mod, key: int, vel: int):
    """The modulator's contribution to its destination generator, or None
    when any enumerator is unknown — unknown source index, curve type or
    transform means the ENTIRE modulator is ignored (spec 9.5.2)."""
    if mod.trans not in (0, 2):
        return None
    raw1 = _mod_source_raw(mod.src, key, vel)
    if raw1 is None:
        return None
    v1 = _mod_transform_source(raw1, mod.src)
    if v1 is None:
        return None
    if (mod.amt_src & 0xFF) == 0:
        # "no controller" amount source (index 0, CC flag clear) is unity
        # regardless of curve/polarity/direction bits — FluidSynth sets
        # v2 = 1.0 before any transform, not curve(127)
        v2 = 1.0
    else:
        raw2 = _mod_source_raw(mod.amt_src, key, vel)
        if raw2 is None:
            return None
        v2 = _mod_transform_source(raw2, mod.amt_src)
        if v2 is None:
            return None
    out = mod.amount * v1 * v2
    return abs(out) if mod.trans == 2 else out


def _supersede(base: list, over: list) -> list:
    """Spec 9.5.1 layering: a modulator in ``over`` replaces an identical
    (same source/destination/amount-source) one in ``base``."""
    table = {m.key(): m for m in base}
    for m in over:
        table[m.key()] = m
    return list(table.values())


# The default velocity->initialAttenuation modulator (spec 8.4.1): concave
# unipolar negative note-on velocity, 960 cB, no amount source. The render
# bakes it in as amp *= (vel/127)^2 — the exact closed form of
# 10^(-960*concave(127-vel)/200) — so it only goes through the modulator
# machinery when a font SUPERSEDES it (then the font's amount wins).
_DEFAULT_VEL_ATT_KEY = (0x0502, G_INITIAL_ATT, 0)

# Destinations the renderer honors as continuous synthesis parameters.
# Structural generators (sampleID, sampleModes, ranges, root key, address
# offsets, keynum-scaling and scaleTuning) are not modulatable per the
# spec 8.1.2 table and are excluded; a modulator targeting one is ignored.
_MODULATABLE = frozenset({
    G_MOD_LFO_TO_PITCH, G_VIB_LFO_TO_PITCH, G_MOD_ENV_TO_PITCH,
    G_INITIAL_FILTER_FC, G_INITIAL_FILTER_Q,
    G_MOD_LFO_TO_FILTER_FC, G_MOD_ENV_TO_FILTER_FC, G_MOD_LFO_TO_VOL,
    G_CHORUS_SEND, G_REVERB_SEND, G_PAN,
    G_DELAY_MOD_LFO, G_FREQ_MOD_LFO, G_DELAY_VIB_LFO, G_FREQ_VIB_LFO,
    G_DELAY_MOD_ENV, G_ATTACK_MOD_ENV, G_HOLD_MOD_ENV, G_DECAY_MOD_ENV,
    G_SUSTAIN_MOD_ENV, G_RELEASE_MOD_ENV,
    G_DELAY_VOL, G_ATTACK_VOL, G_HOLD_VOL, G_DECAY_VOL, G_SUSTAIN_VOL,
    G_RELEASE_VOL, G_INITIAL_ATT, G_COARSE_TUNE, G_FINE_TUNE,
})


@dataclass
class SampleHeader:
    name: str
    start: int
    end: int
    loop_start: int
    loop_end: int
    sample_rate: int
    original_pitch: int
    pitch_correction: int
    sample_type: int


@dataclass
class Zone:
    gens: dict = field(default_factory=dict)  # oper -> signed amount
    mods: list = field(default_factory=list)  # of Mod (spec 7.4/7.8 records)
    key_lo: int = 0
    key_hi: int = 127
    vel_lo: int = 0
    vel_hi: int = 127

    def matches(self, key: int, vel: int) -> bool:
        return self.key_lo <= key <= self.key_hi and self.vel_lo <= vel <= self.vel_hi


@dataclass(frozen=True)
class Mod:
    """One sfModList record (spec 7.4 pmod / 7.8 imod): src and amt_src are
    SFModulator enumerators (bits 0-6 index, 7 CC flag, 8 direction,
    9 polarity, 10-15 curve type), dest a generator oper, amount a signed
    short, trans the SFTransform (0 linear, 2 absolute value)."""
    src: int
    dest: int
    amount: int
    amt_src: int
    trans: int

    def key(self):
        """Supersession identity (spec 9.5.1 / FluidSynth's
        fluid_mod_test_identity): modulators are 'identical' when source,
        destination and amount-source match — the transform and amount are
        NOT part of the identity, so a superseder may change either."""
        return (self.src, self.dest, self.amt_src)


@dataclass
class Instrument:
    name: str
    global_zone: Zone | None
    zones: list  # of Zone, each with G_SAMPLE_ID


@dataclass
class Preset:
    name: str
    preset: int
    bank: int
    global_zone: Zone | None
    zones: list  # of Zone, each with G_INSTRUMENT


def _parse_zone_records(bag, gens, lo_bag, hi_bag, terminal_gen, mods=()):
    """Split a [lo_bag, hi_bag) bag range into (global_zone, zones) per the
    SF2 rule: a first zone without the terminal generator (sampleID /
    instrument) is the global zone. Global-zone generators are DEFAULTS for
    the other zones (spec 7.3/7.7) — that includes keyRange/velRange, so a
    global range folds into every zone that doesn't set its own. Each bag
    record's second field indexes the zone's modulator slice in ``mods``
    (parsed imod/pmod Mod list)."""
    zones = []
    global_zone = None
    own_ranges = []  # (has_key_range, has_vel_range) per zones[i]
    for zi in range(lo_bag, hi_bag):
        g_lo, g_hi = bag[zi][0], bag[zi + 1][0]
        m_lo, m_hi = bag[zi][1], bag[zi + 1][1]
        z = Zone()
        z.mods = list(mods[m_lo:m_hi])
        has_key = has_vel = False
        for gi in range(g_lo, g_hi):
            oper, raw = gens[gi]
            if oper == G_KEY_RANGE:
                z.key_lo, z.key_hi = raw & 0xFF, (raw >> 8) & 0xFF
                has_key = True
            elif oper == G_VEL_RANGE:
                z.vel_lo, z.vel_hi = raw & 0xFF, (raw >> 8) & 0xFF
                has_vel = True
            else:
                amt = raw - 0x10000 if raw >= 0x8000 else raw  # signed short
                z.gens[oper] = amt
        if terminal_gen in z.gens:
            zones.append(z)
            own_ranges.append((has_key, has_vel))
        elif zi == lo_bag and global_zone is None:
            global_zone = z
    if global_zone is not None:
        for z, (has_key, has_vel) in zip(zones, own_ranges):
            if not has_key:
                z.key_lo, z.key_hi = global_zone.key_lo, global_zone.key_hi
            if not has_vel:
                z.vel_lo, z.vel_hi = global_zone.vel_lo, global_zone.vel_hi
    return global_zone, zones


class Sf2Font:
    """Parsed SoundFont: 16-bit sample bank (as float32 in [-1, 1]) + the
    preset/instrument/zone hydra, with per-note voice resolution."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"RIFF" or data[8:12] != b"sfbk":
            raise ValueError(f"{path}: not a SoundFont 2 (RIFF sfbk) file")
        chunks = self._walk(data)
        missing = [c for c in ("smpl", "shdr", "pbag", "pgen", "ibag",
                               "igen", "inst", "phdr") if c not in chunks]
        if missing:
            raise ValueError(
                f"{path}: missing required SF2 chunk(s) {missing} "
                "(truncated or not a complete soundfont)")
        raw = chunks["smpl"]
        raw = raw[: len(raw) // 2 * 2]  # tolerate an odd trailing byte
        hi16 = np.frombuffer(raw, dtype="<i2")
        lo8 = chunks.get("sm24")
        if lo8 is not None and len(lo8) >= len(hi16):
            # 24-bit bank (spec 6.2/7.10): smpl holds the upper 16 bits,
            # sm24 one low byte per point. Combine to s24 / 2^23 — a
            # 16-bit-only font keeps the exact s16 / 2^15 values.
            lo = np.frombuffer(lo8[: len(hi16)], dtype=np.uint8)
            self.bank = ((hi16.astype(np.int32) * 256 + lo)
                         .astype(np.float32) / 8388608.0)
        else:
            self.bank = hi16.astype(np.float32) / 32768.0

        self.samples = [
            SampleHeader(
                name=r[0].split(b"\0")[0].decode("latin-1"),
                start=r[1], end=r[2], loop_start=r[3], loop_end=r[4],
                sample_rate=r[5], original_pitch=r[6], pitch_correction=r[7],
                sample_type=r[9],
            )
            for r in struct.iter_unpack("<20sIIIIIBbHH", chunks["shdr"])
        ][:-1]  # terminal EOS record

        try:
            pbag = list(struct.iter_unpack("<HH", chunks["pbag"]))
            pgen = list(struct.iter_unpack("<HH", chunks["pgen"]))
            ibag = list(struct.iter_unpack("<HH", chunks["ibag"]))
            igen = list(struct.iter_unpack("<HH", chunks["igen"]))
            # imod/pmod (specs 7.8/7.4): signed amount, enumerator sources.
            # The terminal all-zero record is harmless (never indexed by a
            # real zone's [m_lo, m_hi) slice).
            imod = [Mod(*r) for r in
                    struct.iter_unpack("<HHhHH", chunks.get("imod", b""))]
            pmod = [Mod(*r) for r in
                    struct.iter_unpack("<HHhHH", chunks.get("pmod", b""))]

            inst_recs = list(struct.iter_unpack("<20sH", chunks["inst"]))
            self.instruments = []
            for k in range(len(inst_recs) - 1):
                gz, zones = _parse_zone_records(
                    ibag, igen, inst_recs[k][1], inst_recs[k + 1][1],
                    G_SAMPLE_ID, imod)
                self.instruments.append(Instrument(
                    inst_recs[k][0].split(b"\0")[0].decode("latin-1"), gz, zones))

            phdr_recs = list(struct.iter_unpack("<20sHHHIII", chunks["phdr"]))
            self.presets = {}
            for k in range(len(phdr_recs) - 1):
                name, prog, bank_n, bag_ndx = phdr_recs[k][:4]
                gz, zones = _parse_zone_records(
                    pbag, pgen, bag_ndx, phdr_recs[k + 1][3], G_INSTRUMENT,
                    pmod)
                self.presets[(bank_n, prog)] = Preset(
                    name.split(b"\0")[0].decode("latin-1"), prog, bank_n, gz, zones)
        except (IndexError, struct.error) as e:
            # corrupt bag/gen indices point past their tables; surface one
            # clean error instead of an IndexError deep in zone walking
            raise ValueError(f"{path}: malformed SF2 hydra records ({e})") from e
        self._voice_cache: dict = {}

    @staticmethod
    def _walk(data: bytes) -> dict:
        """Flatten the RIFF tree into {chunk_id: payload} (pdta/sdta leaves)."""
        out = {}

        def walk(buf):
            pos = 0
            while pos + 8 <= len(buf):
                cid = buf[pos:pos + 4]
                (size,) = struct.unpack_from("<I", buf, pos + 4)
                body = buf[pos + 8:pos + 8 + size]
                if cid in (b"RIFF", b"LIST"):
                    walk(body[4:])  # skip form type
                else:
                    out[cid.decode("latin-1")] = body
                pos += 8 + size + (size & 1)

        walk(data)
        return out

    # ------------------------------------------------------ voice resolution

    def select_voices(self, program: int, key: int, vel: int, bank: int = 0):
        """All (sample, combined-generator) voices a note spawns. Returns a
        list of dicts of physical playback parameters. Cached per
        (bank, program, key, vel)."""
        ck = (bank, program, key, vel)
        hit = self._voice_cache.get(ck)
        if hit is not None:
            return hit
        preset = self.presets.get((bank, program))
        if preset is None and bank != 0:
            preset = self.presets.get((0, program))
        if preset is None:
            # GM player fallback: first preset in the font
            preset = next(iter(self.presets.values()), None)
        voices = []
        if preset is not None:
            pglobal = preset.global_zone.gens if preset.global_zone else {}
            pglobal_mods = preset.global_zone.mods if preset.global_zone else []
            for pz in preset.zones:
                if not pz.matches(key, vel):
                    continue
                pgens = dict(pglobal)
                pgens.update(pz.gens)
                pmods = _supersede(pglobal_mods, pz.mods)
                inst_id = pgens.pop(G_INSTRUMENT)
                if not 0 <= inst_id < len(self.instruments):
                    continue
                inst = self.instruments[inst_id]
                iglobal = inst.global_zone.gens if inst.global_zone else {}
                iglobal_mods = (inst.global_zone.mods
                                if inst.global_zone else [])
                for iz in inst.zones:
                    if not iz.matches(key, vel):
                        continue
                    igens = dict(iglobal)
                    igens.update(iz.gens)
                    imods = _supersede(iglobal_mods, iz.mods)
                    v = self._voice_params(igens, pgens, key, vel,
                                           imods, pmods)
                    if v is not None:
                        voices.append(v)
        self._voice_cache[ck] = voices
        return voices

    def _voice_params(self, igens: dict, pgens: dict, key: int, vel: int,
                      imods=(), pmods=()):
        # keynum/velocity (gens 46/47, instrument-only): substitute for the
        # MIDI values in everything DOWNSTREAM of zone selection — pitch,
        # keynum env scaling, the default velocity curve and modulator
        # sources — while the zone match above used the real MIDI values
        # (spec 8.1.2; FluidSynth's get_actual_key/velocity).
        kn = igens.get(G_KEYNUM, -1)
        if 0 <= kn <= 127:
            key = kn
        vn = igens.get(G_VELOCITY, -1)
        if 0 <= vn <= 127:
            vel = vn
        # Custom modulators collapse to static per-destination offsets at
        # note-on (module scope note): instrument-level mods supersede the
        # default velocity->attenuation modulator when their identity
        # matches it (spec 9.5.1); preset-level mods are purely additive.
        mod_sum: dict = {}
        vel_att_superseded = False
        for m in imods:
            # only a VALID matching modulator supersedes the default
            # velocity curve: an invalid one (unknown enumerator /
            # transform) is ignored entirely per spec 9.5.2, so the
            # default must survive it
            if (m.key() == _DEFAULT_VEL_ATT_KEY
                    and _mod_value(m, key, vel) is not None):
                vel_att_superseded = True
        for m in list(imods) + list(pmods):
            if m.dest not in _MODULATABLE:
                continue
            val = _mod_value(m, key, vel)
            if val is not None and val != 0.0:
                mod_sum[m.dest] = mod_sum.get(m.dest, 0.0) + val

        def gen(oper, preset_additive=True):
            v = igens.get(oper, _DEFAULTS[oper])
            if preset_additive and oper in pgens:
                v += pgens[oper]
            m = mod_sum.get(oper)
            if m is not None:
                v = v + m
            return v

        sid = igens[G_SAMPLE_ID]
        if not 0 <= sid < len(self.samples):
            return None
        sh = self.samples[sid]
        start = sh.start + gen(G_START_OFS, False) + 32768 * gen(G_START_COARSE, False)
        end = sh.end + gen(G_END_OFS, False) + 32768 * gen(G_END_COARSE, False)
        loop_start = (sh.loop_start + gen(G_STARTLOOP_OFS, False)
                      + 32768 * gen(G_STARTLOOP_COARSE, False))
        loop_end = (sh.loop_end + gen(G_ENDLOOP_OFS, False)
                    + 32768 * gen(G_ENDLOOP_COARSE, False))
        root = gen(G_ROOT_KEY, False)
        if root < 0:
            root = sh.original_pitch
        cents = (gen(G_SCALE_TUNING) * (key - root)
                 + 100 * gen(G_COARSE_TUNE) + gen(G_FINE_TUNE)
                 + sh.pitch_correction)
        ratio = 2.0 ** (cents / 1200.0)
        # modulated total clamps to the spec range [0, 1440] cB (a
        # superseded velocity->attenuation modulator routes through here)
        att_cb = min(max(0, gen(G_INITIAL_ATT)), 1440)
        sustain_cb = min(max(0, gen(G_SUSTAIN_VOL)), 1440)
        mode = igens.get(G_SAMPLE_MODES, 0)
        # SF2 low-pass (gens 8/9, spec 8.1.3): cutoff in absolute cents
        # above 8.176 Hz, range [1500, 13500]; >= 13500 means the filter is
        # fully open -> bypass (fc_hz = 0 sentinel). Q in centibels is the
        # resonance-peak height above DC gain; the DC gain itself drops by
        # half the Q (spec), so a resonant voice isn't net-louder.
        fc_cents = gen(G_INITIAL_FILTER_FC)
        q_cb = min(max(0, gen(G_INITIAL_FILTER_Q)), 960)
        # LFOs (spec 8.1.2: triangular, starting at zero rising). Frequency
        # generators are absolute cents above 8.176 Hz; amounts are cents of
        # peak pitch deviation / centibels of peak volume deviation.
        # pitch depths clamp to +-1200 cents (not the spec's +-12000): the
        # render linearizes 2^(c*tri/1200), which is only small-error — and
        # keeps the warped position ramp monotone through the memoryless
        # loop fold — for |k| = |c|*ln2/1200 < 1; an octave of vibrato is
        # far past any musical use of these generators anyway
        vib_cents = min(max(gen(G_VIB_LFO_TO_PITCH), -1200), 1200)
        mod_cents = min(max(gen(G_MOD_LFO_TO_PITCH), -1200), 1200)
        mod_vol_cb = min(max(gen(G_MOD_LFO_TO_VOL), -960), 960)
        _lfo_hz = lambda g: 8.176 * 2.0 ** (min(max(gen(g), -16000), 4500) / 1200.0)
        # pan (gen 17, -500 full left .. +500 full right): constant-power
        # legs fold into this mono render as (cos+sin)/sqrt(2), normalized
        # so center pan == 1 (a hard-panned leg lands at 1/sqrt(2))
        pan_ang = (min(max(gen(G_PAN), -500), 500) / 1000.0 + 0.5) * (np.pi / 2.0)
        pan_gain = (np.cos(pan_ang) + np.sin(pan_ang)) / np.sqrt(2.0)
        if fc_cents >= 13500:
            # open: skip the filter entirely. With Q set but fc open, the
            # resonant peak would sit at ~19.9 kHz (edge of audibility);
            # the audible effect — the half-Q DC drop — folds into amp
            # below either way, so the render skips the FFT work.
            fc_hz = 0.0
        else:
            fc_hz = 8.176 * 2.0 ** (max(fc_cents, 1500) / 1200.0)
        return {
            "start": float(start),
            "end": float(min(end, len(self.bank) - 1)),
            "loop_start": float(loop_start),
            "loop_end": float(min(loop_end, len(self.bank) - 1)),
            "loop": 1 if mode in (1, 3) else 0,
            "rate_ratio": ratio,
            "sample_rate": sh.sample_rate,
            # filter DC drop (half the Q, spec 8.1.3) folds into the gain.
            # (vel/127)^2 is the default velocity->attenuation modulator's
            # exact closed form (10^(-960*concave(127-vel)/200)); a font
            # that supersedes it already contributed its own curve via
            # att_cb, so the built-in factor drops out.
            "amp": ((1.0 if vel_att_superseded else (vel / 127.0) ** 2)
                    * 10.0 ** (-att_cb / 200.0)
                    * 10.0 ** (-q_cb / 400.0) * pan_gain),
            "delay_s": _timecents_to_s(gen(G_DELAY_VOL)),
            "attack_s": _timecents_to_s(gen(G_ATTACK_VOL)),
            # keynumToVolEnvHold/Decay (gens 39/40): +X timecents per
            # keynumber below middle key 60 (spec 8.1.3). Added in the
            # TIMECENT domain (not on the clamped seconds), so an
            # 'instant' -12000 base still key-scales per spec.
            "hold_s": _timecents_to_s(
                gen(G_HOLD_VOL)
                + min(max(gen(G_KEYNUM_TO_VOL_HOLD), -1200), 1200) * (60 - key)),
            "decay_s": _timecents_to_s(
                gen(G_DECAY_VOL)
                + min(max(gen(G_KEYNUM_TO_VOL_DECAY), -1200), 1200) * (60 - key)),
            "sustain_amp": 10.0 ** (-sustain_cb / 200.0),
            "release_s": max(_timecents_to_s(gen(G_RELEASE_VOL)), 1e-3),
            "fc_hz": fc_hz,
            "q_lin": _q_from_peak(10.0 ** (q_cb / 200.0)),
            # linearized pitch-LFO gain: d(rel)/dw = inc * 2^(c*tri/1200)
            # ~= inc * (1 + k*tri) with k = c*ln2/1200 (< 3 cents error at
            # the extreme 100-cent depth; exact to first order)
            "vib_k": vib_cents * (np.log(2.0) / 1200.0),
            "vib_freq_hz": _lfo_hz(G_FREQ_VIB_LFO),
            "vib_delay_s": _timecents_to_s(gen(G_DELAY_VIB_LFO)),
            "mod_k": mod_cents * (np.log(2.0) / 1200.0),
            "mod_freq_hz": _lfo_hz(G_FREQ_MOD_LFO),
            "mod_delay_s": _timecents_to_s(gen(G_DELAY_MOD_LFO)),
            "mod_vol_cb": float(mod_vol_cb),
            # modulation envelope -> pitch (gens 25-30 + 7, spec 8.1.2):
            # a DAHDSR with LINEAR attack/decay/release in level (unlike
            # the volume env's dB ramps); sustain (gen 29) is a 0.1%
            # DECREASE from full scale. Pitch depth linearizes like the
            # LFOs (clamped to the monotone +-1200 cents regime); the
            # filter target rides the fc_cents/menv_fc columns below.
            "menv_k": (min(max(gen(G_MOD_ENV_TO_PITCH), -1200), 1200)
                       * (np.log(2.0) / 1200.0)),
            "menv_delay_s": _timecents_to_s(gen(G_DELAY_MOD_ENV)),
            "menv_attack_s": _timecents_to_s(gen(G_ATTACK_MOD_ENV)),
            "menv_hold_s": _timecents_to_s(
                gen(G_HOLD_MOD_ENV)
                + min(max(gen(G_KEYNUM_TO_MOD_ENV_HOLD), -1200), 1200)
                * (60 - key)),
            "menv_decay_s": _timecents_to_s(
                gen(G_DECAY_MOD_ENV)
                + min(max(gen(G_KEYNUM_TO_MOD_ENV_DECAY), -1200), 1200)
                * (60 - key)),
            "menv_sustain": 1.0 - min(max(gen(G_SUSTAIN_MOD_ENV), 0), 1000) / 1000.0,
            "menv_release_s": max(_timecents_to_s(gen(G_RELEASE_MOD_ENV)), 1e-4),
            # filter-sweep targets (gens 10/11, cents added onto the base
            # cutoff per frame in the block-wise time-varying filter path).
            # The BASE clamps to the generator's own [1500, 13500] range
            # BEFORE modulation (spec/FluidSynth semantics — an
            # out-of-range 'fully open' base like 16000 still sweeps down
            # from 13500, not from 16000); the per-frame sum clamps again.
            "fc_cents": float(min(max(fc_cents, 1500), 13500)),
            "menv_fc": float(min(max(gen(G_MOD_ENV_TO_FILTER_FC), -12000), 12000)),
            "lfo_fc": float(min(max(gen(G_MOD_LFO_TO_FILTER_FC), -12000), 12000)),
            # effects sends (gens 15/16, 0.1% units, spec 8.1.3): the
            # fraction of this voice mixed into the chorus/reverb bus.
            # These are the FONT's own send values; the CC 91/93 default
            # modulators would ADD to them, but the GAN pipelines' MIDI
            # never emits those controllers (see module scope note).
            "rev_send": min(max(gen(G_REVERB_SEND), 0), 1000) / 1000.0,
            "cho_send": min(max(gen(G_CHORUS_SEND), 0), 1000) / 1000.0,
            # exclusiveClass (gen 57, instrument-only): a non-zero class
            # makes a later same-class note-on choke this voice (host-side
            # scheduling in events_to_voices; never shipped to the render)
            "excl": int(igens.get(G_EXCLUSIVE_CLASS, 0)),
        }




# ----------------------------------------------------------- device render

MAX_NOTE_S = 2.4     # rendered note cap: W = pow2((2.4 + 0.5) * 44100) = 2^17
MAX_RELEASE_S = 0.5  # release tail cap inside the window
EVENT_BLOCK = 32
# Per-voice parameter columns, packed into one (len(_F), E) float32 array.
# Positions are start-relative floats beside a separate int32 absolute
# start: a GM bank (FluidR3's holds ~65M samples) exceeds 2^24, past exact
# float32 indexing, while any one sample segment stays well within it.
_F = ("on_s", "dur_s", "amp", "end_rel", "loop_start_rel",
      "loop_end_rel", "loop", "inc", "delay_s", "attack_s", "hold_s",
      "decay_s", "sustain_amp", "release_s", "fc_hz", "q_lin",
      "vib_k", "vib_freq_hz", "vib_delay_s",
      "mod_k", "mod_freq_hz", "mod_delay_s", "mod_vol_cb",
      "menv_k", "menv_delay_s", "menv_attack_s", "menv_hold_s",
      "menv_decay_s", "menv_sustain", "menv_release_s",
      "fc_cents", "menv_fc", "lfo_fc",
      "rev_send", "cho_send")


# ------------------------------------------------- effects (gens 15/16)
#
# FluidSynth's default-settings effects units, engaged when the FONT sets
# chorusEffectsSend/reverbEffectsSend on a zone (FluidR3_GM does on most
# presets). The reverb is the Freeverb room model — the public-domain
# design FluidSynth's reverb derives from — at FluidSynth's default knobs
# (room-size 0.2, damp 0, width 0.5, level 0.9). A fixed-parameter reverb
# is LTI, so the whole comb/all-pass network collapses to one impulse
# response computed once on the host (scipy difference equations) and
# FFT-convolved with the send-weighted bus inside the render program. The
# chorus is FluidSynth's default-shaped sine-modulated delay (3 voices,
# speed 0.3 Hz, depth 8 ms, level 2.0, averaged over voices) — time-
# varying, so it renders as interpolated gathers over the chorus bus.
_REVERB_COMBS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_REVERB_ALLPASS = (556, 441, 341, 225)
_REVERB_SPREAD = 23          # right-channel delay offset (samples @44.1k)
_REVERB_FIXED_GAIN = 0.015   # input gain into the comb bank
_REVERB_ROOMSIZE = 0.2       # FluidSynth synth.reverb.room-size default
_REVERB_DAMP = 0.0           # synth.reverb.damp default
_REVERB_WIDTH = 0.5          # synth.reverb.width default
_REVERB_LEVEL = 0.9          # synth.reverb.level default
_CHORUS_N = 3                # synth.chorus.nr default
_CHORUS_LEVEL = 2.0          # synth.chorus.level default
_CHORUS_SPEED_HZ = 0.3       # synth.chorus.speed default
_CHORUS_DEPTH_MS = 8.0       # synth.chorus.depth default

_REVERB_IR_CACHE: dict = {}


def _freeverb_ir(sr: int) -> np.ndarray:
    """Mono impulse response of the Freeverb network at FluidSynth's
    default room parameters: 8 parallel feedback combs per channel (the
    right channel's delays offset by the stereo spread), each channel
    through 4 serial Schroeder all-passes, wet1/wet2 width mix folded to
    mono as the L/R average. Delay tunings are 44.1 kHz values scaled to
    ``sr``. Truncated where the tail falls below -100 dBFS of its peak."""
    if sr in _REVERB_IR_CACHE:
        return _REVERB_IR_CACHE[sr]
    from scipy.signal import lfilter

    scale = sr / 44100.0
    feedback = _REVERB_ROOMSIZE * 0.28 + 0.7   # freeverb scaleroom/offsetroom
    damp = _REVERB_DAMP * 0.4                  # freeverb scaledamp
    n = int(3.0 * sr)  # generous; truncated below
    x = np.zeros(n)
    x[0] = _REVERB_FIXED_GAIN

    def comb(sig, D):
        # y[n] = x[n-D] + f*(1-d)*y[n-D] + d*y[n-1] - d*x[n-D-1]
        # (feedback comb with a one-pole low-pass of coefficient d in the
        # loop; d == 0 reduces to y[n] = x[n-D] + f*y[n-D])
        b = np.zeros(D + 2)
        b[D], b[D + 1] = 1.0, -damp
        a = np.zeros(D + 1)
        a[0] = 1.0
        a[1] += -damp
        a[D] += -feedback * (1.0 - damp)
        return lfilter(b, a, sig)

    def allpass(sig, D, g=0.5):
        # freeverb's "allpass" (output = -input + bufout; buffer = input +
        # g*bufout): y[n] = -x[n] + (1+g)*x[n-D] + g*y[n-D], i.e.
        # H(z) = ((1+g) z^-D - 1) / (1 - g z^-D) — the delayed input term
        # carries (1+g), which keeps H(1) = 1 (no DC null)
        b = np.zeros(D + 1)
        b[0], b[D] = -1.0, 1.0 + g
        a = np.zeros(D + 1)
        a[0], a[D] = 1.0, -g
        return lfilter(b, a, sig)

    sides = []
    for spread in (0, _REVERB_SPREAD):
        ds = [int(round((D + spread) * scale)) for D in _REVERB_COMBS]
        y = sum(comb(x, max(D, 1)) for D in ds)
        for D in _REVERB_ALLPASS:
            y = allpass(y, max(int(round((D + spread) * scale)), 1))
        sides.append(y)
    wet = _REVERB_LEVEL * 3.0                  # freeverb scalewet
    wet1 = wet * (_REVERB_WIDTH / 2.0 + 0.5)
    wet2 = wet * ((1.0 - _REVERB_WIDTH) / 2.0)
    # outL = wet1*L + wet2*R, outR = wet1*R + wet2*L -> mono average
    ir = (wet1 + wet2) / 2.0 * (sides[0] + sides[1])
    peak = np.max(np.abs(ir))
    keep = np.nonzero(np.abs(ir) > peak * 1e-5)[0]
    ir = ir[: int(keep[-1]) + 1] if len(keep) else ir[:1]
    out = ir.astype(np.float32)
    _REVERB_IR_CACHE[sr] = out
    return out



# Division by a constant is written as a product with its float32
# reciprocal, as XLA compiles it and as PyTorch's CUDA kernels compute a
# division by a Python number (its CPU kernels divide), so the CPU and the
# card run the same arithmetic. A constant numerator is a 0-dim tensor
# (``Tensor.__rtruediv__`` would take a reciprocal first).


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the float64 product of two
    float32 values is exact). The position ramp's multiply-adds are fused,
    as the JAX package's compiled CPU program computes them: positions reach
    ~10^4-10^5 samples, where one extra float32 rounding moves a sample of
    a bright tone by up to ~1e-4 of its amplitude."""
    return (a.double() * b.double() + c.double()).float()


def _tri(u):
    """Triangle LFO (spec 8.1.2): period 1, starts at 0 rising, +1 at
    u=0.25, -1 at u=0.75."""
    p = u - torch.floor(u)
    return torch.where(p < 0.25, 4.0 * p,
                       torch.where(p < 0.75, 2.0 - 4.0 * p, 4.0 * p - 4.0))


def _tri_integral(u):
    """Integral of tri from 0 to u -- whole periods integrate to 0, so only
    the fractional part contributes (piecewise quadratic, max 1/4 at
    u=0.5; the quarter-period value at u=0.25 is 1/8)."""
    p = u - torch.floor(u)
    return torch.where(p < 0.25, 2.0 * p * p,
                       torch.where(p < 0.75, 2.0 * p - 2.0 * p * p - 0.25,
                                   2.0 * (p - 1.0) ** 2))


def _clip(x, lo: float, hi):
    """``jnp.clip(x, lo, hi)`` for a number ``lo`` and a tensor ``hi``
    (``torch.clamp`` takes both bounds as numbers or both as tensors)."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _menv_integral(t, A, H, D, S, R, dur):
    """Integral from 0 to t of the modulation envelope (spec 8.1.2 DAHDSR
    with LINEAR attack, linear decay to sustain level S, and linear release
    over R from the value held at note-off). ``t`` is time since the
    envelope's delay ended; ``dur`` is the note-off instant in the same
    frame. The pre-release envelope is e(x) = ramp(x; 0, A) - (1-S) *
    ramp(x; A+H, D) with ramp(x; t0, T) = clip((x-t0)/T, 0, 1); its integral
    is piecewise quadratic, and the release integral is quadratic in
    (t - dur), saturating at E0*R/2. Negative ``t``/``dur`` degrade to 0."""
    A = torch.clamp(A, min=1e-6)
    D = torch.clamp(D, min=1e-6)

    def ramp_int(x, t0, T):
        y = _clip(x - t0, 0.0, T)
        return y * y / (2.0 * T) + torch.clamp(x - t0 - T, min=0.0)

    def base_int(x):
        x = torch.clamp(x, min=0.0)
        return ramp_int(x, 0.0, A) - (1.0 - S) * ramp_int(x, A + H, D)

    e_dur = (torch.clamp(dur / A, 0.0, 1.0)
             - (1.0 - S) * torch.clamp((dur - A - H) / D, 0.0, 1.0))
    s = _clip(t - dur, 0.0, R)
    return torch.where(t <= dur, base_int(t),
                       base_int(dur) + e_dur * (s - s * s / (2.0 * R)))


def _menv_value(t, A, H, D, S, R, dur):
    """The modulation envelope's VALUE at t (same DAHDSR frame as
    ``_menv_integral``; the time-varying filter needs the level)."""
    A = torch.clamp(A, min=1e-6)
    D = torch.clamp(D, min=1e-6)
    base = lambda x: (torch.clamp(x / A, 0.0, 1.0)
                      - (1.0 - S) * torch.clamp((x - A - H) / D, 0.0, 1.0))
    return torch.where(t <= dur, base(t),
                       torch.clamp(base(dur) * (1.0 - (t - dur) / R), min=0.0))


def _chorus_phase(t, k: int, sr: int):
    """2*pi * (speed * t / sr + k / n) of chorus voice ``k``, rounded as the
    JAX package's compiled CPU program rounds it: the constants folded in
    float32, voice 0 one product, the others (which share t * speed / sr)
    a product, a sum and a product. The phase reaches ~360 rad over a 190 s
    render, where one more float32 rounding moves the delay by ~1e-3
    samples and the chorus by up to ~1e-4 of its amplitude."""
    f32 = np.float32
    two_pi, speed = f32(2.0 * math.pi), f32(_CHORUS_SPEED_HZ)
    inv_sr = f32(1.0) / f32(sr)
    if k == 0:
        return t * float(two_pi * speed * inv_sr)
    return (t * float(speed * inv_sr) + float(f32(k / float(_CHORUS_N)))) * float(two_pi)


def _render_sf2(bank, packed, start_i, rev_ir, L: int, W: int, sr: int,
                use_filter: bool = False, use_lfo: bool = False,
                use_cubic: bool = True, use_rev: bool = False,
                use_cho: bool = False, use_menv: bool = False,
                use_dynfilter: bool = False):
    """Sample-playback render on ``bank``'s device: per voice, W output
    samples gather from the bank at the voice's phase increment (4-point
    cubic interpolation or linear; loop folding) under the SF2 volume
    envelope, and are added at the onset sample. ``packed`` is the host's
    (len(_F), E) float32 column array, ``start_i`` the (E,) int32 absolute
    sample starts, ``rev_ir`` the reverb's impulse response on the device.
    Pad voices carry amp == 0 and are never added. The output is the
    L-sample window; a voice's samples past it are dropped.

    Voices render EVENT_BLOCK at a time, blocks in order, and each voice's
    window is added to the buffers in voice order: the JAX program's
    scatter order, with no atomics, so repeats are bitwise equal.

    ``use_filter``: the SF2 low-pass (gens 8/9) as a zero-phase magnitude
    filter, one rfft/irfft of W per block. ``use_dynfilter``: the swept
    cutoff through a block STFT at hop F/2. ``use_lfo``, ``use_menv``: the
    LFOs' and the modulation envelope's pitch warp (and tremolo).
    ``use_rev`` / ``use_cho``: send-weighted reverb and chorus buses; the
    reverb bus is FFT-convolved with ``rev_ir`` at N = pow2(L + len(IR)),
    the chorus is a 3-voice sine-modulated delay of its bus. Every toggle
    off runs exactly the program without that feature."""
    E = start_i.shape[0]
    if E % EVENT_BLOCK:  # the loop below walks whole blocks only; a ragged
        # capacity would silently drop the trailing voices
        raise ValueError(f"voice capacity {E} must be a multiple of {EVENT_BLOCK}")
    device = bank.device
    # onset samples and validity on the host: they pick the slices to add
    on_samp = np.round(packed[_F.index("on_s")] * np.float32(sr)).astype(np.int64)
    valid = packed[_F.index("amp")] > 0
    cols_d = torch.from_numpy(np.ascontiguousarray(packed)).to(device)
    start_d = torch.from_numpy(np.asarray(start_i, np.int64)).to(device)
    sr_t = torch.tensor(float(sr), dtype=torch.float32, device=device)
    last = bank.shape[0] - 1
    w_steps = torch.arange(W, dtype=torch.float32, device=device)[None, :]  # output sample
    t_local = w_steps * (1.0 / sr)

    n_bufs = 1 + int(use_rev) + int(use_cho)
    bufs = [torch.zeros(L, dtype=torch.float32, device=device) for _ in range(n_bufs)]
    for b0 in range(0, E, EVENT_BLOCK):
        voices = [e for e in range(b0, b0 + EVENT_BLOCK) if valid[e] and on_samp[e] < L]
        if not voices:
            continue
        b = {k: cols_d[i, b0:b0 + EVENT_BLOCK, None] for i, k in enumerate(_F)}  # (EB, 1)
        b_start = start_d[b0:b0 + EVENT_BLOCK, None]

        # ---- start-relative sample position with loop folding
        pos = w_steps
        if use_lfo:
            # pitch LFOs warp the position ramp: the integral of
            # 1 + k*tri(f*(t-d)) is w + k*sr*P(frac)/f, P the closed-form
            # triangle integral
            u_v = torch.clamp(t_local - b["vib_delay_s"], min=0.0) * b["vib_freq_hz"]
            u_m = torch.clamp(t_local - b["mod_delay_s"], min=0.0) * b["mod_freq_hz"]
            pos = _fma(b["vib_k"] * _tri_integral(u_v),
                       sr_t / torch.clamp(b["vib_freq_hz"], min=1e-4), pos)
            pos = _fma(b["mod_k"] * _tri_integral(u_m),
                       sr_t / torch.clamp(b["mod_freq_hz"], min=1e-4), pos)
        if use_menv:
            # modEnvToPitch warps the ramp by the DAHDSR's closed-form
            # integral, same linearization as the LFOs
            pos = _fma(b["menv_k"] * sr, _menv_integral(
                t_local - b["menv_delay_s"],
                b["menv_attack_s"], b["menv_hold_s"], b["menv_decay_s"],
                b["menv_sustain"], b["menv_release_s"], b["dur_s"] - b["menv_delay_s"]), pos)
        rel = b["inc"] * pos                                          # (EB, W)
        span = torch.clamp(b["loop_end_rel"] - b["loop_start_rel"], min=1.0)
        # loop region is [loop_start, loop_end): position loop_end wraps
        fold = (b["loop"] > 0) & (rel >= b["loop_end_rel"])
        # torch.remainder is the floor modulo of jnp.mod (fmod would keep
        # the sign of a negative offset)
        folded = b["loop_start_rel"] + torch.remainder(rel - b["loop_start_rel"], span)
        rel = torch.where(fold, folded, rel)
        in_range = rel < b["end_rel"]
        rel = _clip(rel, 0.0, b["end_rel"])

        r0 = torch.floor(rel)
        f = rel - r0

        def gather(ofs):
            idx = r0 + ofs
            # folded positions live on the loop circle: wrap the
            # interpolation window around the seam; first-pass positions
            # keep their natural neighbors
            wrapped = b["loop_start_rel"] + torch.remainder(idx - b["loop_start_rel"], span)
            idx = torch.where(fold, wrapped, idx)
            # int64 absolute index (the bank may exceed 2^24 samples),
            # clamped as jnp.take(mode="clip") does
            i = torch.clamp(b_start + idx.to(torch.int64), 0, last)
            return bank[i]
        if use_cubic:
            # Catmull-Rom weights: exact passthrough at f == 0
            f2 = f * f
            f3 = f2 * f
            sig = (gather(-1) * (-0.5 * f3 + f2 - 0.5 * f)
                   + gather(0) * (1.5 * f3 - 2.5 * f2 + 1.0)
                   + gather(1) * (-1.5 * f3 + 2.0 * f2 + 0.5 * f)
                   + gather(2) * (0.5 * f3 - 0.5 * f2))
        else:
            sig = gather(0) * (1.0 - f) + gather(1) * f

        # ---- SF2 volume envelope (delay, linear-amp attack, hold,
        # linear-dB decay to sustain, linear-dB release at 96 dB/release_s)
        t = t_local - b["delay_s"]
        a_s = b["attack_s"]
        att = torch.where(a_s > 1e-9,  # 0 timecents-clamped attack is INSTANT
                          torch.clamp(t / torch.clamp(a_s, min=1e-9), 0.0, 1.0),
                          (t >= 0.0).to(torch.float32))
        t_dec = t - b["attack_s"] - b["hold_s"]
        sus_db = -20.0 * torch.log10(torch.clamp(b["sustain_amp"], min=1e-5))
        dec_db = torch.clamp(t_dec / torch.clamp(b["decay_s"], min=1e-4), 0.0, 1.0) * sus_db
        t_rel = t_local - b["dur_s"]
        rel_db = torch.clamp(t_rel, min=0.0) / b["release_s"] * 96.0
        env = att * torch.pow(10.0, -(dec_db + rel_db) * (1.0 / 20.0))
        env = torch.where(rel_db < 96.0, env, 0.0)
        if use_lfo:
            # modLfoToVolume: triangle tremolo in centibels on the envelope
            env = env * torch.pow(10.0, b["mod_vol_cb"] * _tri(u_m) * (1.0 / 200.0))

        win = sig * env * in_range

        if use_dynfilter:
            # time-varying low-pass (gens 11/10): block STFT with a
            # periodic Hann at hop F/2 (exact COLA), each frame multiplied
            # by the 2-pole magnitude response at its swept cutoff,
            # clamped to [1500, 13500] cents. Frame f is centred at sample
            # f*hop. env/in_range fold in before the FFT, env > 0 gates
            # after it, as in the static path.
            F_ = min(2048, W)  # small windows (low sr) shrink the frame so
            # W stays a whole number of hops
            hop = F_ // 2
            nB = W // hop
            hann = 0.5 * (1.0 - torch.cos(
                2.0 * math.pi * torch.arange(F_, dtype=torch.float32, device=device)
                * (1.0 / F_)))
            padded = torch.nn.functional.pad(win, (hop, hop))
            blocks = padded.reshape(EVENT_BLOCK, nB + 2, hop)
            frames = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=-1)
            spec = torch.fft.rfft(frames * hann, dim=-1)               # (EB, nF, F/2+1)

            tf = (torch.arange(nB + 1, dtype=torch.float32, device=device) * hop
                  * (1.0 / sr))[None, :]
            ev = _menv_value(
                tf - b["menv_delay_s"],
                b["menv_attack_s"], b["menv_hold_s"], b["menv_decay_s"],
                b["menv_sustain"], b["menv_release_s"], b["dur_s"] - b["menv_delay_s"])
            u_f = torch.clamp(tf - b["mod_delay_s"], min=0.0) * b["mod_freq_hz"]
            cents = b["fc_cents"] + b["menv_fc"] * ev + b["lfo_fc"] * _tri(u_f)
            fc_f = 8.176 * torch.pow(2.0, torch.clamp(cents, 1500.0, 13500.0) * (1.0 / 1200.0))

            freqs = torch.arange(F_ // 2 + 1, dtype=torch.float32, device=device) * (sr / F_)
            rr = freqs[None, None, :] / fc_f[:, :, None]
            mag = torch.rsqrt((1.0 - rr * rr) ** 2
                              + (rr / b["q_lin"][:, :, None]) ** 2 + 1e-12)
            swept = (torch.abs(b["menv_fc"]) + torch.abs(b["lfo_fc"])) > 0.0
            apply_f = swept | (b["fc_cents"] < 13500.0)
            H = torch.where(apply_f[:, :, None], mag, 1.0)

            filt = torch.fft.irfft(spec * H, n=F_, dim=-1)             # (EB, nF, F)
            # overlap-add: block b is frame b's second half plus frame
            # b+1's first half (the Hann halves sum to 1)
            fh, sh = filt[..., :hop], filt[..., hop:]
            win = (sh[:, :nB] + fh[:, 1:]).reshape(EVENT_BLOCK, W) * (env > 0.0)
        elif use_filter:
            # SF2 low-pass, zero-phase: analog 2-pole magnitude
            # |H|^2 = 1 / ((1 - r^2)^2 + (r/Q)^2) at r = f/fc; fc_hz == 0
            # bypasses. The envelope and in_range fold in before the
            # circular FFT, the env > 0 gate after it kills the onset
            # pre-ring that wraps to the window's silent end.
            freqs = torch.arange(W // 2 + 1, dtype=torch.float32, device=device) * (sr / W)
            fc = b["fc_hz"]
            rr = freqs[None, :] / torch.clamp(fc, min=1.0)
            mag = torch.rsqrt((1.0 - rr * rr) ** 2 + (rr / b["q_lin"]) ** 2 + 1e-12)
            H = torch.where(fc > 0.0, mag, 1.0)
            win = torch.fft.irfft(torch.fft.rfft(win, dim=-1) * H, n=W, dim=-1) * (env > 0.0)

        win = win * b["amp"]
        wins = [win]
        if use_rev:
            wins.append(win * b["rev_send"])
        if use_cho:
            wins.append(win * b["cho_send"])
        for e in voices:
            on = int(on_samp[e])
            n = min(W, L - on)
            for buf, w in zip(bufs, wins):
                buf[on:on + n] += w[e - b0, :n]

    audio = bufs[0]
    if use_rev:
        # reverb: LTI -> one circular FFT convolution with the Freeverb IR
        # (N covers L + IR length, so the wrap never aliases)
        N = _pow2(L + rev_ir.shape[0])
        audio = audio + torch.fft.irfft(
            torch.fft.rfft(bufs[1], n=N) * torch.fft.rfft(rev_ir, n=N), n=N)[:L]
    if use_cho:
        # chorus: voice k reads the bus at t - d_k(t), a sine-modulated delay
        # in [0, depth] with evenly spaced phases; linear interpolation
        # between bus samples, pre-onset reads are zero. pos = t - d splits
        # as (t - floor(d)) - frac(d): t and t - floor(d) are exact float32
        # integers (L < 2^24), so the fraction keeps full precision where
        # pos itself has ulp >= 1 (t > 2^22, renders past ~95 s)
        cho_bus = bufs[-1]
        t = torch.arange(L, dtype=torch.float32, device=device)
        acc = torch.zeros(L, dtype=torch.float32, device=device)
        depth = _CHORUS_DEPTH_MS * 1e-3 * sr
        for k in range(_CHORUS_N):
            d = 0.5 * depth * (1.0 + torch.sin(_chorus_phase(t, k, sr)))
            dk = torch.floor(d)
            r = d - dk              # [0, 1), full f32 precision
            base = t - dk           # exact integer in f32
            p0 = torch.where(r > 0, base - 1.0, base)
            frac = torch.where(r > 0, 1.0 - r, 0.0)
            g = lambda p: torch.where(
                p >= 0.0, cho_bus[torch.clamp(p, 0.0, L - 1).to(torch.int64)], 0.0)
            acc = acc + g(p0) * (1.0 - frac) + g(p0 + 1.0) * frac
        audio = audio + _CHORUS_LEVEL * acc * (1.0 / _CHORUS_N)
    peak = torch.max(torch.abs(audio))
    return torch.where(peak > 1.0, audio / (peak + 1e-6), audio)


def _voice_bucket(n: int) -> int:
    """Round a voice capacity up to a whole number of EVENT_BLOCK-voice
    blocks (pad voices carry amp == 0, so rounding up is free)."""
    n = max(int(n), EVENT_BLOCK)
    return -(-n // EVENT_BLOCK) * EVENT_BLOCK


class Sf2Synth:
    """Renders MIDI through a parsed SoundFont on ``device`` (default
    ``cuda``). One instance holds the float32 sample bank on the device
    and the voice-resolution cache; reuse it across renders.

    ``interp``: 'cubic' (default -- FluidSynth's default 4th-order
    interpolation, 4-point Catmull-Rom) or 'linear'."""

    def __init__(self, sound_font: str, interp: str = "cubic", device="cuda"):
        if interp not in ("cubic", "linear"):
            raise ValueError(f"interp must be 'cubic' or 'linear', got {interp!r}")
        self.font = Sf2Font(sound_font)
        self.device = torch.device(device)
        self.bank = torch.from_numpy(self.font.bank).to(self.device)
        self.use_cubic = interp == "cubic"

    def midi_to_voices(self, midi, sr: int, max_voices: int = 2048,
                       max_events: int | None = None):
        """Flatten a MidiFile into per-voice parameter columns (host side:
        zone selection is dict lookups). ``max_events`` bounds the
        extracted MIDI events (the ``synth.render_midi`` knob);
        ``max_voices`` bounds the flattened per-zone voices (a note can
        expand to several, e.g. stereo pairs)."""
        from gandes_tpu_torch.music.midi import MidiFile
        from gandes_tpu_torch.music.synth import midi_to_event_arrays

        m = MidiFile(midi) if isinstance(midi, str) else midi
        events = midi_to_event_arrays(m, max_events=max_events or max_voices)
        return self.events_to_voices(events, sr, max_voices=max_voices)

    def events_to_voices(self, events, sr: int, max_voices: int = 2048):
        """Voice columns from pre-extracted (note, vel, on, off, program)
        event arrays -- the ``midi_to_event_arrays`` tuple or the native
        decoder's identical output."""
        notes, vels, ons, offs, progs, n, end_t = events
        # the note count may exceed the padded arrays (``midi_to_event_arrays``
        # counts every note of the MIDI and keeps max_events of them)
        n = min(int(n), len(notes))
        cols = {k: [] for k in _F}
        cols["start_i"] = []
        # exclusiveClass choke state: class -> indices of voices that may
        # still be sustaining when a later same-class note lands. Keyed by
        # class only (FluidSynth scopes it per MIDI channel; the pipelines'
        # MIDI is single-channel). A choked voice keeps its own release,
        # capped at MAX_RELEASE_S, quicker than FluidSynth's -200 tc kill
        # release, so truncating dur alone implements the choke.
        excl_live: dict = {}
        for i in range(n):
            key, vel = int(notes[i]), int(vels[i])
            zones = self.font.select_voices(int(progs[i]), key, vel)
            if len(cols["on_s"]) + len(zones) > max_voices:
                # cap at a NOTE boundary: a stereo sample pair renders
                # whole or not at all
                break
            t_on = float(ons[i])
            for cls in {vp["excl"] for vp in zones if vp["excl"]}:
                for j in excl_live.get(cls, ()):
                    if cols["on_s"][j] + cols["dur_s"][j] > t_on:
                        cols["dur_s"][j] = max(t_on - cols["on_s"][j], 0.0)
                # every prior voice in this class now ends by t_on, and
                # events arrive in on-time order: clear instead of rescanning
                excl_live[cls] = []
            for vp in zones:
                if vp["excl"]:
                    excl_live.setdefault(vp["excl"], []).append(len(cols["on_s"]))
                start = int(vp["start"])
                cols["on_s"].append(float(ons[i]))
                cols["dur_s"].append(max(min(float(offs[i] - ons[i]), MAX_NOTE_S), 0.0))
                cols["amp"].append(vp["amp"])
                cols["start_i"].append(start)
                cols["end_rel"].append(vp["end"] - start)
                cols["loop_start_rel"].append(vp["loop_start"] - start)
                cols["loop_end_rel"].append(vp["loop_end"] - start)
                cols["loop"].append(vp["loop"])
                # bank samples advanced per output sample
                cols["inc"].append(vp["rate_ratio"] * vp["sample_rate"] / sr)
                cols["delay_s"].append(vp["delay_s"])
                cols["attack_s"].append(vp["attack_s"])
                cols["hold_s"].append(vp["hold_s"])
                cols["decay_s"].append(min(vp["decay_s"], 100.0))
                cols["sustain_amp"].append(vp["sustain_amp"])
                cols["release_s"].append(min(vp["release_s"], MAX_RELEASE_S))
                cols["fc_hz"].append(vp["fc_hz"])
                cols["q_lin"].append(vp["q_lin"])
                for k in ("vib_k", "vib_freq_hz", "vib_delay_s",
                          "mod_k", "mod_freq_hz", "mod_delay_s",
                          "mod_vol_cb", "menv_k", "menv_delay_s",
                          "menv_attack_s", "menv_hold_s", "menv_decay_s",
                          "menv_sustain", "menv_release_s",
                          "fc_cents", "menv_fc", "lfo_fc",
                          "rev_send", "cho_send"):
                    cols[k].append(vp[k])
        return cols, len(cols["on_s"]), float(end_t)

    def render_midi(self, midi, sr: int = 44100, min_seconds: float = 0.5,
                    tail: float = 0.3, max_voices: int = 2048,
                    pad_to_bucket: bool = False, as_tensor: bool = False,
                    max_events: int | None = None):
        """Render a MidiFile (or path). Returns numpy audio cropped to the
        true length (the whole pow2 bucket with ``pad_to_bucket``), or with
        ``as_tensor`` the bucketed buffer on the synth's device and the
        true sample count (``synth.render_midi``'s conventions)."""
        cols, nv, end_t = self.midi_to_voices(midi, sr, max_voices=max_voices,
                                              max_events=max_events)
        return self._render_cols(cols, nv, end_t, sr, min_seconds, tail,
                                 pad_to_bucket, as_tensor)

    def render_events(self, events, sr: int = 44100, min_seconds: float = 0.5,
                      tail: float = 0.3, max_voices: int = 2048,
                      pad_to_bucket: bool = False, as_tensor: bool = False):
        """Render pre-extracted event arrays -- same surface as
        ``synth.render_events`` (the GAN-DES fast path feeds the native
        decoder's event arrays straight in)."""
        cols, nv, end_t = self.events_to_voices(events, sr, max_voices=max_voices)
        return self._render_cols(cols, nv, end_t, sr, min_seconds, tail,
                                 pad_to_bucket, as_tensor)

    def _render_cols(self, cols, nv, end_t, sr, min_seconds, tail, pad_to_bucket, as_tensor):
        from gandes_tpu_torch.music.synth import RENDER_MAX_S
        # reverb-sent voices ring for the Freeverb IR's length (~1 s) past
        # the dry tail: extend the crop so a note ending near the piece end
        # keeps its wet tail
        if any(cols["rev_send"][i] != 0.0 for i in range(nv)):
            tail += len(_freeverb_ir(sr)) / sr
        length_s = min(max(float(end_t) + tail, min_seconds), RENDER_MAX_S)
        L = max(_pow2(int(length_s * sr)), 1 << 15)
        # E and W follow the data (the JAX package's CPU sizing; its fixed
        # accelerator sizes only avoided TPU recompiles)
        E = _voice_bucket(_pow2(nv))
        max_w = (max(cols["dur_s"][:nv]) if nv else 0.25) + MAX_RELEASE_S
        W = _pow2(int(max_w * sr) + 1)

        pad = E - min(nv, E)
        packed = np.zeros((len(_F), E), dtype=np.float32)
        for i, k in enumerate(_F):
            packed[i, :E - pad] = cols[k][:E]
        start_i = np.zeros(E, dtype=np.int32)
        start_i[:E - pad] = cols["start_i"][:E]

        # static toggles: only fonts whose selected zones set a feature's
        # generators pay for it; the others run the exact program without it
        use_filter = any(f > 0.0 for f in cols["fc_hz"][:nv])
        use_lfo = any(cols[k][i] != 0.0
                      for k in ("vib_k", "mod_k", "mod_vol_cb")
                      for i in range(nv))
        use_rev = any(cols["rev_send"][i] != 0.0 for i in range(nv))
        use_cho = any(cols["cho_send"][i] != 0.0 for i in range(nv))
        use_menv = any(cols["menv_k"][i] != 0.0 for i in range(nv))
        # a font whose zones sweep the cutoff (gens 10/11) rides the
        # time-varying filter for ALL its filtered voices
        use_dynfilter = any(cols["menv_fc"][i] != 0.0 or cols["lfo_fc"][i] != 0.0
                            for i in range(nv))
        if use_dynfilter:
            use_filter = False
        rev_ir = (torch.from_numpy(_freeverb_ir(sr)).to(self.device) if use_rev
                  else torch.zeros(1, dtype=torch.float32, device=self.device))
        audio = _render_sf2(self.bank, packed, start_i, rev_ir, L, W, sr,
                            use_filter=use_filter, use_lfo=use_lfo,
                            use_cubic=self.use_cubic,
                            use_rev=use_rev, use_cho=use_cho,
                            use_menv=use_menv, use_dynfilter=use_dynfilter)
        if as_tensor:
            return audio, int(length_s * sr)
        audio = audio.cpu().numpy()
        return audio if pad_to_bucket else audio[: int(length_s * sr)]

# ------------------------------------------------------------- SF2 writer


def build_sf2(path: str, samples: list, instruments: list, presets: list,
              name: str = "gandes-mini", sample_bits: int = 16):
    """Write a minimal valid SoundFont 2 file.

    samples: list of dicts {name, data (float or int16 array), sample_rate,
      original_pitch, loop_start, loop_end (relative to the sample),
      pitch_correction (opt)}.
    instruments: list of dicts {name, zones: [{sample: idx, gens: {oper:
      amount}, mods: [(src, dest, amount, amt_src, trans)], key_lo, key_hi,
      vel_lo, vel_hi}]}. A zone dict WITHOUT the 'sample' key writes a
      global zone (must come first, spec 7.7).
    presets: list of dicts {name, program, bank, zones: [{instrument: idx,
      key_lo...}]}; a zone without 'instrument' is the preset global zone.
    sample_bits: 16 (smpl only) or 24 (float data quantized to s24; the
      upper 16 bits land in smpl, the low bytes in an sm24 chunk, spec 6.2).
    """
    if sample_bits not in (16, 24):
        raise ValueError(f"sample_bits must be 16 or 24, got {sample_bits}")
    smpl_parts = []
    sm24_parts = []
    shdr = b""
    pos = 0
    for s in samples:
        d = np.asarray(s["data"])
        if sample_bits == 24:
            if d.dtype != np.int16:
                s24 = np.clip(np.asarray(d, np.float64) * 8388607.0,
                              -8388608, 8388607).astype(np.int32)
                d = (s24 >> 8).astype("<i2")
                sm24_parts.append((s24 & 0xFF).astype(np.uint8).tobytes()
                                  + b"\0" * 46)
            else:
                sm24_parts.append(b"\0" * (len(d) + 46))
        elif d.dtype != np.int16:
            d = np.clip(np.asarray(d, np.float64) * 32767.0, -32768, 32767).astype("<i2")
        smpl_parts.append(d.tobytes() + b"\0" * 92)  # 46 zero words guard
        n = len(d)
        shdr += struct.pack(
            "<20sIIIIIBbHH", s["name"].encode()[:20], pos, pos + n,
            pos + s.get("loop_start", 0), pos + s.get("loop_end", n),
            s["sample_rate"], s.get("original_pitch", 60),
            s.get("pitch_correction", 0), 0, 1)
        pos += n + 46
    shdr += struct.pack("<20sIIIIIBbHH", b"EOS", 0, 0, 0, 0, 0, 0, 0, 0, 0)

    def zone_bytes(zones, terminal_oper, terminal_key):
        """Per-zone (gen_ndx, mod_ndx) bag records (chunk-local, no
        terminal) + this chunk's gen and mod record bytes. A zone dict's
        optional 'mods' is a list of (src, dest, amount, amt_src, trans)
        tuples (spec 7.4/7.8 sfModList fields)."""
        records, gen, mod = [], b"", b""
        g_count = m_count = 0
        for z in zones:
            records.append((g_count, m_count))
            opers = []
            if (z.get("key_lo", 0), z.get("key_hi", 127)) != (0, 127):
                opers.append((G_KEY_RANGE, z.get("key_lo", 0) | (z.get("key_hi", 127) << 8)))
            if (z.get("vel_lo", 0), z.get("vel_hi", 127)) != (0, 127):
                opers.append((G_VEL_RANGE, z.get("vel_lo", 0) | (z.get("vel_hi", 127) << 8)))
            for oper, amt in z.get("gens", {}).items():
                opers.append((oper, amt & 0xFFFF))
            if terminal_key in z:
                opers.append((terminal_oper, z[terminal_key]))
            # else: a GLOBAL zone (first zone without sampleID/instrument)
            for oper, amt in opers:
                gen += struct.pack("<HH", oper, amt)
            g_count += len(opers)
            for src, dest, amount, amt_src, trans in z.get("mods", []):
                mod += struct.pack("<HHhHH", src, dest, amount, amt_src, trans)
            m_count += len(z.get("mods", []))
        return records, gen, mod

    ibag = igen = imod = inst = b""
    bag_n = 0
    for k, i in enumerate(instruments):
        inst += struct.pack("<20sH", i["name"].encode()[:20], bag_n)
        records, g, m = zone_bytes(i["zones"], G_SAMPLE_ID, "sample")
        base_gen, base_mod = len(igen) // 4, len(imod) // 10
        ibag += b"".join(struct.pack("<HH", gi + base_gen, mi + base_mod)
                         for gi, mi in records)
        igen += g
        imod += m
        bag_n += len(records)
    inst += struct.pack("<20sH", b"EOI", bag_n)
    ibag += struct.pack("<HH", len(igen) // 4, len(imod) // 10)
    igen += struct.pack("<HH", 0, 0)
    imod += b"\0" * 10  # terminal record

    pbag = pgen = pmod = phdr = b""
    bag_n = 0
    for p in presets:
        phdr += struct.pack("<20sHHHIII", p["name"].encode()[:20],
                            p["program"], p.get("bank", 0), bag_n, 0, 0, 0)
        records, g, m = zone_bytes(p["zones"], G_INSTRUMENT, "instrument")
        base_gen, base_mod = len(pgen) // 4, len(pmod) // 10
        pbag += b"".join(struct.pack("<HH", gi + base_gen, mi + base_mod)
                         for gi, mi in records)
        pgen += g
        pmod += m
        bag_n += len(records)
    phdr += struct.pack("<20sHHHIII", b"EOP", 0, 0, bag_n, 0, 0, 0)
    pbag += struct.pack("<HH", len(pgen) // 4, len(pmod) // 10)
    pgen += struct.pack("<HH", 0, 0)
    pmod += b"\0" * 10  # terminal record

    def chunk(cid, body):
        pad = b"\0" if len(body) & 1 else b""
        return cid + struct.pack("<I", len(body)) + body + pad

    smpl = b"".join(smpl_parts)
    info = b"INFO" + chunk(b"ifil", struct.pack("<HH", 2, 1)) + \
        chunk(b"isng", b"EMU8000\0") + chunk(b"INAM", name.encode() + b"\0")
    sdta = b"sdta" + chunk(b"smpl", smpl)
    if sample_bits == 24:
        sdta += chunk(b"sm24", b"".join(sm24_parts))
    pdta = (b"pdta" + chunk(b"phdr", phdr) + chunk(b"pbag", pbag)
            + chunk(b"pmod", pmod) + chunk(b"pgen", pgen)
            + chunk(b"inst", inst) + chunk(b"ibag", ibag)
            + chunk(b"imod", imod) + chunk(b"igen", igen)
            + chunk(b"shdr", shdr))
    body = b"sfbk" + chunk(b"LIST", info) + chunk(b"LIST", sdta) + chunk(b"LIST", pdta)
    with open(path, "wb") as f:
        f.write(chunk(b"RIFF", body))
    return path
