"""The port's SF2 sample playback (``gandes_tpu_torch/music/sf2.py``) vs the
JAX package's, on the CPU.

The fonts are the JAX tests' own: the eight golden cases of
``tests/test_sf2_goldens.py`` (built with its ``CASES`` builders) and the
random fonts of ``tests/test_sf2.py::test_sf2_random_font_render_fuzz``
(that test is run with its ``Sf2Synth`` replaced by a recorder that keeps
the font, the MIDI and the JAX render). Same font and MIDI in, then:

* the parse (samples, instruments, presets, the bank), ``select_voices``
  over a key/velocity grid and ``events_to_voices``' columns are equal;
* renders agree within atol 2e-5 where no FFT runs and 1e-4 where one does
  (the static or swept filter, the reverb). The port fuses the position
  ramp's multiply-adds as XLA's CPU program does (``sf2._fma``); the rest
  differs from XLA by an ulp here and there (``10**x`` and ``log10`` in
  ~2 % and ~30 % of values, an rfft/irfft round trip by ~1e-6), measured at
  most 8.9e-6 on the eight goldens. A gate that compares such a value
  (``in_range``, ``rel_db < 96``, ``env > 0``, the loop fold) can flip at
  a single sample and move it by more than the tolerance, so samples past
  it are counted and held to at most 1e-4 of the clip;
* each golden case's coarse statistics (RMS, peak, onset, band energies)
  hold within ``tests/goldens/sf2_goldens.json``'s tolerances (the PCM hash
  pins XLA's bits and is not compared);
* the entry points with ``sound_font``: ``synth.render_events`` /
  ``render_midi``, the ``FluidSynth`` facade, ``matrix_to_wav`` (sequential
  and two sim threads; mels at 0.05 dB above the floor), the GAN-DES
  datasets, ``eval-metrics --family gandes``, ``sim-to-wav --device cpu``
  (MIDI bytes equal, WAV within one int16 step) and one ``train_gandes``
  step against the JAX loop.
"""

import dataclasses
import os
import random

import numpy as np
import pytest
import test_sf2 as jax_sf2_tests
import test_sf2_goldens as goldens
import torch
from test_torch_gandes_train import (
    _assert_mels_close,
    _batches,
    _jax_draws,
    _loop_cfg,
    _port_state,
    _recording,
    jax_setup,  # noqa: F401  (the module-scoped JAX state fixture)
)

import chip_smoke
from gandes_tpu import cli as jax_cli
from gandes_tpu.bridge.gandes_decode import matrix_to_wav as jax_matrix_to_wav
from gandes_tpu.data import datasets as jax_datasets
from gandes_tpu.des import native as jax_native
from gandes_tpu.music import sf2 as jax_sf2
from gandes_tpu.music import synth as jax_synth
from gandes_tpu.train import gandes_loop as jax_loop
from gandes_tpu.train import steps as jax_steps
from gandes_tpu_torch import cli
from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
from gandes_tpu_torch.data import datasets
from gandes_tpu_torch.data.audio import load_wav
from gandes_tpu_torch.des import native
from gandes_tpu_torch.music import sf2, synth
from gandes_tpu_torch.music.midi import MidiFile
from gandes_tpu_torch.train import gandes_loop

ATOL, ATOL_FFT = 2e-5, 1e-4
MAX_FLIP_SHARE = 1e-4
FUZZ_SEEDS = range(5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _des_libs_loaded():
    """Both packages' native DES cores are loaded before any sim runs."""
    assert jax_native.get_lib() is not None
    assert native.get_lib() is not None


def _atol(cols, nv):
    return ATOL_FFT if chip_smoke._sf2_uses_fft(cols, nv) else ATOL


def _assert_render_close(ours, ref, atol, where):
    """Equal lengths; samples past ``atol`` (gate flips) counted and held to
    ``MAX_FLIP_SHARE`` of the clip."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, where
    assert np.all(np.isfinite(ours)), where
    flips = int(np.count_nonzero(np.abs(ours - ref) > atol))
    assert flips <= MAX_FLIP_SHARE * ours.size, (
        f"{where}: {flips} samples past {atol}, max {np.abs(ours - ref).max()}")


def _save_midi(jax_midi, path):
    jax_midi.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def golden_fonts(tmp_path_factory):
    """{case: (font path, MIDI path, notes)} for the golden cases."""
    d = tmp_path_factory.mktemp("sf2_goldens")
    out = {}
    for name, (build, notes) in sorted(goldens.CASES.items()):
        path = str(d / f"{name}.sf2")
        build(path)
        out[name] = (path, _save_midi(goldens._midi(notes), d / f"{name}.mid"), notes)
    return out


@pytest.fixture(scope="module")
def fuzz_fonts(tmp_path_factory):
    """{seed: (font path, MIDI path, render kwargs, JAX audio)}: the JAX fuzz
    test run with a recorder in place of its ``Sf2Synth``."""
    out = {}
    for seed in FUZZ_SEEDS:
        d = tmp_path_factory.mktemp(f"sf2_fuzz_{seed}")
        calls = []

        class Recorder(jax_sf2.Sf2Synth):
            def __init__(self, path, **kw):
                super().__init__(path, **kw)
                self.path = path

            def render_midi(self, midi, **kw):
                audio = super().render_midi(midi, **kw)
                calls.append((self.path, _save_midi(midi, d / "fuzz.mid"), kw, audio))
                return audio

        mp = pytest.MonkeyPatch()
        mp.setattr(jax_sf2_tests, "Sf2Synth", Recorder)
        try:
            jax_sf2_tests.test_sf2_random_font_render_fuzz(d, seed)
        finally:
            mp.undo()
        assert len(calls) == 1
        out[seed] = calls[0]
    return out


def _all_fonts(golden_fonts, fuzz_fonts):
    return ([p for p, _, _ in golden_fonts.values()]
            + [p for p, _, _, _ in fuzz_fonts.values()])


# ------------------------------------------------------------------ parsing


def test_parse_and_select_voices_match_jax(golden_fonts, fuzz_fonts):
    for path in _all_fonts(golden_fonts, fuzz_fonts):
        ours, ref = sf2.Sf2Font(path), jax_sf2.Sf2Font(path)
        assert ours.bank.dtype == np.float32
        np.testing.assert_array_equal(ours.bank, ref.bank)
        assert ([dataclasses.asdict(s) for s in ours.samples]
                == [dataclasses.asdict(s) for s in ref.samples])
        assert ([dataclasses.asdict(i) for i in ours.instruments]
                == [dataclasses.asdict(i) for i in ref.instruments])
        assert ({k: dataclasses.asdict(p) for k, p in ours.presets.items()}
                == {k: dataclasses.asdict(p) for k, p in ref.presets.items()})
        for program in (0, 5):
            for key in range(0, 128, 9):
                for vel in (1, 40, 64, 100, 127):
                    assert (ours.select_voices(program, key, vel)
                            == ref.select_voices(program, key, vel)), (path, key, vel)


def test_parse_24_bit_and_gm_scale_fonts_match_jax(tmp_path):
    """An sm24 bank (spec 6.2) and a 16-program, velocity-layered, stereo
    font parse to the same bank and voices."""
    t = np.arange(3000)
    data = (0.4 * np.sin(2 * np.pi * t / 37.0)).astype(np.float32)
    p24 = str(tmp_path / "s24.sf2")
    sf2.build_sf2(p24, samples=[{"name": "s", "data": data, "sample_rate": 22050,
                                 "original_pitch": 60, "loop_start": 100, "loop_end": 2900}],
                  instruments=[{"name": "i", "zones": [{"sample": 0, "gens": {
                      sf2.G_SAMPLE_MODES: 1}}]}],
                  presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}],
                  sample_bits=24)
    ref_path = str(tmp_path / "s24_jax.sf2")
    jax_sf2.build_sf2(ref_path, samples=[{"name": "s", "data": data, "sample_rate": 22050,
                                          "original_pitch": 60, "loop_start": 100,
                                          "loop_end": 2900}],
                      instruments=[{"name": "i", "zones": [{"sample": 0, "gens": {
                          jax_sf2.G_SAMPLE_MODES: 1}}]}],
                      presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}],
                      sample_bits=24)
    with open(p24, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()  # the copied writer writes the same bytes
    np.testing.assert_array_equal(sf2.Sf2Font(p24).bank, jax_sf2.Sf2Font(p24).bank)

    gm = str(tmp_path / "gm.sf2")
    rng = np.random.RandomState(0)
    samples, instruments, presets = [], [], []
    for p in range(16):
        base = rng.randn(400).astype(np.float32) * 0.2
        samples += [{"name": f"p{p}{s}", "data": d, "sample_rate": 44100, "original_pitch": 60}
                    for s, d in (("L", base), ("R", -base), ("loud", base * 2))]
        instruments.append({"name": f"inst{p}", "zones": [
            {"sample": 3 * p, "vel_lo": 0, "vel_hi": 80},
            {"sample": 3 * p + 1, "vel_lo": 0, "vel_hi": 80},
            {"sample": 3 * p + 2, "vel_lo": 81, "vel_hi": 127}]})
        presets.append({"name": f"prog{p}", "program": p, "zones": [{"instrument": p}]})
    sf2.build_sf2(gm, samples=samples, instruments=instruments, presets=presets)
    ours, ref = sf2.Sf2Font(gm), jax_sf2.Sf2Font(gm)
    for p in (0, 7, 15, 99):
        for vel in (50, 120):
            assert ours.select_voices(p, 60, vel) == ref.select_voices(p, 60, vel)


def test_malformed_fonts_raise_as_jax(tmp_path):
    """``tests/test_sf2.py::test_malformed_sf2_fails_cleanly``'s three
    corruptions raise the same ValueError in both packages."""
    import struct

    bogus = tmp_path / "bogus.sf2"
    bogus.write_bytes(b"not a riff file at all, just junk bytes" * 4)
    good = str(tmp_path / "good.sf2")
    t = np.arange(2000) / 44100.0
    sf2.build_sf2(good, samples=[dict(name="s", data=np.sin(2 * np.pi * 440 * t),
                                      sample_rate=44100, original_pitch=69,
                                      loop_start=100, loop_end=1900)],
                  instruments=[dict(name="i", zones=[dict(sample=0, gens={})])],
                  presets=[dict(name="p", program=0, bank=0, zones=[dict(instrument=0)])])
    data = open(good, "rb").read()
    trunc = tmp_path / "trunc.sf2"
    trunc.write_bytes(data[: len(data) // 2])
    pos = data.index(b"pbag")
    (size,) = struct.unpack_from("<I", data, pos + 4)
    bad = bytearray(data)
    recs = struct.pack("<HH", 0, 0) + struct.pack("<HH", 60000, 0) * (size // 4 - 1)
    bad[pos + 8:pos + 8 + size] = recs[:size]
    badf = tmp_path / "badbag.sf2"
    badf.write_bytes(bytes(bad))
    for path, match in ((bogus, "not a SoundFont"), (trunc, "missing required SF2 chunk"),
                        (badf, "malformed SF2 hydra")):
        with pytest.raises(ValueError, match=match) as ours:
            sf2.Sf2Font(str(path))
        with pytest.raises(ValueError, match=match) as ref:
            jax_sf2.Sf2Font(str(path))
        assert str(ours.value) == str(ref.value)


def test_events_to_voices_columns_match_jax(golden_fonts, fuzz_fonts):
    """Extracted events and the voice columns (exclusive-class chokes and the
    note-boundary voice cap included) are equal."""
    cases = [(p, m) for p, m, _ in golden_fonts.values()]
    cases += [(p, m) for p, m, _, _ in fuzz_fonts.values()]
    for path, midi_path in cases:
        ours, ref = sf2.Sf2Synth(path, device="cpu"), jax_sf2.Sf2Synth(path)
        for sr, max_voices in ((22050, 2048), (44100, 3)):
            got = ours.midi_to_voices(midi_path, sr, max_voices=max_voices, max_events=1024)
            want = ref.midi_to_voices(midi_path, sr, max_voices=max_voices, max_events=1024)
            assert got == want, (path, sr, max_voices)


# ------------------------------------------------------------------ renders


@pytest.mark.parametrize("name", sorted(goldens.CASES))
def test_golden_render_matches_jax_and_the_committed_stats(golden_fonts, name):
    path, midi_path, notes = golden_fonts[name]
    ours_synth = sf2.Sf2Synth(path, device="cpu")
    ours = ours_synth.render_midi(MidiFile(midi_path), sr=goldens.SR, min_seconds=1.0)
    ref = np.asarray(jax_sf2.Sf2Synth(path).render_midi(goldens._midi(notes), sr=goldens.SR,
                                                         min_seconds=1.0))
    cols, nv, _ = ours_synth.midi_to_voices(midi_path, goldens.SR)
    _assert_render_close(ours, ref, _atol(cols, nv), name)

    golden = goldens._load_goldens()[name]
    got = goldens._measure(ours)
    assert got["n"] == golden["n"] and got["onset"] == golden["onset"]
    np.testing.assert_allclose(got["rms"], golden["rms"], rtol=5e-3)
    np.testing.assert_allclose(got["peak"], golden["peak"], rtol=5e-3)
    np.testing.assert_allclose(got["bands"], golden["bands"], rtol=2e-2)


@pytest.mark.parametrize("name", ["plain_loop", "layers_exclusive", "full_matrix"])
def test_linear_interpolation_matches_jax(golden_fonts, name):
    path, midi_path, notes = golden_fonts[name]
    ours_synth = sf2.Sf2Synth(path, interp="linear", device="cpu")
    ours, n = ours_synth.render_midi(MidiFile(midi_path), sr=goldens.SR, as_tensor=True)
    ref, ref_n = jax_sf2.Sf2Synth(path, interp="linear").render_midi(
        goldens._midi(notes), sr=goldens.SR, as_jax=True)
    assert n == ref_n and ours.device.type == "cpu"
    cols, nv, _ = ours_synth.midi_to_voices(midi_path, goldens.SR)
    _assert_render_close(ours.numpy(), np.asarray(ref), _atol(cols, nv), name)
    # at the root key the phase is integral and both weights pass the samples
    # through; elsewhere the two interpolations differ
    cubic = sf2.Sf2Synth(path, device="cpu").render_midi(MidiFile(midi_path), sr=goldens.SR)
    assert np.array_equal(cubic, ours.numpy()[:len(cubic)]) == (name == "plain_loop")


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_font_render_matches_jax(fuzz_fonts, seed):
    path, midi_path, kw, ref = fuzz_fonts[seed]
    ours_synth = sf2.Sf2Synth(path, device="cpu")
    ours = ours_synth.render_midi(MidiFile(midi_path), **kw)
    cols, nv, _ = ours_synth.midi_to_voices(midi_path, kw["sr"])
    _assert_render_close(ours, ref, _atol(cols, nv), f"seed {seed}")
    assert np.abs(ours).max() > 1e-5


def test_toggles_off_run_the_program_without_the_feature(tmp_path):
    """Zero-amount filter, LFO, mod-env, sweep and send generators select no
    feature, and the render equals the plain font's bit for bit."""
    notes = [(60, 100, 0.0, 0.6), (64, 90, 0.2, 0.9)]
    mid = _save_midi(goldens._midi(notes), tmp_path / "n.mid")
    base = {sf2.G_SAMPLE_MODES: 1, sf2.G_HOLD_VOL: 2786}
    zero = {**base, **{sf2.G_VIB_LFO_TO_PITCH: 0, sf2.G_MOD_LFO_TO_VOL: 0,
                         sf2.G_MOD_LFO_TO_PITCH: 0, sf2.G_MOD_ENV_TO_PITCH: 0,
                         sf2.G_MOD_ENV_TO_FILTER_FC: 0, sf2.G_MOD_LFO_TO_FILTER_FC: 0,
                         sf2.G_REVERB_SEND: 0, sf2.G_CHORUS_SEND: 0,
                         sf2.G_INITIAL_FILTER_FC: 13500}}
    renders = []
    for i, gens in enumerate((base, zero)):
        path = str(tmp_path / f"f{i}.sf2")
        sf2.build_sf2(path, samples=[{"name": "s", "data": goldens._sine(2000, 50),
                                      "sample_rate": 22050, "original_pitch": 60,
                                      "loop_start": 200, "loop_end": 1800}],
                      instruments=[{"name": "i", "zones": [{"sample": 0, "gens": gens}]}],
                      presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}])
        renders.append(sf2.Sf2Synth(path, device="cpu").render_midi(mid, sr=22050))
    np.testing.assert_array_equal(renders[0], renders[1])


def test_bank_above_2_pow_24_samples(tmp_path):
    """A voice whose sample starts past 2^24 bank samples (past exact float32
    indexing) renders bit for bit as the same sample at the bank's start:
    positions are start-relative and the index is int64."""
    data = goldens._sine(3000, 37, 0.4)
    zone = {"sample": 0, "gens": {sf2.G_SAMPLE_MODES: 1, sf2.G_HOLD_VOL: 2786,
                                  sf2.G_VIB_LFO_TO_PITCH: 60}}
    spec = {"name": "s", "data": data, "sample_rate": 22050, "original_pitch": 60,
            "loop_start": 300, "loop_end": 2700}
    small, big = str(tmp_path / "small.sf2"), str(tmp_path / "big.sf2")
    preset = [{"name": "p", "program": 0, "zones": [{"instrument": 0}]}]
    sf2.build_sf2(small, samples=[spec], instruments=[{"name": "i", "zones": [zone]}],
                  presets=preset)
    filler = {"name": "pad", "data": np.zeros((1 << 24) + 1000, np.int16),
              "sample_rate": 22050}
    sf2.build_sf2(big, samples=[filler, spec],
                  instruments=[{"name": "i", "zones": [dict(zone, sample=1)]}], presets=preset)
    mid = _save_midi(goldens._midi([(67, 100, 0.0, 0.8)]), tmp_path / "n.mid")
    s_big = sf2.Sf2Synth(big, device="cpu")
    assert s_big.font.samples[1].start > 1 << 24
    a = sf2.Sf2Synth(small, device="cpu").render_midi(mid, sr=22050)
    b = s_big.render_midi(mid, sr=22050)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() > 0.1


def test_reverb_is_the_exact_convolution_of_its_bus(tmp_path):
    """The reverb's FFT convolution against float64 numpy's: a reverb-only
    font's render minus the same font's without the send is the IR
    convolved with the send-weighted dry render, within 1e-6. (The JAX
    program's reverb departs from it by up to 1.6e-5 on a 48 s GAN-DES clip,
    the port's by 8e-8: reverb-heavy renders are held to JAX at the FFT
    tolerance, and their quietest mel bins can move by ~0.05 dB.)"""
    notes = [(60, 100, 0.0, 0.6), (67, 90, 0.4, 1.4), (72, 80, 1.0, 1.3)]
    mid = _save_midi(goldens._midi(notes), tmp_path / "n.mid")
    out = []
    for send in (0, 400):
        path = str(tmp_path / f"r{send}.sf2")
        sf2.build_sf2(path, samples=[{"name": "s", "data": goldens._sine(2000, 50),
                                      "sample_rate": 22050, "original_pitch": 60,
                                      "loop_start": 200, "loop_end": 1800}],
                      instruments=[{"name": "i", "zones": [{"sample": 0, "gens": {
                          sf2.G_SAMPLE_MODES: 1, sf2.G_HOLD_VOL: 1200,
                          sf2.G_REVERB_SEND: send}}]}],
                      presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}])
        out.append(sf2.Sf2Synth(path, device="cpu").render_midi(mid, sr=22050,
                                                                pad_to_bucket=True))
    # the send extends the crop by the IR's length: the dry render in the
    # wet one's bucket is the dry render and zeros
    wet = out[1].astype(np.float64)
    dry = np.pad(out[0].astype(np.float64), (0, len(wet) - len(out[0])))
    assert np.abs(wet).max() < 1.0  # no peak normalisation
    ir = sf2._freeverb_ir(22050).astype(np.float64)
    n = 1 << int(np.ceil(np.log2(len(dry) + len(ir))))
    exact = np.fft.irfft(np.fft.rfft(dry * np.float32(0.4), n=n) * np.fft.rfft(ir, n=n),
                         n=n)[:len(dry)]
    np.testing.assert_allclose(wet - dry, exact, atol=1e-6)
    assert np.abs(exact).max() > 0.01


def test_notes_past_max_events_render_the_first_ones(golden_fonts, tmp_path):
    """A MIDI of 1,100 notes through a one-voice font: ``midi_to_event_arrays``
    keeps 1,024 notes and counts 1,100; the port renders the first 1,024
    (their voice columns are the JAX package's for the arrays cut to
    1,024), where the JAX package indexes past the arrays."""
    path = golden_fonts["plain_loop"][0]
    notes = [(60, 100, 0.01 * i, 0.01 * i + 0.05) for i in range(1100)]
    mid = _save_midi(goldens._midi(notes), tmp_path / "long.mid")
    events = synth.midi_to_event_arrays(MidiFile(mid), 1024)
    assert events[5] == 1100 and len(events[0]) == 1024
    cut = events[:5] + (1024,) + events[6:]
    ours = sf2.Sf2Synth(path, device="cpu")
    assert ours.events_to_voices(events, 22050) == jax_sf2.Sf2Synth(path).events_to_voices(
        cut, 22050)
    with pytest.raises(IndexError):
        jax_synth.render_midi(mid, sr=22050, sound_font=path)
    audio = synth.render_midi(mid, sr=22050, sound_font=path, device="cpu")
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.1


def test_ragged_voice_capacity_raises():
    assert sf2._voice_bucket(1) == sf2.EVENT_BLOCK and sf2._voice_bucket(33) == 64
    with pytest.raises(ValueError, match="multiple of"):
        sf2._render_sf2(torch.zeros(8), np.zeros((len(sf2._F), 33), np.float32),
                        np.zeros(33, np.int32), torch.zeros(1), 1 << 15, 1 << 10, 22050)


def test_chip_smoke_cases_are_the_goldens(tmp_path):
    """chip_smoke.py writes the golden cases out again (the card's machine
    has no JAX): the same fonts byte for byte, the same notes."""
    assert sorted(chip_smoke.SF2_CASES) == sorted(goldens.CASES)
    for name, (build, notes) in chip_smoke.SF2_CASES.items():
        ours, ref = str(tmp_path / f"{name}_a.sf2"), str(tmp_path / f"{name}_b.sf2")
        build(ours)
        goldens.CASES[name][0](ref)
        with open(ours, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), name
        assert notes == goldens.CASES[name][1]


# ------------------------------------------------------------ entry points


def _events(n=60, seed=0):
    rng = np.random.RandomState(seed)
    ons = np.sort(rng.uniform(0, 1.5, n))
    offs = ons + rng.uniform(0.05, 0.6, n)
    pad = lambda a, d: np.concatenate([a, np.full(1024 - n, d)])
    return (pad(rng.randint(40, 90, n), 0).astype(np.int32),
            pad(rng.randint(30, 128, n), 0).astype(np.float32),
            pad(ons, 0.0).astype(np.float32), pad(offs, 0.0).astype(np.float32),
            pad(np.zeros(n), 0).astype(np.int32), n, float(offs.max()))


def test_synth_dispatch_and_fluidsynth_facade(golden_fonts, tmp_path):
    """``synth.render_events`` / ``render_midi`` with ``sound_font`` render
    through the cached ``Sf2Synth`` of (font, interp, device), as the JAX
    synth does; the ``FluidSynth`` facade and ``midi_to_audio_fluidsynth``
    write the JAX facade's WAVs within one int16 step."""
    path, midi_path, notes = golden_fonts["full_matrix"]
    events = _events()
    ours, n = synth.render_events(events, as_tensor=True, sound_font=path, device="cpu")
    ref, ref_n = jax_synth.render_events(events, as_jax=True, sound_font=path)
    assert n == ref_n
    _assert_render_close(ours.numpy(), np.asarray(ref), ATOL_FFT, "render_events")
    assert synth._get_sf2_synth(path, device="cpu") is synth._get_sf2_synth(path, device="cpu")
    out = synth.render_midi(midi_path, sound_font=path, device="cpu")
    _assert_render_close(out, jax_synth.render_midi(midi_path, sound_font=path), ATOL_FFT,
                         "render_midi")

    for name, fn in (("facade", lambda sf, wav, mod: mod.FluidSynth(sf, sample_rate=22050)
                      .midi_to_audio(midi_path, wav)),
                     ("util", lambda sf, wav, mod: mod.midi_to_audio_fluidsynth(
                         midi_path, wav, sf))):
        a, b = str(tmp_path / f"{name}_ours.wav"), str(tmp_path / f"{name}_jax.wav")
        fn(path, a, _CpuSynth)
        fn(path, b, jax_synth)
        wa, sr = load_wav(a, normalize=False)
        wb, _ = load_wav(b, normalize=False)
        assert sr == 22050 and wa.shape == wb.shape
        assert np.abs(wa.astype(np.int32) - wb.astype(np.int32)).max() <= 1, name
    assert synth.FluidSynth(str(tmp_path / "FluidR3_GM.sf2"), device="cpu")._sf2 is None
    with pytest.raises(FileNotFoundError, match="typo"):
        synth.FluidSynth(str(tmp_path / "typo.sf2"), device="cpu")


class _CpuSynth:
    """The port's facade and helper on the CPU."""

    @staticmethod
    def FluidSynth(sf, sample_rate):
        return synth.FluidSynth(sf, sample_rate=sample_rate, device="cpu")

    @staticmethod
    def midi_to_audio_fluidsynth(midi, wav, sf):
        return synth.midi_to_audio_fluidsynth(midi, wav, sf, device="cpu")


@pytest.mark.parametrize("parallel", [None, 2])
def test_matrix_to_wav_with_a_font_matches_jax(golden_fonts, tmp_path, monkeypatch, parallel):
    """The GAN-DES bridge renders through the font: mels at 0.05 dB above the
    floor (0.5 dB on every bin) against the JAX bridge from the same global
    seed, the same MIDI bytes; the sims end by customer count."""
    path = golden_fonts["full_matrix"][0]
    monkeypatch.chdir(tmp_path)
    os.makedirs("logs")
    mats = np.random.RandomState(0).rand(2, 20, 20).astype(np.float32)
    kw = dict(size=20, start=0, end=216, number_of_customers=60, max_sim_time=60,
              parallel=parallel, sound_font=path)
    np.random.seed(3)
    ours = matrix_to_wav(mats, out_dir="a", device="cpu", **kw)
    np.random.seed(3)
    ref = jax_matrix_to_wav(mats, out_dir="b", **kw)
    assert tuple(ours.shape) == (2, 128, 216) and bool(torch.isfinite(ours).all())
    _assert_mels_close(ours, ref, f"matrix_to_wav parallel={parallel}")
    with open("a/midi/output.mid", "rb") as a, open("b/midi/output.mid", "rb") as b:
        assert a.read() == b.read()
    np.random.seed(3)
    additive = matrix_to_wav(mats, out_dir="c", device="cpu",
                             **dict(kw, sound_font=None))
    assert not np.allclose(ours.numpy(), additive.numpy(), atol=1e-3)


@pytest.fixture(scope="module")
def midi_dir(tmp_path_factory):
    """Two 11 s MIDI files (30 notes each, numpy seeds 1 and 2)."""
    root = tmp_path_factory.mktemp("sf2_midi")
    for i, seed in enumerate((1, 2)):
        rng = np.random.RandomState(seed)
        notes = [(int(rng.randint(48, 80)), int(rng.randint(40, 127)), on, on + 0.4)
                 for on in np.round(np.sort(rng.uniform(0, 11.0, 30)), 3)]
        _save_midi(goldens._midi(notes), root / f"f{i}.mid")
    return root


def test_gandes_datasets_with_a_font_match_jax(golden_fonts, midi_dir):
    """``MaestroDatasetGanDes`` and ``collect_real_mels`` render the real side
    through the font, as the JAX datasets do."""
    path = golden_fonts["full_matrix"][0]
    root = midi_dir
    ours = datasets.MaestroDatasetGanDes(batch_size=2, input_folder=str(root), sound_font=path,
                                         device="cpu")
    ref = jax_datasets.MaestroDatasetGanDes(batch_size=2, input_folder=str(root),
                                            sound_font=path)
    for i in range(2):
        random.seed(i)
        item = ours[i]
        random.seed(i)
        _assert_mels_close(item, ref[i], f"file {i}")
        assert tuple(item.shape) == (2, 128, 216)
    mels, n_files = datasets.collect_real_mels(str(root), 3, sound_font=path, device="cpu")
    ref_mels, ref_files = jax_datasets.collect_real_mels(str(root), 3, sound_font=path)
    assert n_files == ref_files
    _assert_mels_close(mels, ref_mels, "collect_real_mels")


def test_eval_metrics_gandes_with_a_font_matches_jax(golden_fonts, midi_dir, tmp_path,
                                                    monkeypatch, capsys):
    """``eval-metrics --family gandes --sound-font --device cpu`` on one
    checkpoint renders the real slices and the generated clips through the
    font; its real block within the JAX command's tolerances
    (``tests/test_torch_eval.py``) and the JAX command's keys."""
    import json

    from gandes_tpu_torch.train import checkpoint as ckpt

    path = golden_fonts["full_matrix"][0]
    monkeypatch.chdir(tmp_path)
    state = gandes_loop.init_state_for_config(gandes_loop.GanDesConfig(), "cpu")
    model = ckpt.save_gandes_state(str(tmp_path / "gen_1_1.5"), state)
    renders = []
    _recording(monkeypatch, sf2.Sf2Synth, "_render_cols", renders)
    args = ["eval-metrics", "--family", "gandes", "--data", str(midi_dir), "--n", "2",
            "--des-parallel", "2", "--sound-font", path, "--torch-checkpoint"]
    out = {}
    for name, main, extra in (("ours", cli.main, [model, "--device", "cpu"]),
                              ("ref", jax_cli.main, [os.path.join(model, "model.pth")])):
        random.seed(0)
        main(args + extra)
        out[name] = json.loads(capsys.readouterr().out)
        if name == "ours":
            assert len(renders) == 2 + 2  # the two files, the two generated clips
    ours, ref = out["ours"], out["ref"]
    assert ours.keys() == ref.keys() and ours["real"].keys() == ref["real"].keys()
    assert ours["n_real"] == ref["n_real"] == 2
    for k in ("db_mean", "db_std", "flux"):
        assert abs(ours["real"][k] - ref["real"][k]) <= 0.05, k
    assert ours["real"]["centroid"] == pytest.approx(ref["real"]["centroid"], rel=1e-3)
    assert ours["gaps"].keys() == ref["gaps"].keys()


def test_sim_to_wav_cli_matches_jax(golden_fonts, tmp_path, monkeypatch, capsys):
    """``sim-to-wav --device cpu`` writes the JAX command's MIDI bytes and its
    WAV within one int16 step; an absent default font name renders with the
    additive synth, any other missing path raises."""
    path = golden_fonts["lfos_pan"][0]
    monkeypatch.chdir(tmp_path)
    os.makedirs("logs")
    args = ["sim-to-wav", "--sound-font", path, "--size", "10", "--seed", "4"]
    cli.main(args + ["--out-dir", "ours", "--device", "cpu"])
    jax_cli.main(args + ["--out-dir", "ref"])
    assert "ours/wav/output_0.wav" in capsys.readouterr().out
    with open("ours/midi/output.mid", "rb") as a, open("ref/midi/output.mid", "rb") as b:
        assert a.read() == b.read()
    wa, sr = load_wav("ours/wav/output_0.wav", normalize=False)
    wb, _ = load_wav("ref/wav/output_0.wav", normalize=False)
    assert sr == 44100 and wa.shape == wb.shape and len(wa) > 0
    diff = np.abs(wa.astype(np.int32) - wb.astype(np.int32))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= MAX_FLIP_SHARE * wa.size

    cli.main(["sim-to-wav", "--size", "10", "--out-dir", "add", "--device", "cpu"])
    wc, _ = load_wav("add/wav/output_0.wav", normalize=False)
    assert len(wc) > 0
    with pytest.raises(FileNotFoundError):
        cli.main(["sim-to-wav", "--sound-font", "typo.sf2", "--size", "10", "--device", "cpu"])


def test_train_gandes_step_with_a_font_matches_jax(jax_setup, golden_fonts, tmp_path,  # noqa: F811
                                                   monkeypatch):
    """One ``none``-mode step with ``sound_font``: the fake clips render
    through the font in both loops (G's matrices from the JAX loop, as in
    ``tests/test_torch_gandes_train.py::test_loop_histories_match_jax``),
    fake mels within the mel tolerance, the losses at rtol 1e-4.

    The font is ``full_matrix`` (every generator family). A filtered-noise
    font (``filter_q``) leaves the top mel bins ~15 dB above the int16
    quantisation floor, where the few samples that truncate to the other
    int16 step in one package move a bin by up to 0.08 dB (measured): the
    0.05 dB mel tolerance is the additive synth's, set for bins far above
    that floor."""
    path = golden_fonts["full_matrix"][0]
    monkeypatch.chdir(tmp_path)
    batches = _batches(1)
    jax_decodes, decodes = [], []
    monkeypatch.setattr(jax_loop, "init_gandes_state", lambda *a, **k: jax_setup["state"])
    monkeypatch.setattr(jax_steps, "init_surrogate_state", lambda *a, **k: jax_setup["s_state"])
    _recording(monkeypatch, jax_loop, "matrix_to_wav", jax_decodes)
    kw = {"write_wav": False, "sound_font": path}
    np.random.seed(0)
    _, jax_history = jax_loop.train_gandes(iter(batches), _loop_cfg(jax_loop, tmp_path, "jax",
                                                                    **kw))
    monkeypatch.setattr(gandes_loop, "init_state_for_config",
                        lambda cfg, device: _port_state(jax_setup))
    monkeypatch.setattr(gandes_loop, "draw_step_inputs",
                        lambda seed, count, batch, z, device, perturb=False:
                        _jax_draws(seed, count, batch, perturb))
    port_decode = gandes_loop.matrix_to_wav

    def decode_jax_matrices(mats, **kw):
        decodes.append((kw, port_decode(np.asarray(jax_decodes[len(decodes)][0][0]), **kw)))
        return decodes[-1][1]

    monkeypatch.setattr(gandes_loop, "matrix_to_wav", decode_jax_matrices)
    np.random.seed(0)
    _, history = gandes_loop.train_gandes(iter(batches),
                                          _loop_cfg(gandes_loop, tmp_path, "torch", **kw),
                                          device="cpu")
    assert len(decodes) == len(jax_decodes) == 1
    assert decodes[0][0]["sound_font"] == jax_decodes[0][1]["sound_font"] == path
    _assert_mels_close(decodes[0][1], jax_decodes[0][2], "fake mels")
    for key in ("disc", "gen"):
        np.testing.assert_allclose(history[key], jax_history[key], rtol=1e-4, err_msg=key)
