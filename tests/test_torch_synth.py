"""gandes_tpu_torch additive synth vs the JAX package's (CPU branch).

Same event arrays in, audio within 1e-5 and the same bucketed length and
true length out. The renders hold more than EVENT_BLOCK (32) events: XLA
folds a single-block render's frequency constants in another order, which
moves the float32 phase (up to ~1e5 rad) by an ulp and the samples by
~2e-5; every render of a GAN-DES MIDI has hundreds of events.
"""

import os

import numpy as np
import pytest
import torch

from gandes_tpu.music import synth as jax_synth
from gandes_tpu.music.generators import process_adjsim_log_v1 as jax_process_v1
from gandes_tpu.music.midi import MidiFile as JaxMidiFile
from gandes_tpu_torch.music import synth
from gandes_tpu_torch.music.generators import process_adjsim_log_v1
from gandes_tpu_torch.music.midi import MidiFile

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    timing-sensitive tests elsewhere need their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(n=200, seed=0, span_s=8.0):
    rng = np.random.RandomState(seed)
    ons = np.sort(rng.uniform(0, span_s, n))
    offs = ons + rng.uniform(0.02, 2.5, n)
    notes = rng.randint(21, 109, n)
    vels = rng.randint(1, 128, n)
    progs = rng.randint(0, 128, n)
    pad = lambda a, d: np.concatenate([a, np.full(1024 - n, d)])
    return (pad(notes, 0).astype(np.int32), pad(vels, 0).astype(np.float32),
            pad(ons, 0.0).astype(np.float32), pad(offs, 0.0).astype(np.float32),
            pad(progs, 0).astype(np.int32), n, float(offs.max()))


def _compare(events):
    ref, ref_len = jax_synth.render_events(events, as_jax=True)
    ours, our_len = synth.render_events(events, as_tensor=True, device="cpu")
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and our_len == ref_len
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)
    cropped = synth.render_events(events, device="cpu")
    np.testing.assert_allclose(cropped, np.asarray(jax_synth.render_events(events)), atol=ATOL)
    assert len(cropped) == ref_len
    return ours


def test_render_events_matches_jax():
    audio = _compare(_events())
    assert float(audio.abs().max()) > 0.05  # the render is not silent


def test_render_events_peak_normalised_matches_jax():
    # dense chords push the sum past 1.0: the render divides by its peak
    events = _events(n=600, seed=1, span_s=1.0)
    audio = _compare(events)
    assert 0.99 < float(audio.abs().max()) <= 1.0


def test_render_midi_of_v1_generator_matches_jax(tmp_path):
    """A MIDI written by the copied log->MIDI generator renders like the JAX
    package's, and both generators write the same bytes."""
    rng = np.random.RandomState(2)
    lines, t = [], 0.0
    for i in range(400):
        t += float(rng.exponential(0.05))
        kind = "arrival" if i % 2 == 0 else "departure"
        lines.append(f"INFO:root:{t} - {i // 2} - {int(rng.randint(0, 15))} - {kind}")
    inst = np.arange(15) * 3.0
    levels = rng.randint(30, 100, 15).astype(float)
    ours_path, mid = process_adjsim_log_v1(instruments=inst, note_levels=levels, lines=lines,
                                           out_path=str(tmp_path / "a" / "o.mid"),
                                           return_mid=True)
    ref_path = jax_process_v1(instruments=inst, note_levels=levels, lines=lines,
                              out_path=str(tmp_path / "b" / "o.mid"))
    with open(ours_path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    ours, our_len = synth.render_midi(mid, as_tensor=True, device="cpu")
    ref, ref_len = jax_synth.render_midi(JaxMidiFile(ref_path), as_jax=True)
    assert our_len == ref_len and ours.shape[0] == np.asarray(ref).shape[0]
    assert synth.midi_to_event_arrays(MidiFile(ours_path), 1024)[5] > synth.EVENT_BLOCK
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_note_frequencies_are_the_jax_packages():
    import jax.numpy as jnp

    notes = jnp.arange(128).astype(jnp.float32)
    freqs = np.asarray(440.0 * jnp.exp2((notes - 69.0) / 12.0))
    np.testing.assert_allclose(synth._NOTE_OMEGA / np.float32(2 * np.pi), freqs, rtol=1e-6)
    x = np.random.RandomState(0).uniform(-80, 80, 100000).astype(np.float32)
    np.testing.assert_array_equal(synth._exp_f32(x), np.asarray(jnp.exp(jnp.asarray(x))))


def test_sound_font_resolution(tmp_path):
    events = _events(n=40)
    # the reference's default font name, absent, means the additive synth
    a = synth.render_events(events, device="cpu", sound_font="FluidR3_GM.sf2")
    np.testing.assert_array_equal(a, synth.render_events(events, device="cpu"))
    with pytest.raises(FileNotFoundError):
        synth.render_events(events, device="cpu", sound_font=str(tmp_path / "typo.sf2"))
    sf2 = tmp_path / "font.sf2"
    sf2.write_bytes(b"RIFF")
    with pytest.raises(NotImplementedError, match="SF2"):
        synth.render_events(events, device="cpu", sound_font=str(sf2))


def test_render_is_deterministic_and_on_the_requested_device():
    events = _events(n=100, seed=3)
    a, _ = synth.render_events(events, as_tensor=True, device="cpu")
    b, _ = synth.render_events(events, as_tensor=True, device=torch.device("cpu"))
    assert a.device.type == "cpu"
    torch.testing.assert_close(a, b, rtol=0, atol=0)
