"""Music stack: MIDI codec, log->MIDI generators, piano rolls, beats, the
additive and SF2 synths, mel spectrograms (torch).

The names of ``gandes_tpu/music/__init__.py`` resolve lazily (PEP 562), so
importing the package loads none of its modules. ``rasterize_events_jax``
is that package's jnp/Pallas rasterizer; the port's counterpart is
``rasterize_events`` (kernel K1 on a CUDA tensor, its plain version on the
CPU), exported under its own name.
"""

_EXPORTS = {
    "Message": "gandes_tpu_torch.music.midi",
    "MetaMessage": "gandes_tpu_torch.music.midi",
    "MidiFile": "gandes_tpu_torch.music.midi",
    "MidiTrack": "gandes_tpu_torch.music.midi",
    "generate_piano_roll": "gandes_tpu_torch.music.piano_roll",
    "rasterize_events": "gandes_tpu_torch.music.piano_roll",
    "midi_to_events": "gandes_tpu_torch.music.piano_roll",
    "get_beats": "gandes_tpu_torch.music.beats",
    "LogLineProcessor": "gandes_tpu_torch.music.generators",
    "MidiGeneratorV0": "gandes_tpu_torch.music.generators",
    "MidiGeneratorV1": "gandes_tpu_torch.music.generators",
    "MidiGeneratorV2": "gandes_tpu_torch.music.generators",
    "process_adjsim_log_v0": "gandes_tpu_torch.music.generators",
    "process_adjsim_log_v1": "gandes_tpu_torch.music.generators",
    "process_adjsim_log_v2": "gandes_tpu_torch.music.generators",
    "melspectrogram_db": "gandes_tpu_torch.music.mel",
    "melspectrogram_db_from_file": "gandes_tpu_torch.music.mel",
    "melspectrogram_db_ref_max": "gandes_tpu_torch.music.mel",
    "melspectrogram_db_tensor": "gandes_tpu_torch.music.mel",
    "melspectrogram_db_tensor_from_file": "gandes_tpu_torch.music.mel",
    "melspectrogram_power_tensor": "gandes_tpu_torch.music.mel",
    "FluidSynth": "gandes_tpu_torch.music.synth",
    "midi_to_audio_fluidsynth": "gandes_tpu_torch.music.synth",
    "render_midi": "gandes_tpu_torch.music.synth",
    "Sf2Font": "gandes_tpu_torch.music.sf2",
    "Sf2Synth": "gandes_tpu_torch.music.sf2",
    "build_sf2": "gandes_tpu_torch.music.sf2",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'gandes_tpu_torch.music' has no attribute {name!r}")
