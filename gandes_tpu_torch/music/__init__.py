"""Music stack: MIDI codec, log->MIDI generators, host piano rolls, beats,
the additive synth and mel spectrograms (torch)."""
