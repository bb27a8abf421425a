"""The plain reference that decides ``correct``. It imports neither the port
nor the JAX package.

Independent of the code under test: the generators, the discriminator's
step and the mel (``models.py``, ``mel.py``: plain ``torch.nn.functional``
and ``torch.stft``), and the DES as the Python engine beside the port's C++
core. Frozen snapshots, held exactly: the event-log and MIDI codecs, the
log-to-MIDI generators, the piano roll, the beat grid, the samplers and the
matrix decoders are copies of the JAX package's pure-Python host code, which
the port shares line for line; the additive synth is a copy of the port's.
A comparison with a snapshot catches a later change of the port's output,
not a fault that both already have.
"""
