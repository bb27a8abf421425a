"""The GAN-DES request's DES, MIDI and synth, for the benchmark's plain
reference (the decoders of ``decode.py``, the frozen generators and the
frozen additive synth)."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from portbench.reference.decode import _decode_gandes_sample, _python_sim
from portbench.reference.generators import process_adjsim_log_v1
from portbench.reference.synth import render_midi


def gandes_render(matrix, seed: int, device, size=20, number_of_customers=1000,
                  sample_rate=44100):
    """One GAN-DES request of ``n = 1``: the global RNG seeded with ``seed``,
    the matrix decoded, the sim run, its log decoded to MIDI (v1) and
    rendered by the additive synth on ``device``. Returns (the WAV's int16
    samples as the service writes them, the int16 round trip of the whole
    power-of-two buffer as float32 on ``device``, the mel's input)."""
    num_aug = 5
    np.random.seed(seed)
    sim_matrix, distributions, instruments, note_levels = _decode_gandes_sample(
        np.asarray(matrix), size, num_aug, None)
    np.random.seed(np.random.randint(0, 99999, size=1))
    seeds = np.random.randint(0, 99999, size=1)
    sim = _python_sim(sim_matrix, distributions, size - num_aug, seeds)
    sim.run(number_of_customers=number_of_customers)
    with tempfile.TemporaryDirectory() as tmp:
        _, mid = process_adjsim_log_v1(instruments=instruments, note_levels=note_levels,
                                       lines=sim.music_lines(),
                                       out_path=os.path.join(tmp, "midi", "output.mid"),
                                       return_mid=True)
    audio, true_len = render_midi(mid, sr=sample_rate, as_tensor=True, device=device)
    wav = (np.clip(audio[:true_len].cpu().numpy(), -1.0, 1.0) * 32767.0).astype(np.int16)
    q = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16).to(torch.float32) / 32768.0
    return wav, q
