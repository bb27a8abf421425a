"""Standalone random-matrix -> simulation -> WAV demo (PyTorch).

Port of ``gandes_tpu/bridge/sim_demo.py``, an API-compatible
re-implementation of ``sim_to_wav``
(`SIMULATOR/simulation_to_wav.py:7-97`): build (or accept) an augmented
adjacency matrix, decode it (instrument/note rows scaled by 127, source
dists normal(10m, 5m), server dists normal(3m, 2m), queue caps 127), run
the DES in 'Music' mode, decode the log with the v0 MIDI generator
(program_change around every note pair), and render WAV — here through the
port's synth instead of FluidSynth: SF2 sample playback when
``sound_font`` names an existing font, the additive synth when it is the
reference's default name ``FluidR3_GM.sf2`` and that file is absent; any
other missing path raises. The render runs on ``device`` (default
``"cuda"``).

Decode quirks preserved: rows are normalized *without* NaN cleanup or row
repair (zero rows become NaN rows, which the routing operator prunes into
sinks); the source fallback test checks ``len(sources)`` on the np.where
*tuple* (always 1) so it never fires (reference :26-27).
"""

from __future__ import annotations

import os

import numpy as np

from gandes_tpu_torch.data.audio import save_wav
from gandes_tpu_torch.des.engine import Sim
from gandes_tpu_torch.music.generators import process_adjsim_log_v0
from gandes_tpu_torch.music.synth import render_midi


def sim_to_wav(matrices=(None,), size=32, use_same_instrument=None,
               sound_font="FluidR3_GM.sf2", *, log_path="logs/",
               out_dir="adj_sim_outputs", sample_rate=44100, render=True,
               device="cuda"):
    num_aug = 5
    outputs = []

    for index, matrix in enumerate(matrices):
        if matrix is None:
            matrix = np.random.rand(size, size)
            matrix[size - num_aug:, :] = 0
            matrix[:, size - num_aug:] = 0
            for r in range(5):
                matrix[size - num_aug + r, : size - num_aug] = np.random.rand(size - num_aug)
        else:
            matrix = np.asarray(matrix, dtype=np.float64)

        sources = np.where(matrix[size - num_aug] > 0.75)
        if len(sources) == 0:  # pragma: no cover - reference quirk: never true
            sources = np.random.choice(size - num_aug, size=size // 8, replace=False)

        instruments = np.zeros(size - num_aug)
        if use_same_instrument is None:
            for i in range(size - num_aug):
                instruments[i] = int(matrix[size - num_aug + 1, i] * 127)
        else:
            instruments = np.array([use_same_instrument] * (size - num_aug))

        note_levels = np.zeros(size - num_aug)
        for i in range(size - num_aug):
            note_levels[i] = int(matrix[size - num_aug + 2, i] * 127)

        distributions = []
        for i in range(size - num_aug):
            if i in sources[0]:
                distributions.append(
                    ["normal", 10 * matrix[size - num_aug + 3, i], 5 * matrix[size - num_aug + 4, i]]
                )
            else:
                distributions.append(
                    ["normal", 3 * matrix[size - num_aug + 3, i], 2 * matrix[size - num_aug + 4, i]]
                )

        for i in sources:
            matrix[:, i] = 0
            matrix[i, i] = 0
        for i in [x for x in np.arange(0, size) if x not in sources[0]]:
            matrix[i][i] = 0

        # reference :64-65: rows normalized with no NaN cleanup
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(size - num_aug):
                matrix[i] = matrix[i] / sum(matrix[i])

        for i in sources:
            matrix[i, i] = 1.0
        for i in [x for x in np.arange(0, size - num_aug) if x not in sources[0]]:
            matrix[i][i] = -1.0

        queue_list = [127] * size

        np.random.seed(np.random.randint(0, 99999, size=1))
        seeds = np.random.randint(0, 99999, size=1)
        sim_matrix = matrix[: size - num_aug, : size - num_aug]
        sim = Sim(sim_matrix, distributions, queue_list, seeds=seeds, log_path=log_path,
                  generate_log=True, animation=False, record_history=False,
                  logging_mode="Music")
        sim.run(number_of_customers=1000)

        file_path = process_adjsim_log_v0(
            instruments=instruments, note_levels=note_levels,
            lines=sim.music_lines(),
            out_path=os.path.join(out_dir, "midi", "output.mid"),
        )

        if not render:  # MIDI-only mode: dataset builders that window the
            # .mid don't need the synth pass at all
            outputs.append(file_path)
            continue
        output_file = os.path.join(out_dir, "wav", f"output_{index}.wav")
        os.makedirs(os.path.dirname(output_file), exist_ok=True)
        audio = render_midi(file_path, sr=sample_rate, sound_font=sound_font, device=device)
        save_wav(output_file, audio, sample_rate)
        print("Generated wav file:", output_file)
        outputs.append(output_file)

    return outputs
