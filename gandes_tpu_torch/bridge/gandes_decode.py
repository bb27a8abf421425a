"""GAN-DES matrix -> DES -> WAV -> mel-spectrogram bridge (PyTorch).

Port of ``gandes_tpu/bridge/gandes_decode.py``, itself an API-compatible
re-implementation of the reference ``matrix_to_wav``
(`GAN_DES/matrix_sim_process.py:17-137`): decode 20x20 matrices (last 5
rows are metadata: source mask, instruments, note levels, distribution
loc/scale), run the seeded DES in 'Music' mode (wall budget 0.5 s, 1000
customers), decode the log to MIDI (v1 generator), synthesize audio, and
return mel-dB spectrograms cropped to [start:end].

Differences from the reference, all deliberate (as in the JAX package):

* FluidSynth is replaced by the port's synth (music/synth.py): the
  additive instrument model, or with ``sound_font`` SF2 sample playback
  (music/sf2.py) — no subprocess; the WAV artifact is still written to
  ``<out_dir>/wav/output_<i>.wav``.
* The reference's source/server membership tests (``i in sources`` against
  a ``np.where`` *tuple*) raise ValueError whenever 2+ sources are
  selected (reference :30,:56 — numpy truth-ambiguity); we implement the
  intended membership over the index array, which is the only semantics
  under which the function runs at all.
* ``overwrite`` is accepted (and ignored): the reference trainer passes it
  (`SIMNN.py:301`) but the reference function lacks it.
* The audio and the mel stay on ``device`` (default ``"cuda"``), where the
  mel runs the hand-written kernel; the result is a tensor there.

Retry semantics preserved: a too-short mel triggers one retry with a fresh
seed, then a blank 5 s clip (reference :97-104).

``parallel > 1`` (fast mode, needs the native engine) decodes every matrix
on the global RNG first, then runs the sims concurrently with private
routing streams, then per clip: ``music/native_decode.py``'s v1 decoder
(the same ``output.mid`` bytes, and the synth's event arrays directly),
the synth, the int16 round trip and the mel on ``device``. Deterministic
given the starting RNG state, but a different stream than the sequential
path's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gandes_tpu_torch.core.profiling import span
from gandes_tpu_torch.data.audio import save_wav, wav_tensor
from gandes_tpu_torch.des import native
from gandes_tpu_torch.des.engine import Sim
from gandes_tpu_torch.music import native_decode
from gandes_tpu_torch.music.generators import process_adjsim_log_v1
from gandes_tpu_torch.music.mel import melspectrogram_db, melspectrogram_db_tensor
from gandes_tpu_torch.music.synth import render_events, render_midi


def _decode_gandes_sample(matrix, size, num_aug, use_same_instrument):
    """Decode one 20x20 matrix -> (sim_matrix, distributions, instruments,
    note_levels) consuming the global RNG exactly as the sequential path."""
    matrix = np.abs(np.asarray(matrix, dtype=np.float64))

    # reference :26 scans the full 20-wide row, so a metadata column
    # > 0.75 yields a source index >= dim and an IndexError at :67 —
    # restricting to the node columns is the only runnable semantics.
    sources_where = np.where(matrix[size - num_aug][: size - num_aug] > 0.75)
    if len(sources_where[0]) == 0:
        sources = np.random.choice(size - num_aug, size=size // 8, replace=False)
    else:
        sources = sources_where[0]

    servers = [x for x in np.arange(0, size - num_aug) if x not in sources]

    instruments = np.zeros(size - num_aug)
    if use_same_instrument is None:
        for i in range(size - num_aug):
            instruments[i] = int(matrix[size - num_aug + 1, i] * 126)
    else:
        instruments = np.array([use_same_instrument] * (size - num_aug))

    note_levels = np.zeros(size - num_aug)
    for i in range(size - num_aug):
        note_levels[i] = int(matrix[size - num_aug + 2, i] * 126)

    matrix[size - num_aug + 3] = matrix[size - num_aug + 3] / sum(matrix[size - num_aug + 3])
    matrix[size - num_aug + 4] = matrix[size - num_aug + 4] / sum(matrix[size - num_aug + 4])

    distributions = []
    for i in range(size - num_aug):
        if i in sources:
            distributions.append(
                ["normal", 30 * matrix[size - num_aug + 3, i], 15 * matrix[size - num_aug + 4, i]]
            )
        else:
            distributions.append(
                ["normal", 5 * matrix[size - num_aug + 3, i], 3 * matrix[size - num_aug + 4, i]]
            )

    dim = size - num_aug
    sim_matrix = matrix[:dim, :dim]
    for i in sources:
        sim_matrix[:, i] = 0.0
        sim_matrix[i, i] = 0.0
    for i in servers:
        sim_matrix[i][i] = 0.0

    sim_matrix = sim_matrix.astype(np.float64)
    row_sums = sim_matrix.sum(axis=1, keepdims=True)
    sim_matrix = sim_matrix / row_sums
    sim_matrix[np.isnan(sim_matrix)] = 0

    for i in range(dim):
        candidates = [x for x in range(dim) if x != i and sim_matrix[i, x] != 0]
        sim_matrix[i, np.random.choice(candidates)] += 1 - sim_matrix[i].sum()

    for i in sources:
        sim_matrix[i, i] = 1.0
    for i in servers:
        sim_matrix[i, i] = -1.0

    return sim_matrix, distributions, instruments, note_levels


def _mel_from_device_audio(audio, sample_rate):
    """int16 write/read round trip applied on the audio's device (bit-equal
    to save_wav+load_wav: truncate-toward-zero cast, /32768 normalize), then
    the dynamic-hop mel — no host transfer of the audio — inside the ``mel``
    span. The span (a profiler range) encloses the call of
    ``melspectrogram_db_tensor`` (which opens none; its callers do) rather
    than lying inside it, so that a range an operator's profiler opens
    around that function stays the innermost one and keeps the kernel's
    device time (a device-side range covers only the kernels of the
    innermost host range)."""
    with span("mel"):
        q = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
        q = q.to(torch.float32) / 32768.0
        return melspectrogram_db_tensor(q, sr=sample_rate)


def matrix_to_wav(
    matrices,
    size=20,
    use_same_instrument=None,
    start=0,
    end=174,
    device="cuda",
    overwrite=None,
    *,
    log_path="logs/",
    out_dir="adj_sim_outputs",
    sample_rate=44100,
    number_of_customers=1000,
    max_sim_time=0.5,
    parallel=None,
    write_wav=True,
    sound_font=None,
    wavs=None,
):
    """The mel-dB spectrograms of ``matrices``, ``[start:end]`` in time, on
    ``device``. Files, as the reference leaves them: the sim's log under
    ``log_path`` (sequential path only), ``<out_dir>/midi/output.mid`` and,
    with ``write_wav``, ``<out_dir>/wav/output_<i>.wav``. ``log_path=None``
    keeps the log in memory (the first 5,100 records, decoded natively, as
    in ``parallel`` mode); ``out_dir=None`` writes no file at all.
    ``wavs``, a list, gets each sample's WAV file (the bytes ``save_wav``
    writes) as a uint8 tensor on ``device``, with or without files. The
    decoded samples, the global RNG and every byte rendered are the same
    either way (for sims that their wall budget does not cut)."""
    num_aug = 5

    if parallel and parallel > 1 and native.native_available():
        return _matrix_to_wav_parallel(
            matrices, size, num_aug, use_same_instrument, start, end,
            out_dir, sample_rate, number_of_customers,
            max_sim_time, parallel, write_wav, sound_font, device, wavs,
        )

    spectrograms = []
    for index, matrix in enumerate(matrices):
        sim_matrix, distributions, instruments, note_levels = _decode_gandes_sample(
            matrix, size, num_aug, use_same_instrument
        )
        queue_list = [2 * 127] * (size - num_aug)

        length_mel = 0
        count = 0
        while length_mel < 2:
            count += 1
            if count > 1:
                print("Error: Could not generate a wav file for the matrix, using a blank wav file instead.")
                mel = melspectrogram_db(torch.zeros(5 * sample_rate, device=device),
                                        sr=sample_rate)
                break
            np.random.seed(np.random.randint(0, 99999, size=1))
            seeds = np.random.randint(0, 99999, size=1)

            sim = Sim(
                sim_matrix, distributions, queue_list, seeds=seeds, log_path=log_path,
                generate_log=True, animation=False, record_history=False,
                logging_mode="Music", max_sim_time=max_sim_time,
            )
            sim.run(number_of_customers=number_of_customers)

            audio, true_len = _render_sim(sim, instruments, note_levels, out_dir,
                                          sample_rate, sound_font, device)
            wav = _write_wav(audio, true_len, sample_rate, out_dir, write_wav, index, wavs)
            # int16 round trip on the device == reading the written file back
            # (the reference reads the FluidSynth output, :129)
            mel = _mel_from_device_audio(audio, sample_rate)
            length_mel = mel.shape[1]

        spectrograms.append(mel)
        if wavs is not None:
            wavs.append(wav)

    return torch.stack([s[:, start:end] for s in spectrograms])


def _write_wav(audio, true_len, sample_rate, out_dir, write_wav, index, wavs):
    """The sample's WAV: written to ``<out_dir>/wav/output_<index>.wav`` when
    there is an ``out_dir`` and ``write_wav``, and returned as the file's
    bytes in a uint8 tensor on the audio's device when ``wavs`` collects
    them (else None)."""
    if out_dir is not None and write_wav:
        output_file = os.path.join(out_dir, "wav", f"output_{index}.wav")
        os.makedirs(os.path.dirname(output_file), exist_ok=True)
        save_wav(output_file, audio[:true_len].cpu().numpy(), sample_rate)
    if wavs is None:
        return None
    with span("wav"):
        return wav_tensor(audio[:true_len], sample_rate)


def _render_sim(sim, instruments, note_levels, out_dir, sample_rate, sound_font, device):
    """A run sim's MIDI decode (written to ``<out_dir>/midi/output.mid``
    unless ``out_dir`` is None) and its render on ``device``: ``(audio, true
    length)``, the audio the whole pow2 bucket (the mel is taken over it,
    zero tail included). Records still in memory (a native run) go through
    the native decoder, which gives ``process_adjsim_log_v1``'s bytes and
    the synth's event arrays; otherwise the Python decoder reads the log's
    lines."""
    midi_path = None if out_dir is None else os.path.join(out_dir, "midi", "output.mid")
    res = None
    if getattr(sim, "_pending_records", None) is not None:
        with span("midi"):
            res = native_decode.decode_records_v1(sim, instruments, note_levels, midi_path)
    if res is not None:
        with span("synth"):
            return render_events(res[1], sr=sample_rate, as_tensor=True,
                                 sound_font=sound_font, device=device)
    _, mid = process_adjsim_log_v1(
        instruments=instruments, note_levels=note_levels,
        lines=sim.music_lines(limit=5001), out_path=midi_path, return_mid=True,
    )
    return render_midi(mid, sr=sample_rate, as_tensor=True, sound_font=sound_font,
                       device=device)


def _matrix_to_wav_parallel(matrices, size, num_aug, use_same_instrument,
                            start, end, out_dir, sample_rate,
                            number_of_customers, max_sim_time, parallel,
                            write_wav=True, sound_font=None, device="cuda", wavs=None):
    """Fast mode (mirrors bridge/mmgan_decode's): sequential decode on the
    global RNG, concurrent native sims with private routing streams, then
    per clip the MIDI decode, the synth and the mel on ``device``. The
    reference's retry-then-blank fallback (:97-104) is unreachable here: the
    synth renders >= 0.5 s of audio, so the dynamic-hop mel always has 216
    frames."""
    matrices = list(matrices)
    B = len(matrices)
    dim = size - num_aug
    sims, metas = [], []
    for matrix in matrices:
        sim_matrix, distributions, instruments, note_levels = _decode_gandes_sample(
            matrix, size, num_aug, use_same_instrument
        )
        np.random.seed(np.random.randint(0, 99999, size=1))
        seeds = np.random.randint(0, 99999, size=1)
        routing_seed = int(np.random.randint(0, 2**31 - 1))
        sim = Sim(
            sim_matrix, distributions, [2 * 127] * dim, seeds=seeds,
            log_path=None, generate_log=True, record_history=False,
            logging_mode="Music", max_sim_time=max_sim_time, engine="native",
        )
        sim.routing_rng = np.random.RandomState(routing_seed)
        sims.append(sim)
        metas.append((instruments, note_levels))

    def worker(i):
        sims[i].run(number_of_customers=number_of_customers)

    with ThreadPoolExecutor(max_workers=min(parallel, B)) as pool:
        list(pool.map(worker, range(B)))

    spectrograms = []
    for index, sim in enumerate(sims):
        instruments, note_levels = metas[index]
        audio, true_len = _render_sim(sim, instruments, note_levels, out_dir, sample_rate,
                                      sound_font, device)
        wav = _write_wav(audio, true_len, sample_rate, out_dir, write_wav, index, wavs)
        if wavs is not None:
            wavs.append(wav)
        spectrograms.append(_mel_from_device_audio(audio, sample_rate))

    return torch.stack([s[:, start:end] for s in spectrograms])
