"""Datasets, loaders and the offline MAESTRO pickler (port of
``gandes_tpu/data/datasets.py``).

* ``MaestroDatasetPickle`` — the MM-GAN training set: a pickled list of
  (piano_roll, durations, beats) windows
  (`MMGAN_MIDI_DES/datasets.py:73-87`). Reads both the reference's
  torch-tensor pickles and numpy pickles.
* ``MaestroDatasetMidi`` — rasterize MIDI on the fly (:103-123).
* ``build_window_pickle`` — the offline pickler from
  `data_viewing_and_processing.ipynb` cell 11: 300-step roll per file,
  50-step windows, window 0 skipped, per-file beats attached to every
  window. Its fast path rasterizes batches of files in one
  ``rasterize_events`` call: K1 on the card.
* ``MaestroDatasetTorch`` — per-file ``.pt`` tensors (:90-100).
* ``InputSong`` / ``MaestroDatasetGanDes`` / ``my_collate`` /
  ``collect_real_mels`` — the GAN-DES audio path (`GAN_DES/datasets.py`):
  MIDI -> audio (the additive synth, or SF2 playback of a given
  ``sound_font``, instead of FluidSynth) -> 5 s slices ->
  <=k random mel spectrograms per item, concatenated across the batch. The
  audio and every mel stay on the ``device`` they are given: K2 on
  ``"cuda"``, one launch per slice.
* ``DataLoader`` — a minimal batch iterator (shuffle / drop_last /
  collate).

Path handling: the reference hardcodes Windows backslash paths
(datasets.py:76,94,109) — all roots here are parameters.
"""

from __future__ import annotations

import glob
import os
import pickle
import random as _random

import numpy as np

from gandes_tpu_torch.music.beats import get_beats
from gandes_tpu_torch.music.midi import MidiFile
from gandes_tpu_torch.music.piano_roll import generate_piano_roll


def _to_numpy(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Dataset:
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


def default_collate(items):
    first = items[0]
    if isinstance(first, tuple):
        return tuple(np.stack([np.asarray(it[i]) for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class DataLoader:
    """Minimal batch iterator: shuffle, drop_last (torch parity defaults:
    the MM-GAN loop uses drop_last=True, `network_tests.py:230`)."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=True,
                 collate_fn=default_collate, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idxs])


# ------------------------------------------------------------------ MM-GAN


class MaestroDatasetPickle(Dataset):
    def __init__(self, pickle_file_name, sequence_length=100, beats_length=50,
                 device="cpu", data_dir="data"):
        path = pickle_file_name if os.path.isabs(pickle_file_name) else os.path.join(
            data_dir, pickle_file_name
        )
        with open(path, "rb") as f:
            self.data = pickle.load(f)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        piano_roll, durations, beats = self.data[idx]
        return _to_numpy(piano_roll), _to_numpy(durations), _to_numpy(beats)


class MaestroDatasetMidi(Dataset):
    def __init__(self, root_dir, sequence_length=100, beats_length=50, device="cpu"):
        self.sequence_length = sequence_length
        self.beats_length = beats_length
        pattern = os.path.join(root_dir, "**", "*.mid*")
        self.file_list = sorted(glob.glob(pattern, recursive=True))

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        roll, durations, beats = generate_piano_roll(
            self.file_list[idx], self.sequence_length, self.beats_length,
            start=0, end=self.sequence_length,
        )
        return roll.astype(np.float32), durations.astype(np.float32), beats.astype(np.float32)


def generate_piano_roll_with_total(midi_input, sequence_length=300, beats_length=50):
    """Notebook cell-10 variant: full-width roll + the last step index seen
    (``total_time``), used by the pickler to count windows."""
    midi = MidiFile(midi_input) if isinstance(midi_input, str) else midi_input
    beat_src = midi if isinstance(midi_input, str) else (
        MidiFile(midi.filename) if midi.filename else None
    )
    piano_roll = np.zeros((128, sequence_length))
    durations = np.zeros((128, sequence_length))
    total_time = 0
    my_time = 0.0
    note_on_time = np.zeros(128)
    from gandes_tpu_torch.music.midi import iter_seconds

    for msg, delta in iter_seconds(midi):
        my_time += delta
        time_step = int(round(my_time))
        total_time = time_step
        if time_step >= sequence_length:
            break
        if msg.type == "note_on":
            piano_roll[msg.note, time_step] = msg.velocity
            note_on_time[msg.note] = time_step
        elif msg.type == "note_off":
            note_off_time = int(round(note_on_time[msg.note]))
            durations[msg.note, note_off_time:time_step] = time_step - note_off_time

    beats = get_beats(beat_src)
    if len(beats) < beats_length:
        beats = np.pad(beats, (0, beats_length - len(beats)))
    elif len(beats) > beats_length:
        beats = beats[:beats_length]
    return piano_roll, durations, beats, total_time


def _extract_file_events(args):
    """Worker: parse one MIDI into (events, total_time, beats) — numpy-only
    so it runs in a plain process pool."""
    midi_name, sample_size, beats_length = args
    from gandes_tpu_torch.music.piano_roll import midi_to_events

    midi = MidiFile(midi_name)
    notes, ons, offs, vels, total = midi_to_events(
        midi, max_steps=sample_size, return_total=True
    )
    beats = get_beats(midi)
    if len(beats) < beats_length:
        beats = np.pad(beats, (0, beats_length - len(beats)))
    else:
        beats = beats[:beats_length]
    return notes, ons, offs, vels, int(total), beats.astype(np.float32)


def pad_file_events(grp):
    """(notes, ons, offs, vels) int32 (len(grp), E) arrays of the files'
    events, E the densest file's count (at least 1), other slots padded
    with ``note = -1``."""
    E = max(1, max(len(e[0]) for e in grp))
    notes = np.full((len(grp), E), -1, np.int32)
    ons, offs, vels = (np.zeros((len(grp), E), np.int32) for _ in range(3))
    for j, (n_, o_, f_, v_, *_rest) in enumerate(grp):
        k = len(n_)
        notes[j, :k], ons[j, :k], offs[j, :k], vels[j, :k] = n_, o_, f_, v_
    return notes, ons, offs, vels


def _rasterize_file_batch(extracted, sample_size, chunk=8, device="cuda"):
    """Batched rasterization of per-file event arrays on ``device``: one
    ``rasterize_events`` call per ``chunk`` files, padded (``note = -1``) to
    the chunk's densest file. Yields one (2, 128, sample_size) float32 array
    per file, in order."""
    import torch

    from gandes_tpu_torch.music.piano_roll import rasterize_events

    for i in range(0, len(extracted), chunk):
        events = [torch.from_numpy(a).to(device) for a in pad_file_events(extracted[i:i + chunk])]
        out = rasterize_events(*events, num_steps=sample_size, start=0).cpu().numpy()
        yield from out


def build_window_pickle(midi_root, out_path, sample_size=300, sequence_length=50,
                        beats_length=50, verbose=False, workers=None,
                        device_rasterize=False, device="cuda"):
    """Offline pickler == notebook cell 11: slice each file's
    ``sample_size``-step roll into ``sequence_length`` windows (window 0
    skipped), attach the file's beat vector to every window.

    Scaling knobs (output identical to the sequential host path):

    * ``workers=N`` — parse/extract files on a process pool (the host parse
      is the throughput bound for MAESTRO-scale corpora). Worker startup is
      not free, so this wins on real corpora, not toy ones; callers must be
      spawn-safe (guarded ``__main__`` — the CLI is).
    * ``device_rasterize=True`` — same fast path with a single worker.

    Either flag switches rasterization to the batched ``rasterize_events``
    over per-file event arrays on ``device`` (K1 on ``"cuda"``, its plain
    version on ``"cpu"``), replacing the per-file host message loop.
    """
    if os.path.isdir(midi_root):
        file_list = sorted(glob.glob(os.path.join(midi_root, "**", "*.mid*"), recursive=True))
    else:
        file_list = sorted(glob.glob(midi_root, recursive=True))
    preprocessed = []

    if workers or device_rasterize:
        jobs = [(f, sample_size, beats_length) for f in file_list]
        if workers and workers > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: the parent has torch's thread pools running,
            # and forking a multithreaded process can deadlock. Workers only
            # parse/extract.
            try:
                with ProcessPoolExecutor(max_workers=workers,
                                         mp_context=mp.get_context("spawn")) as pool:
                    extracted = list(pool.map(_extract_file_events, jobs, chunksize=4))
            except Exception:
                # spawn needs an importable __main__ (breaks under stdin
                # scripts / some REPLs) — degrade to in-process extraction
                print("pickle-dataset: process pool unavailable, extracting in-process")
                extracted = [_extract_file_events(j) for j in jobs]
        else:
            extracted = [_extract_file_events(j) for j in jobs]

        rolls = _rasterize_file_batch(extracted, sample_size, device=device)
        for idx, ((_n, _o, _f, _v, total, beats), pair) in enumerate(zip(extracted, rolls)):
            if verbose and idx % 50 == 0:
                print(f"Loading and preprocessing data for index {idx}")
            roll, durations = pair[0], pair[1]
            n_samples = int(np.floor(total / sequence_length))
            for i in range(n_samples):
                start = i * sequence_length
                rs = roll[:, start:start + sequence_length]
                ds = durations[:, start:start + sequence_length]
                if rs.shape[1] == sequence_length and ds.shape[1] == sequence_length and i != 0:
                    preprocessed.append((rs.astype(np.float32), ds.astype(np.float32),
                                         beats.astype(np.float32)))
    else:
        for idx, midi_name in enumerate(file_list):
            if verbose and idx % 50 == 0:
                print(f"Loading and preprocessing data for index {idx}")
            roll, durations, beats, total_time = generate_piano_roll_with_total(
                midi_name, sample_size, beats_length
            )
            n_samples = int(np.floor(total_time / sequence_length))
            for i in range(n_samples):
                start = i * sequence_length
                rs = roll[:, start:start + sequence_length]
                ds = durations[:, start:start + sequence_length]
                if rs.shape[1] == sequence_length and ds.shape[1] == sequence_length and i != 0:
                    preprocessed.append((rs.astype(np.float32), ds.astype(np.float32),
                                         beats.astype(np.float32)))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(preprocessed, f)
    return len(preprocessed)


class MaestroDatasetTorch(Dataset):
    """Per-file ``.pt`` tensors (`MMGAN_MIDI_DES/datasets.py:90-100`), each
    item a tuple of numpy arrays."""

    def __init__(self, root_dir, sequence_length=100, beats_length=50, device="cpu"):
        self.file_list = sorted(glob.glob(os.path.join(root_dir, "*.pt")))

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        import torch

        item = torch.load(self.file_list[idx], weights_only=False)
        return tuple(_to_numpy(x) for x in item)


# ----------------------------------------------------------------- GAN-DES


def _five_second_slices(audio, sr, hop_s=5):
    """``hop_s``-second slices of a 1-D wave (`GAN_DES/datasets.py:30-37,
    78-83`): one per hop start up to the end, the last one the wave's final
    ``hop_s`` seconds. Slices of a tensor are views on its device."""
    n = hop_s * sr
    return [audio[-n:] if i + n > len(audio) else audio[int(i):int(i) + n]
            for i in np.arange(0, len(audio) + 1, n)]


class InputSong(Dataset):
    """One WAV -> 5 s mel slices (`GAN_DES/datasets.py:17-52`). The wave is
    put on ``device`` once, so every slice's mel runs there (K2 on
    ``"cuda"``); each item is a (128, 216) mel-dB tensor on ``device``."""

    def __init__(self, audio_file, window_size=5, hop_length_audio=5, device="cuda"):
        import torch

        from gandes_tpu_torch.data.audio import load_wav

        waveform, sample_rate = load_wav(audio_file, normalize=True, mono=True)
        self.orig_waveform = waveform
        self.sample_rate = sample_rate
        self.audio_file_length = len(waveform) / sample_rate
        self.window_size = window_size
        self.hop_length_audio = hop_length_audio
        wave = torch.from_numpy(np.ascontiguousarray(waveform, np.float32)).to(device)
        self.audio_files = _five_second_slices(wave, sample_rate, hop_length_audio)

    def __len__(self):
        return len(self.audio_files)

    def __getitem__(self, item):
        from gandes_tpu_torch.core.profiling import span
        from gandes_tpu_torch.music.mel import melspectrogram_db_tensor

        with span("mel"):
            return melspectrogram_db_tensor(self.audio_files[item], self.sample_rate)


class MaestroDatasetGanDes(Dataset):
    """MIDI -> synth audio -> 5 s slices -> <=batch_size random mels
    (`GAN_DES/datasets.py:55-91`, FluidSynth replaced by the port's synth,
    no temp-wav round trip). The render stays on ``device`` and is cropped
    to its true length before slicing, so every slice's mel runs there (one
    K2 launch per slice on ``"cuda"``; a numpy slice would take the mel's
    plain version on the CPU); each item is a (k, 128, 216) mel-dB tensor on
    ``device``. The slices are subsampled with Python's global ``random``,
    as the reference does."""

    def __init__(self, batch_size, input_folder="data/maestro-v3.0.0",
                 metadata_json=None, sample_rate=44100, sound_font=None, device="cuda"):
        import json

        self.INPUT_FOLDER = input_folder
        self.k = batch_size
        self.sample_rate = sample_rate
        # None -> the additive synth; an existing .sf2 -> SF2 sample
        # playback on ``device`` (music/synth.py)
        self.sound_font = sound_font
        self.device = device
        meta = metadata_json or os.path.join(input_folder, "maestro-v3.0.0.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self.data = json.load(f)["midi_filename"]
            self._keys = sorted(self.data, key=lambda k: int(k))
        else:
            files = sorted(glob.glob(os.path.join(input_folder, "**", "*.mid*"), recursive=True))
            self.data = {str(i): os.path.relpath(p, input_folder) for i, p in enumerate(files)}
            self._keys = [str(i) for i in range(len(files))]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        import torch

        from gandes_tpu_torch.core.profiling import span
        from gandes_tpu_torch.music.mel import melspectrogram_db_tensor
        from gandes_tpu_torch.music.synth import render_midi

        midi_path = os.path.join(self.INPUT_FOLDER, self.data[str(index)])
        audio, true_len = render_midi(midi_path, sr=self.sample_rate, as_tensor=True,
                                      sound_font=self.sound_font, device=self.device)
        splits = _five_second_slices(audio[:true_len], self.sample_rate)
        if len(splits) > self.k:
            splits = _random.sample(splits, self.k)
        with span("mel"):
            return torch.stack([melspectrogram_db_tensor(s, self.sample_rate) for s in splits])


def my_collate(batch):
    """Concatenate variable split counts (`GAN_DES/datasets.py:94-100`)."""
    import torch

    return torch.cat(list(batch), 0)


def collect_real_mels(midi_dir, n, sound_font=None, sample_rate=44100, seed=0, device="cuda"):
    """A balanced real-side mel pool for evaluation: up to ``n`` full-window
    mel slices drawn ROUND-ROBIN across the directory's MIDI files.

    The naive loop (take batches file-by-file until n) over-weights the
    first files and counts slices toward n before the short-file filter
    drops them; evaluation statistics then measure distance to the first
    network(s) rather than the directory's distribution. Here each file
    contributes ceil(n/len(files)) candidate slices, short-file renders
    (fewer mel frames than the full 5 s window) are dropped BEFORE
    counting, and the final pool interleaves files so truncation at n
    stays balanced. Returns (mels, n_files_contributing), the mels one
    tensor on ``device``."""
    import torch

    ds = MaestroDatasetGanDes(batch_size=1, input_folder=midi_dir, sample_rate=sample_rate,
                              sound_font=sound_font, device=device)
    if len(ds) == 0:
        raise ValueError(f"no MIDI files under {midi_dir}")
    ds.k = max(1, -(-n // len(ds)))  # ceil(n / n_files) per file
    _random.seed(seed)  # long files subsample their slices via random.sample
    batches = []
    for i in range(len(ds)):
        batches.append(ds[i])
        frames = max(b.shape[-1] for b in batches)
        kept = sum(b.shape[0] for b in batches if b.shape[-1] == frames)
        if kept >= n:
            break
    frames = max(b.shape[-1] for b in batches)
    full = [b for b in batches if b.shape[-1] == frames]
    # interleave: slice j of every file before slice j+1 of any
    order = [b[j] for j in range(max(b.shape[0] for b in full))
             for b in full if j < b.shape[0]]
    return torch.stack(order[:n]), len(full)
