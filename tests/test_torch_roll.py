"""The port's piano-roll rasterizer and MAESTRO pickler vs the JAX package, on the CPU.

``rasterize_events_reference`` (K1's plain version, which ``rasterize_events``
takes for CPU tensors) is held bitwise against the JAX package's XLA path
(``rasterize_events_jax(impl="xla")``) and its Pallas kernel in interpret
mode: the values are small integers in float32, so there is no tolerance.
The pickler's windows are held bitwise against the JAX package's, window by
window, on the host path and on the device-rasterize path.

``_k1_model`` is a numpy model of the CUDA kernel's steps (tiles, the chunk
walk that skips the pad tail, per-thread folds of the highest covering event
index merged by the larger index, the winner's resolve), held bitwise
against ``_rasterize_math`` and the Pallas kernel in interpret mode.
"""

import os
import pickle
import re

import numpy as np
import pytest
import torch

from gandes_tpu.data.datasets import build_window_pickle as jax_build_window_pickle
from gandes_tpu.music.midi import MidiFile as JaxMidiFile
from gandes_tpu.music.piano_roll import midi_to_events as jax_midi_to_events
from gandes_tpu.music.piano_roll import rasterize_events_jax
from gandes_tpu.ops.pallas_roll import rasterize_events_pallas
from gandes_tpu_torch.data.datasets import build_window_pickle
from gandes_tpu_torch.music.midi import MidiFile
from gandes_tpu_torch.music.piano_roll import midi_to_events, rasterize_events
from gandes_tpu_torch.ops import roll_rasterize
from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda, rasterize_events_reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_events(rng, B, E, T, start):
    """tests/test_pallas_roll.py's generator: notes in [-1, 128), ons past
    the crop on both sides, spans from -2 to 19 steps, velocities from -1."""
    notes = rng.randint(-1, 128, (B, E)).astype(np.int32)
    ons = rng.randint(0, T + start + 10, (B, E)).astype(np.int32)
    offs = (ons + rng.randint(-2, 20, (B, E))).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    return notes, ons, offs, vels


def _holes_and_pad_tail(rng, B, E):
    notes = np.full((B, E), -1, np.int32)
    for b in range(B):
        nv = rng.randint(4, 40)
        notes[b, :nv] = rng.randint(0, 128, nv)
        notes[b, rng.randint(0, nv)] = -1  # interior hole
    ons = rng.randint(0, 60, (B, E)).astype(np.int32)
    offs = (ons + rng.randint(-2, 20, (B, E))).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    return notes, ons, offs, vels


LAST_WRITER = (np.array([[60, 60, 60, 60, 64, 64]], np.int32),
               np.array([[10, 10, 10, 10, 5, 5]], np.int32),
               np.array([[30, 20, 15, 12, 40, 8]], np.int32),
               np.array([[100, 90, 0, -1, 70, 0]], np.int32))

# (label, events, T, start, hold against the Pallas kernel in interpret mode)
CASES = [
    ("random_3x32_T50_s5", lambda: _random_events(np.random.RandomState(0), 3, 32, 50, 5), 50, 5, True),
    ("random_2x128_T50_s100", lambda: _random_events(np.random.RandomState(1), 2, 128, 50, 100), 50, 100, True),
    ("random_1x16_T96", lambda: _random_events(np.random.RandomState(2), 1, 16, 96, 0), 96, 0, True),
    ("last_writer", lambda: LAST_WRITER, 50, 0, True),
    ("holes_and_pad_tail", lambda: _holes_and_pad_tail(np.random.RandomState(3), 4, 256), 50, 0, True),
    ("all_pad", lambda: (np.full((2, 8), -1, np.int32),) + (np.zeros((2, 8), np.int32),) * 3, 50, 0, True),
    ("E_above_16384", lambda: _random_events(np.random.RandomState(4), 1, 16500, 40, 3), 40, 3, False),
]


def _torch(events):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in events]


@pytest.mark.parametrize("label,make,T,start,pallas", CASES, ids=[c[0] for c in CASES])
def test_rasterize_reference_matches_jax(label, make, T, start, pallas):
    events = make()
    ref = np.asarray(rasterize_events_jax(*events, num_steps=T, start=start, impl="xla"))
    launches = rasterize_cuda.launches
    got = rasterize_events(*_torch(events), num_steps=T, start=start)
    assert rasterize_cuda.launches == launches  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (events[0].shape[0], 2, 128, T)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        rasterize_events_reference(*_torch(events), num_steps=T, start=start).numpy(), ref)
    if pallas:
        np.testing.assert_array_equal(
            np.asarray(rasterize_events_pallas(*events, num_steps=T, start=start)), ref)
    if label == "last_writer":  # a later vel 0 erased 100/90; the -1 left it
        assert ref[0, 0, 60, 10] == 0.0 and ref[0, 1, 60, 10] == 2.0
    if label == "all_pad":
        assert not ref.any()


def test_rasterize_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_cuda(*_torch(LAST_WRITER), num_steps=50)


def _cu_constant(name):
    """An ``int`` constant of ``csrc/roll_rasterize.cu``, so the model and the
    kernel share their tile and chunk sizes."""
    path = os.path.join(os.path.dirname(roll_rasterize.__file__), "csrc", "roll_rasterize.cu")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


THREADS, UNROLL = _cu_constant("THREADS"), _cu_constant("UNROLL")
PITCH_TILE, COL_TILE = _cu_constant("PITCH_TILE"), _cu_constant("COL_TILE")
CHUNK = THREADS * UNROLL


WARPS = THREADS // 32


def _tile_cells(events, b, kept, p0, t0, tc, start):
    """The cells the kept events cover inside one tile, in the kernel's
    [channel][row][column - t0] order: (cell, event index + 1) pairs."""
    notes, ons, offs, vels = events
    r = notes[b, kept].astype(np.int64) - p0
    on = ons[b, kept].astype(np.int64) - start
    off = offs[b, kept].astype(np.int64) - start
    vel = vels[b, kept].astype(np.int64)
    e1 = kept.astype(np.int64) + 1
    at = (vel >= 0) & (on >= t0) & (on < t0 + tc)  # channel 0: the onset
    lo, hi = np.maximum(on, t0), np.minimum(off, t0 + tc)  # channel 1: the span
    n = np.maximum(hi - lo, 0)
    step = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    cells = np.concatenate([r[at] * tc + on[at] - t0,
                            np.repeat((PITCH_TILE + r) * tc - t0 + lo, n) + step])
    return cells, np.concatenate([e1[at], np.repeat(e1, n)])


def _lanes(kept):
    """The lane that folds each kept event: event i of chunk c sits in warp
    (i % CHUNK % THREADS) // 32, whose queue holds its events in index
    order; queue slot j goes to lane j % 32."""
    group = (kept // CHUNK) * WARPS + kept % CHUNK % THREADS // 32
    rank = np.zeros(len(kept), np.int64)
    for g in np.unique(group):
        rank[group == g] = np.arange(np.count_nonzero(group == g))
    return group * 32 + rank % 32


def _k1_model(notes, ons, offs, vels, T, start, seed=0):
    """numpy model of ``csrc/roll_rasterize.cu``: per (sample, pitch tile,
    column tile), chunks walked from the last down with the pad tail's
    chunks skipped; each warp queues its tile events in index order and
    each lane folds its queued events into a partial of the highest
    covering index + 1, in a shuffled order; the partials merge by the
    larger index; a cell then takes its winner's velocity or off - on, and
    0 where no event covers it."""
    events = (notes, ons, offs, vels)
    rng = np.random.RandomState(seed)
    B, E = notes.shape
    out = np.full((B, 2, 128, T), np.nan, np.float32)
    n_chunks = -(-E // CHUNK)
    for b in range(B):
        first = next((k for k in reversed(range(n_chunks))
                      if (notes[b, k * CHUNK:(k + 1) * CHUNK] >= 0).any()), -1)
        walked = np.arange(min(E, (first + 1) * CHUNK))
        for p0 in range(0, 128, PITCH_TILE):
            r = notes[b, walked].astype(np.int64) - p0
            kept = walked[(r >= 0) & (r < PITCH_TILE)]
            lanes = _lanes(kept)
            for t0 in range(0, T, COL_TILE):
                tc = min(COL_TILE, T - t0)
                cells, e1 = _tile_cells(events, b, kept, p0, t0, tc, start)
                lane_of = dict(zip(kept + 1, lanes))
                owners, lane = np.unique([lane_of[e] for e in e1], return_inverse=True)
                partial = np.zeros((max(len(owners), 1), 2 * PITCH_TILE * tc), np.int64)
                order = rng.permutation(len(cells))
                np.maximum.at(partial, (lane.reshape(-1)[order], cells[order]), e1[order])
                win = partial.max(axis=0).reshape(2, PITCH_TILE, tc)
                e = np.maximum(win - 1, 0)
                value = np.stack([vels[b, e[0]].astype(np.float32),
                                  (offs[b, e[1]].astype(np.int64)
                                   - ons[b, e[1]].astype(np.int64)).astype(np.float32)])
                out[b, :, p0:p0 + PITCH_TILE, t0:t0 + tc] = np.where(win != 0, value, 0.0)
    return out


def _one_pitch(rng, B, E, T):
    notes, ons, offs, vels = _random_events(rng, B, E, T, 0)
    notes[notes >= 0] = 60
    return notes, ons, offs, vels


def _past_one_chunk(rng):
    """Three chunks: valid notes up to index 5000, then a pad tail."""
    notes, ons, offs, vels = _random_events(rng, 1, 2 * CHUNK + 100, 40, 3)
    notes[:, 5000:] = -1
    return notes, ons, offs, vels


# (label, events, T, start): the JAX kernel tests' shapes, the order and pad
# cases, a skewed file, more than one chunk, and more than one column tile
MODEL_CASES = [
    ("random_3x32_T50_s5", lambda: _random_events(np.random.RandomState(0), 3, 32, 50, 5), 50, 5),
    ("random_2x128_T50_s100", lambda: _random_events(np.random.RandomState(1), 2, 128, 50, 100),
     50, 100),
    ("random_1x16_T96", lambda: _random_events(np.random.RandomState(2), 1, 16, 96, 0), 96, 0),
    ("last_writer", lambda: LAST_WRITER, 50, 0),
    ("holes_and_pad_tail", lambda: _holes_and_pad_tail(np.random.RandomState(3), 4, 256), 50, 0),
    ("all_pad", lambda: (np.full((2, 8), -1, np.int32),) + (np.zeros((2, 8), np.int32),) * 3,
     50, 0),
    ("one_pitch", lambda: _one_pitch(np.random.RandomState(5), 2, 600, 60), 60, 0),
    ("past_one_chunk", lambda: _past_one_chunk(np.random.RandomState(6)), 40, 3),
    ("T2000", lambda: _random_events(np.random.RandomState(7), 1, 400, 2000, 0), 2000, 0),
]


@pytest.mark.parametrize("label,make,T,start", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_k1_model_matches_jax(label, make, T, start):
    events = make()
    ref = np.asarray(rasterize_events_jax(*events, num_steps=T, start=start, impl="xla"))
    np.testing.assert_array_equal(_k1_model(*events, T, start), ref)
    np.testing.assert_array_equal(
        np.asarray(rasterize_events_pallas(*events, num_steps=T, start=start, interpret=True)),
        ref)
    if label == "one_pitch":
        assert ref[:, :, 60].any() and not np.delete(ref, 60, axis=2).any()


def test_midi_to_events_matches_jax(midi_fixture_dir):
    paths = sorted(str(p) for p in midi_fixture_dir.rglob("*.mid"))
    assert paths
    for path in paths:
        for max_steps in (None, 30):
            ours = midi_to_events(MidiFile(path), max_steps=max_steps, return_total=True)
            ref = jax_midi_to_events(JaxMidiFile(path), max_steps=max_steps, return_total=True)
            assert ours[4] == ref[4]
            for a, b in zip(ours[:4], ref[:4]):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("sample_size,sequence_length", [(300, 50), (60, 10)])
def test_build_window_pickle_matches_jax(midi_fixture_dir, tmp_path, sample_size,
                                         sequence_length):
    kw = dict(sample_size=sample_size, sequence_length=sequence_length)
    ref_path = str(tmp_path / "jax.pkl")
    n_ref = jax_build_window_pickle(str(midi_fixture_dir), ref_path, **kw)
    ref = _load(ref_path)
    for mode, extra in (("host", {}), ("device", {"device_rasterize": True, "device": "cpu"})):
        path = str(tmp_path / f"{mode}.pkl")
        launches = rasterize_cuda.launches
        assert build_window_pickle(str(midi_fixture_dir), path, **kw, **extra) == n_ref
        assert rasterize_cuda.launches == launches
        ours = _load(path)
        assert len(ours) == len(ref) == n_ref
        for a, b in zip(ours, ref):
            for x, y in zip(a, b):
                assert x.dtype == np.asarray(y).dtype == np.float32
                np.testing.assert_array_equal(x, np.asarray(y))
    assert n_ref > 0


def test_cli_pickle_dataset(midi_fixture_dir, tmp_path):
    from gandes_tpu_torch.cli import main

    ref_path, out = str(tmp_path / "lib.pkl"), str(tmp_path / "cli.pkl")
    n = build_window_pickle(str(midi_fixture_dir), ref_path)
    main(["pickle-dataset", "--midi-root", str(midi_fixture_dir), "--out", out,
          "--device-rasterize", "--device", "cpu"])
    ours, ref = _load(out), _load(ref_path)
    assert len(ours) == len(ref) == n > 0
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
