"""The port's native record decoders (``gandes_tpu_torch/music/native_decode.py``)
vs the JAX package's, and vs the port's own Python generators, on the CPU.

Both packages build the repository's one ``native/midi_decode.cpp``. Each
decoder reads the same sim's raw records (a native sim run by the port, or
hand-made records), so the comparisons do not depend on the wall clock:
rolls bit for bit, ``output.mid`` bytes and the synth's event arrays equal.
The cases are ``tests/test_native_decode.py``'s: random generator outputs,
the crop quirk, the regex and cleanup edge cases, the line budget, and
``program_change_per_note`` (v0).
"""

import os

import numpy as np
import pytest

from gandes_tpu.music import native_decode as jax_nd
from gandes_tpu_torch.bridge.gandes_decode import _decode_gandes_sample
from gandes_tpu_torch.bridge.mmgan_decode import _decode_sample
from gandes_tpu_torch.des import native
from gandes_tpu_torch.des.engine import Sim
from gandes_tpu_torch.music import native_decode as nd
from gandes_tpu_torch.music.generators import (
    process_adjsim_log_v0,
    process_adjsim_log_v1,
    process_adjsim_log_v2,
)
from gandes_tpu_torch.music.synth import midi_to_event_arrays


@pytest.fixture(autouse=True, scope="module")
def _libs_loaded():
    assert native.get_lib() is not None
    assert nd.native_decode_available() and jax_nd.native_decode_available()


def test_decoder_is_built_into_the_port_build_dir():
    """The unchanged root source, built into ``gandes_tpu_torch/_build/``
    under its content hash."""
    import hashlib

    with open(nd._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.samefile(nd._SRC, os.path.join(os.path.dirname(native._PKG), "native",
                                                  "midi_decode.cpp"))
    assert nd.get_lib()._name == os.path.join(native.BUILD_DIR, f"libmidi_{digest}.so")


class _FakeLog:
    def __init__(self, preamble):
        self.lines = list(preamble)
        self.path = None

    def flush(self):
        pass


class _FakeSim:
    """Just enough Sim surface for the decoders and ``materialize_records``."""

    def __init__(self, preamble, values, ids, servers, kinds):
        self.log = _FakeLog(preamble)
        self._pending_records = (np.asarray(values, np.float64), np.asarray(ids, np.int64),
                                 np.asarray(servers, np.int32), np.asarray(kinds, np.uint8))
        self._pending_offset = 0

    def music_lines(self, limit=None):
        native.materialize_records(self, limit)
        return self.log.lines


def _assert_v2(sim, instr, notes, g2tail, start, end, tmp_path):
    """Port native == JAX native == the port's Python generator. The native
    decoders only read the records, so they go first; ``music_lines``
    formats them for the Python path."""
    ours = nd.decode_records_v2(sim, instr, notes, g2tail, start, end)
    ref = jax_nd.decode_records_v2(sim, instr, notes, g2tail, start, end)
    assert ours is not None and ref is not None
    py = process_adjsim_log_v2(instruments=instr, note_levels=notes, gen2_output=g2tail,
                               count=1, start=start, end=end, generate=False,
                               lines=sim.music_lines(limit=5001), out_dir=str(tmp_path),
                               force_roll=True)
    for a, b, c in zip(ours, ref, py, strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    return ours[0]


def _mmgan_sim(g1, g2, tmp_path, max_sim_time, customers):
    sm, dists, instr, notes, seeds, nc = _decode_sample(g1, g2, 61, 64, 3, None)
    sim = Sim(sm, dists, [254] * 61, seeds=seeds, generate_log=True, record_history=False,
              logging_mode="Music", max_sim_time=max_sim_time, engine="native",
              log_path=str(tmp_path) + "/")
    sim.log.path = None
    sim.run(number_of_customers=min(nc, customers))
    return sim, instr, notes


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_records_v2_matches_jax_and_python(tmp_path, seed):
    rng = np.random.RandomState(seed)
    g1 = rng.rand(3, 64, 64).astype(np.float32)
    g2 = rng.rand(3, 20).astype(np.float32)
    np.random.seed(100 + seed)
    rolls = [_assert_v2(*_mmgan_sim(g1[i], g2[i], tmp_path, min(float(g2[i][5]), 0.4), 1500),
                        g2[i][10:], 100, 150, tmp_path) for i in range(3)]
    assert any(r.any() for r in rolls)


def test_decode_records_v2_crop_quirk_small_end(tmp_path):
    """end < 128 takes the pitch-axis crop branch: the (128, end - start)
    roll is cropped again to [start:end]."""
    rng = np.random.RandomState(9)
    g1, g2 = rng.rand(64, 64).astype(np.float32), rng.rand(20).astype(np.float32)
    np.random.seed(9)
    sim, instr, notes = _mmgan_sim(g1, g2, tmp_path, 0.3, 800)
    assert _assert_v2(sim, instr, notes, g2[10:], 10, 60, tmp_path).shape == (128, 40)


def _edge_records():
    """tests/test_native_decode.py's hand-made records: scientific-notation
    reprs, negatives, zero times, processing/delayed kinds, a None server,
    the skip moduli, a duplicate note_on, off-times past 200, the
    midi_time < 200 gate and an orphan departure."""
    recs = [(0.0, 6, 1, 0), (1.5, 10, 2, 0), (2.25, 10, 2, 2), (5e-05, 6, 3, 0), (1e16, 6, 3, 0),
            (-1.0, 6, 3, 0), (3.0, 6, 3, 1), (3.0, 6, 3, 3), (3.5, 6, -1, 0), (4.0, 7, 4, 0),
            (5.0, 12, 5, 0), (6.5, 12, 5, 2), (7.0, 10, 2, 0), (8.0, 10, 2, 0),
            (150.0, 20, 6, 0), (199.0, 20, 6, 2), (230.0, 30, 7, 0), (9.0, 10, 0, 2)]
    return [list(col) for col in zip(*recs)]


def test_decode_records_v2_regex_and_cleanup_edge_cases(tmp_path):
    g2tail = np.asarray([0.31, 0.52, 0.73, 0.66, 0.45, 0.38, 0, 0, 0, 0], np.float32)
    instruments = np.arange(8, dtype=np.float64) * 3.0
    note_levels = (np.arange(8, dtype=np.float64) * 7.0 + 30.0) % 128
    sim = _FakeSim(["INFO:root:3 branch method set as shortest queue"], *_edge_records())
    _assert_v2(sim, instruments, note_levels, g2tail, 100, 150, tmp_path)
    # ineligible in both packages: no pending records (not run natively),
    # or a node id past the note levels
    unrun = _FakeSim([], [], [], [], [])
    unrun._pending_records = None
    assert nd.decode_records_v2(unrun, instruments, note_levels, g2tail, 100, 150) is None
    short = _FakeSim([], *_edge_records())
    for decode in (nd.decode_records_v2, jax_nd.decode_records_v2):
        assert decode(short, instruments[:5], note_levels[:5], g2tail, 100, 150) is None


def test_decode_records_v2_respects_line_budget(tmp_path):
    """A 4998-line preamble leaves room for exactly 2 of the 4 records."""
    g2tail = np.asarray([0.31, 0.52, 0.73, 0.66, 0.45, 0.38], np.float32)
    sim = _FakeSim(["INFO:root:x"] * 4998, [1.0, 2.0, 3.0, 4.0], [10] * 4, [1, 1, 2, 2],
                   [0, 2, 0, 2])
    roll = _assert_v2(sim, np.zeros(4), np.asarray([60.0, 62.0, 64.0, 65.0]), g2tail, 100, 150,
                      tmp_path)
    assert roll.shape == (128, 50)


@pytest.mark.parametrize("pcn,tag", [(False, "v1"), (True, "v0")])
def test_decode_records_v1_matches_jax_and_python(tmp_path, pcn, tag):
    """``output.mid`` bytes equal across the port's native decoder, the JAX
    package's and the port's v1/v0 generator; the event arrays equal
    ``midi_to_event_arrays`` of that file, over GAN-DES sims. Without an
    ``out_path`` both of the port's decoders write nothing and give the same
    events and MIDI."""
    procfn = process_adjsim_log_v0 if pcn else process_adjsim_log_v1
    events = 0
    for seed in range(2):
        np.random.seed(seed)
        mat = np.abs(np.random.rand(20, 20)).astype(np.float32)
        sm, dists, instr, notes = _decode_gandes_sample(mat, 20, 5, None)
        np.random.seed(np.random.randint(0, 99999, size=1))
        seeds = np.random.randint(0, 99999, size=1)
        sim = Sim(sm, dists, [254] * 15, seeds=seeds, generate_log=True, logging_mode="Music",
                  max_sim_time=0.5, engine="native", log_path=str(tmp_path) + "/")
        sim.log.path = None
        sim.run(number_of_customers=1000)

        paths = {k: str(tmp_path / f"{k}_{seed}_{tag}.mid") for k in ("ours", "jax", "py")}
        ours = nd.decode_records_v1(sim, instr, notes, paths["ours"], program_change_per_note=pcn)
        ref = jax_nd.decode_records_v1(sim, instr, notes, paths["jax"],
                                       program_change_per_note=pcn)
        assert ours is not None and ref is not None
        unwritten = nd.decode_records_v1(sim, instr, notes, None, program_change_per_note=pcn)
        _, mid = procfn(instruments=instr, note_levels=notes, lines=sim.music_lines(limit=5001),
                        out_path=paths["py"], return_mid=True)
        path, mid_unwritten = procfn(instruments=instr, note_levels=notes,
                                     lines=sim.music_lines(limit=5001), out_path=None,
                                     return_mid=True)
        files = {k: open(p, "rb").read() for k, p in paths.items()}
        assert files["ours"] == files["jax"] == files["py"]
        assert path is None and unwritten[0] is None and mid_unwritten._encode() == files["py"]
        for a, b in zip(unwritten[1], ours[1], strict=True):
            np.testing.assert_array_equal(a, b)
        py_events = midi_to_event_arrays(mid, 1024)
        for a, b, c in zip(ours[1], ref[1], py_events, strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        events += ours[1][5]
    assert events > 0
