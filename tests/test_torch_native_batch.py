"""The port's whole-batch native host stage vs its sequential path and vs the
JAX package, on the CPU.

* ``matrix_to_midi(parallel=1)`` (one ``mmgan_host_batch`` call routing on
  the global stream) is bit-identical to the port's sequential path: rolls,
  failure counts and the global numpy RNG state after the call, over
  ``tests/test_native_batch.py``'s four ``(force_roll, instrument)`` cases.
* ``parallel`` 1 and 2 give the JAX package's rolls from the same seed;
  float64 inputs take the Python-thread path (``_matrix_to_midi_parallel``)
  in both packages; a decode error raises the sequential path's
  ``ValueError`` in every mode.
* The port's engine is its own copy, ``des/csrc/des_engine.cpp``. At
  ``parallel > 1`` its batch call stops each sim once it has emitted the
  5,100 records the call stores, where the JAX package's runs the sim to its
  customer count: the stored records, rolls, failures and post-call RNG
  state are the JAX package's all the same, and ``sims_capped`` counts the
  stopped sims. Sims that end below 5,100 records, ``parallel=1`` and
  ``Sim.run`` (``des_run``) run to their customer counts, as in the JAX
  package.
* ``matrix_to_wav(parallel=2)`` (native v1 decode, synth, mel) against the
  JAX package's at the GAN-DES serving tolerances
  (``tests/test_torch_gandes_serve.py``): 0.05 dB on bins more than 10 dB
  above the floor, 0.2 dB on every bin, at most 2e-4 int16 samples
  truncated to the other step.
* The training loop with ``des_parallel=2`` against the JAX loop's is a
  case of ``tests/test_torch_mmgan_train.py::test_loop_histories_match_jax``,
  which shares that module's JAX state and draws.

Inputs stay in the light-sim band of ``tests/test_native_batch.py`` (sims
end by customer count, far inside their wall budgets), at most two sim
threads. Those sims emit 30,000-66,000 records each; the "heavy" inputs
raise the customers to 3,000 (``gen2[6]``, 80,000-160,000 records, ~0.1 s
for three sims on one core against a 1 s budget), the "short" ones slow
the servers and the sources (``gen2[1:5]``) so that each sim emits fewer
than 5,100 records.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from gandes_tpu.bridge import gandes_decode as jax_gandes_decode
from gandes_tpu.bridge import mmgan_decode as jax_mmgan_decode
from gandes_tpu.des import native as jax_native
from gandes_tpu.des.engine import Sim as JaxSim
from gandes_tpu_torch.bridge import mmgan_decode
from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
from gandes_tpu_torch.core.profiling import COUNTERS
from gandes_tpu_torch.des import native
from gandes_tpu_torch.des.engine import Sim
from gandes_tpu_torch.music import native_decode

RECORD_LIMIT = 5100  # the records host_batch stores of each sim
DB_ATOL = 0.05
FLOOR_DB_ATOL = 0.2
FLIP_SHARE = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _native_libs_loaded():
    """Both packages' DES cores and record decoders load before any sim runs
    under a wall budget."""
    assert jax_native.get_lib() is not None and native.get_lib() is not None
    assert native_decode.native_decode_available()


def _inputs(seed, B, sims="light"):
    rng = np.random.RandomState(seed)
    g1 = rng.rand(B, 1, 64, 64).astype(np.float32)
    g2 = rng.rand(B, 20).astype(np.float32) * 0.5 + 0.2
    if sims == "heavy":
        g2[:, 5] = 1.0  # the most wall budget a sim has
        g2[:, 6] = 1.0  # 3,000 customers
    elif sims == "short":
        g2[:, 1:5] = (0.05, 0.0125, 1.0, 0.25)  # arrivals every ~2.5, service ~10
    return g1, g2


def _spy(module):
    """Patch ``module.host_batch`` to keep each call's result in a list."""
    results = []
    real = module.host_batch

    def call(*args, **kw):
        results.append(real(*args, **kw))
        return results[-1]

    return mock.patch.object(module, "host_batch", side_effect=call), results


def _sample_records(res, b):
    """Sample ``b``'s stored records: the port's rows, the JAX package's
    slices of its concatenated arrays."""
    if "stored" in res:
        return [a[b, :res["stored"][b]] for a in res["records"]]
    lo, hi = int(res["offsets"][b]), int(res["offsets"][b + 1])
    return [a[lo:hi] for a in res["records"]]


def _rng_state():
    s = np.random.get_state()
    return tuple(s[1]), s[2], s[3], s[4]


def _decode(fn, g1, g2, seed, **kw):
    """``fn``'s rolls, failures and the global RNG state after it, from
    ``np.random.seed(seed)``."""
    np.random.seed(seed)
    rolls, failed = fn(g1, g2, adj_size=(64, 64), start=100, end=150, **kw)
    return rolls, failed, _rng_state()


def _assert_same(a, b):
    assert a[1] == b[1]
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("force_roll,instrument,sims", [
    pytest.param(False, 0, "light", id="False-0"), pytest.param(True, 0, "light", id="True-0"),
    pytest.param(False, None, "light", id="False-None"),
    pytest.param(True, None, "light", id="True-None"),
    (False, None, "heavy"), (True, None, "heavy")])
def test_parallel_1_bitwise_equals_sequential(tmp_path, force_roll, instrument, sims):
    """At ``parallel=1`` the sims route on the global stream, so the batch
    call runs every one to its customer count, as the JAX package's does."""
    g1, g2 = _inputs(11, 3, sims)
    kw = dict(instrument=instrument, force_roll=force_roll, log_path=str(tmp_path) + "/")
    spy, ours = _spy(native)
    before = COUNTERS.snapshot()
    with spy:
        batch = _decode(mmgan_decode.matrix_to_midi, g1, g2, 17, parallel=1,
                        out_dir=str(tmp_path / "m1"), **kw)
    assert COUNTERS.since(before)["sims_capped"] == 0
    seq = _decode(mmgan_decode.matrix_to_midi, g1, g2, 17, parallel=None,
                  out_dir=str(tmp_path / "m2"), **kw)
    _assert_same(batch, seq)
    assert batch[2] == seq[2], "global RNG stream diverged"
    if force_roll:
        assert sum(r.any() for r in batch[0]) == 3
    if sims == "heavy":
        spy, ref = _spy(jax_native)
        with spy:
            _decode(jax_mmgan_decode.matrix_to_midi, g1, g2, 17, parallel=1,
                    out_dir=str(tmp_path / "m3"), **kw)
        (ours,), (ref,) = ours, ref
        assert not ours["capped"].any()
        np.testing.assert_array_equal(ours["emitted"], ref["emitted"])
        assert ours["emitted"].min() > 10 * RECORD_LIMIT


@pytest.mark.parametrize("parallel,force_roll,sims", [
    pytest.param(1, True, "light", id="1"), pytest.param(2, True, "light", id="2"),
    (2, False, "heavy"), (2, True, "heavy"), (2, True, "short")])
def test_parallel_matches_jax(tmp_path, parallel, force_roll, sims):
    """The same ``parallel`` from the same seed: the JAX package's rolls,
    failures and post-call RNG state, through the whole-batch call. At
    ``parallel=2`` a sim past 5,100 records stops there (the JAX package's
    runs on): its stored records are the JAX call's, its ``emitted`` passes
    the limit by at most one event's records, and ``sims_capped`` counts it.
    A sim that ends below the limit emits what the JAX engine's does."""
    B = 3
    g1, g2 = _inputs(21, B, sims)
    kw = dict(instrument=None, force_roll=force_roll, parallel=parallel,
              log_path=str(tmp_path) + "/")
    spy, ours = _spy(native)
    before = COUNTERS.snapshot()
    with spy, mock.patch.object(mmgan_decode, "_matrix_to_midi_parallel",
                                side_effect=AssertionError("not the batch path")):
        out = _decode(mmgan_decode.matrix_to_midi, g1, g2, 33, out_dir=str(tmp_path / "a"), **kw)
    grew = COUNTERS.since(before)
    spy, ref = _spy(jax_native)
    with spy:
        ref_out = _decode(jax_mmgan_decode.matrix_to_midi, g1, g2, 33,
                          out_dir=str(tmp_path / "b"), **kw)
    _assert_same(out, ref_out)
    assert out[2] == ref_out[2]
    if force_roll:
        assert sum(r.any() for r in out[0]) == B

    (ours,), (ref,) = ours, ref
    capped = (ref["emitted"] >= RECORD_LIMIT) & (parallel > 1)
    assert capped.all() == (parallel > 1 and sims != "short") and capped.any() == capped.all()
    assert grew["sims_capped"] == int(ours["capped"].sum()) == int(capped.sum())
    assert grew["des_events"] == int(ours["emitted"].sum())
    for b in range(B):
        if capped[b]:
            assert ours["capped"][b] == 1
            assert RECORD_LIMIT <= ours["emitted"][b] <= RECORD_LIMIT + 3
        else:
            assert ours["capped"][b] == 0 and ours["emitted"][b] == ref["emitted"][b]
        for a, r in zip(_sample_records(ours, b), _sample_records(ref, b), strict=True):
            np.testing.assert_array_equal(a, r)
    for key in ("timed_out", "customers", "notice_nodes", "notice_counts", "instruments",
                "note_levels"):
        np.testing.assert_array_equal(ours[key], ref[key])


def test_f64_inputs_take_the_thread_path(tmp_path):
    """float64 generator outputs decode in float64: the f32 native batch must
    not take them. Both packages run ``_matrix_to_midi_parallel`` and agree."""
    g1, g2 = _inputs(3, 2)
    g1 = g1.astype(np.float64)
    kw = dict(instrument=0, force_roll=True, parallel=2, log_path=str(tmp_path) + "/",
              out_dir=str(tmp_path))
    with mock.patch.object(mmgan_decode, "_matrix_to_midi_parallel",
                           wraps=mmgan_decode._matrix_to_midi_parallel) as spy, \
            mock.patch.object(native, "host_batch", side_effect=AssertionError("batch path")):
        ours = _decode(mmgan_decode.matrix_to_midi, g1, g2, 5, **kw)
    assert spy.call_count == 1
    _assert_same(ours, _decode(jax_mmgan_decode.matrix_to_midi, g1, g2, 5, **kw))


def test_decode_error_raises_like_sequential(tmp_path):
    """A row with no routing mass fails the reference decode. The batch call
    restores the RNG snapshot and the sequential path raises the same
    ValueError at the same sample, leaving the same RNG state."""
    g1, g2 = _inputs(7, 2)
    g1[1, 0, 3, :] = 0.0
    states = []
    for parallel in (1, None, 2):
        np.random.seed(9)
        with pytest.raises(ValueError):
            mmgan_decode.matrix_to_midi(g1, g2, adj_size=(64, 64), instrument=0, start=100,
                                        end=150, parallel=parallel, log_path=str(tmp_path) + "/",
                                        out_dir=str(tmp_path))
        states.append(_rng_state())
    assert states[0] == states[1] == states[2]


def test_host_batch_needs_a_record_limit():
    """The batch call writes each sample's records into a slot of
    ``record_limit`` records, so an unbounded limit is refused."""
    g1, g2 = _inputs(3, 1)
    with pytest.raises(ValueError, match="record_limit"):
        native.host_batch(g1[:, 0], g2, size=64, num_aug=3, instrument=None, watchdog=2.5,
                          n_threads=2, record_limit=-1)


def test_engine_is_built_from_the_ports_copy():
    """The port builds ``des/csrc/des_engine.cpp`` into its ``_build/`` under
    the copy's content hash; the JAX package builds the root file."""
    import hashlib

    assert native._SRC == os.path.join(native._PKG, "des", "csrc", "des_engine.cpp")
    with open(native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert native.get_lib()._name == os.path.join(native.BUILD_DIR, f"libdes_{digest}.so")
    assert not os.path.samefile(native._SRC, jax_native._SRC)


def _sim_state(sim, log_file):
    with open(log_file, "rb") as f:
        log = f.read()
    servers = {i: (s.total_time_in_service, s.total_customers_served, s.total_time_in_queue,
                   s.cumulative_queue_length, s.max_queue_length, s.reneges,
                   s.delayed_departures, s.queue_length_times)
               for i, s in sim.servers.items()}
    sources = {i: (s.arrival_times, s.customers_generated) for i, s in sim.sources.items()}
    totals = (sim.Clock, sim.previous_time, sim.total_arrival_time, sim.total_time_in_queues,
              sim.total_customers, sim.current_customers_in_system)
    return log, servers, sources, totals, repr(sim.server_seeds), repr(sim.source_seeds)


def test_run_native_with_a_log_file_matches_jax(tmp_path):
    """``Sim.run`` on the port's engine copy (``des_run``, every record kept
    for the log file) against the JAX package's engine, on a sim far past
    5,100 records: the same log bytes, statistics, seeds and global RNG
    state."""
    g1, g2 = _inputs(11, 1, "heavy")
    np.random.seed(5)
    sm, dists, _, _, seeds, customers = mmgan_decode._decode_sample(g1[0], g2[0], 61, 64, 3,
                                                                    None)
    runs = {}
    for name, cls in (("torch", Sim), ("jax", JaxSim)):
        d = str(tmp_path / name) + "/"
        sim = cls(sm, dists, [2 * 127] * 61, seeds=seeds, log_path=d, generate_log=True,
                  record_history=False, logging_mode="Music", max_sim_time=60.0,
                  engine="native")
        np.random.seed(19)
        sim.run(number_of_customers=customers)
        runs[name] = _sim_state(sim, d + "simulation.log"), _rng_state()
    assert runs["torch"][0][0].count(b"\n") > 10 * RECORD_LIMIT
    assert runs["torch"] == runs["jax"]


def test_matrix_to_wav_parallel_matches_jax(tmp_path):
    mats = np.random.RandomState(7).rand(2, 20, 20).astype(np.float32)
    runs = {}
    for name, fn, kw in (("jax", jax_gandes_decode.matrix_to_wav, {}),
                         ("torch", matrix_to_wav, {"device": "cpu"})):
        d = str(tmp_path / name)
        np.random.seed(13)
        spec = fn(mats, size=20, start=0, end=216, out_dir=d, log_path=d + "/logs/",
                  parallel=2, number_of_customers=400, max_sim_time=2.0, **kw)
        runs[name] = np.asarray(spec), d
    (ref, ref_dir), (ours, our_dir) = runs["jax"], runs["torch"]
    assert ours.shape == ref.shape == (2, 128, 216)
    with open(os.path.join(ref_dir, "midi", "output.mid"), "rb") as a, \
            open(os.path.join(our_dir, "midi", "output.mid"), "rb") as b:
        assert a.read() == b.read()
    for i in range(2):
        wa = wavfile.read(os.path.join(ref_dir, "wav", f"output_{i}.wav"))[1]
        wb = wavfile.read(os.path.join(our_dir, "wav", f"output_{i}.wav"))[1]
        assert wa.shape == wb.shape and np.abs(wa.astype(np.int32) - wb).max() <= 1
        assert np.count_nonzero(wa != wb) <= FLIP_SHARE * wa.size
        above_floor = ref[i] > ref[i].min() + 10.0
        np.testing.assert_allclose(ours[i][above_floor], ref[i][above_floor], atol=DB_ATOL)
        np.testing.assert_allclose(ours[i], ref[i], atol=FLOOR_DB_ATOL)


def test_matrix_to_wav_parallel_native_v1_matches_fallback(tmp_path):
    """The mels are the same whether the v1 decode runs natively or through
    the Python generator, and ``write_wav=False`` writes no WAV."""
    mats = np.random.RandomState(8).rand(2, 20, 20).astype(np.float32)
    kw = dict(size=20, start=0, end=216, parallel=2, write_wav=False, number_of_customers=400,
              max_sim_time=2.0, device="cpu", out_dir=str(tmp_path), log_path=str(tmp_path) + "/")
    np.random.seed(3)
    a = matrix_to_wav(mats, **kw)
    with mock.patch.object(native_decode, "decode_records_v1", return_value=None):
        np.random.seed(3)
        b = matrix_to_wav(mats, **kw)
    assert torch.equal(a, b)
    assert not os.path.exists(tmp_path / "wav")
