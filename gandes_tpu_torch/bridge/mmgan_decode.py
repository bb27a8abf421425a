"""MM-GAN matrix -> DES -> piano-roll bridge (port of
``gandes_tpu/bridge/mmgan_decode.py``).

API-compatible re-implementation of the reference ``matrix_to_midi``
(`MMGAN_MIDI_DES/matrix_sim_process.py:15-195`): decode a batch of 64x64
generator matrices + 20-dim gen2 parameter vectors into queueing networks,
run the seeded DES under a wall-clock watchdog, and decode each event log
into a (2, 128, end-start) piano roll.

Decode semantics preserved exactly (all feed the same global-RNG sequence):

* the source-selection threshold compare is DEAD CODE — the reference's
  ``len(sources[0] == dim)`` is truthy for any non-empty result, so sources
  are *always* ``np.random.choice(dim, dim // 4, replace=False)``
  (reference :43-47);
* row repair adds the row deficit to a random nonzero off-diagonal
  (reference :102) and raises if a row has none;
* global numpy RNG is reseeded per sample from itself (reference :114-115)
  and the replication seed drawn from it;
* customers = max(1000, 3000*gen2[6]); sim wall budget min(gen2[5], 1.0) s.

The reference wraps each sim in a 2.5 s watchdog ``threading.Thread`` and
*leaks* the thread on timeout (:159-168). The sim runs inline here with a
cooperative absolute deadline — timeouts yield the same blank-roll +
failed-count behavior without zombie threads.

``parallel=N`` (fast mode, needs the native engine + float32 inputs) runs
the WHOLE batch in one C++ call (``mmgan_host_batch``: decode, routing
tables, sims, records — one GIL release, no Python objects per sample).
``parallel=1`` interleaves decode/run on the global RNG stream and is
**bit-identical to the sequential path**, post-call RNG state included.
``parallel>1`` decodes the batch first, draws one private routing seed per
sample from the global stream, and runs the sims on C++ worker threads so
their wall budgets overlap — deterministic given the starting RNG state
(when sims terminate by customer count), but a *different* stream than the
reference's strictly-sequential global-RNG coupling: opt-in for training
throughput. There each sim stops once it has emitted the 5,100 records the
call stores, since nothing here reads past a log's first 5,001 lines
(counter ``sims_capped``). Non-f32 inputs keep the Python-thread fast path
(``_matrix_to_midi_parallel``). Both fast paths decode rolls with
``music/native_decode.py`` where it applies.
"""

from __future__ import annotations

import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gandes_tpu_torch.core.eventlog import EventLog
from gandes_tpu_torch.core.profiling import COUNTERS, span
from gandes_tpu_torch.des import native
from gandes_tpu_torch.des.engine import Sim
from gandes_tpu_torch.music import native_decode
from gandes_tpu_torch.music.generators import process_adjsim_log_v2


def _to_numpy(x):
    if hasattr(x, "detach"):  # torch
        return x.cpu().detach().numpy()
    return np.asarray(x)


def run_simulation(sim, num_customers):
    """Reference helper (`matrix_sim_process.py:12-13`)."""
    sim.run(number_of_customers=num_customers)


def _decode_sample(matrix, gen2_row, dim, size, num_aug, instrument):
    """Decode one generator matrix into (sim_matrix, distributions,
    instruments, note_levels, seeds, num_customers) — consumes the global
    numpy RNG exactly as the reference does."""
    if matrix.ndim == 3:  # (1, A, A) channel axis, as the torch models emit
        matrix = matrix[0]
    matrix = np.abs(matrix)

    # Dead-code quirk preserved: the threshold compare never selects
    # (see module docstring); sources are always a random dim//4 subset.
    sources_where = np.where(matrix[dim] > gen2_row[0])
    if len(sources_where[0]) == 0 or len(sources_where[0] == dim):
        sources = np.random.choice(dim, size=dim // 4, replace=False)
    else:  # pragma: no cover - unreachable, kept for structural parity
        sources = sources_where[0]

    servers = [x for x in np.arange(0, size - num_aug) if x not in sources]

    instruments = np.zeros(dim)
    if instrument is None:
        for i in range(dim):
            instruments[i] = int(matrix[dim + 1, i] * 126)
    else:
        instruments = np.array([instrument] * dim)

    note_levels = np.ones(dim)
    for i in range(dim):
        note_levels[i] = max(0, (int(matrix[dim + 2, i] * 126)) % 128)

    distributions = []
    for i in range(dim):
        if i in sources:
            distributions.append(["normal", np.abs(gen2_row[1] * 50), np.abs(gen2_row[2] * 50)])
        else:
            distributions.append(["normal", np.abs(gen2_row[3] * 10), np.abs(gen2_row[4] * 10)])

    sim_matrix = matrix[:dim, :dim].copy()
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

    np.random.seed(np.random.randint(0, 99999, size=1))
    seeds = np.random.randint(0, 99999, size=1)
    num_customers = max(1000, int(3000 * gen2_row[6]))
    if num_customers < 200:
        num_customers = 200
    return sim_matrix, distributions, instruments, note_levels, seeds, num_customers


def decode_path(gen1_dtype, parallel) -> str:
    """The host stage :func:`matrix_to_midi` takes for G1 outputs of numpy
    dtype ``gen1_dtype`` at ``parallel`` (the JAX package's dispatch,
    ``gandes_tpu/bridge/mmgan_decode.py:158-176``): ``"native batch"`` (one
    C++ call for the whole batch; float32 only), ``"threads"`` (other
    dtypes at ``parallel > 1``) or ``"sequential"``."""
    if parallel and parallel >= 1 and native.native_available():
        if np.dtype(gen1_dtype) == np.float32:
            return "native batch"
        if parallel > 1:
            return "threads"
    return "sequential"


def matrix_to_midi(
    gen1_output,
    gen2_output,
    adj_size=(32, 32),
    instrument=None,
    start=0,
    end=150,
    count=0,
    generate=False,
    *,
    log_path="logs/",
    out_dir="./adj_sim_outputs/midi",
    watchdog=2.5,
    write_log_file=True,
    parallel=None,
    skip_trivial_decode=True,
    force_roll=False,
):
    num_aug = 3
    start = int(start)
    end = int(end)
    size = adj_size[0]
    dim = size - num_aug

    gen1_output = _to_numpy(gen1_output)
    gen2_output = _to_numpy(gen2_output)

    # load (on first use, build with g++) the native DES core before any
    # sim's deadline is taken: a one-time build is not sim wall time
    native.get_lib()

    path = decode_path(gen1_output.dtype, parallel)
    if path != "sequential":
        # the fast paths' record decoder too, before their first timed sim
        native_decode.get_lib()
        if path == "native batch":
            # single C++ round trip for the whole batch (decode + tables +
            # sims in one GIL release). parallel == 1 routes on the global
            # stream and is BIT-IDENTICAL to the sequential path below;
            # parallel > 1 runs the sims on C++ worker threads with private
            # routing streams so their wall budgets overlap on the clock.
            result = _matrix_to_midi_batch(
                gen1_output, gen2_output, dim, size, num_aug, instrument,
                start, end, count, generate, out_dir, watchdog,
                parallel, skip_trivial_decode, force_roll,
            )
            if result is not None:
                return result
            # decode error (empty repair row): global RNG was restored —
            # fall through so the sequential path raises the reference's
            # ValueError at the same sample
        else:
            return _matrix_to_midi_parallel(
                gen1_output, gen2_output, dim, size, num_aug, instrument,
                start, end, count, generate, log_path, out_dir, watchdog,
                parallel, skip_trivial_decode, force_roll,
            )

    midi_rolls = []
    failed_simulations = 0

    for index, matrix in enumerate(gen1_output):
        sim_matrix, distributions, instruments, note_levels, seeds, num_customers = _decode_sample(
            matrix, gen2_output[index], dim, size, num_aug, instrument
        )
        queue_list = [2 * 127] * dim

        this_count = 1
        if index == 0:
            this_count = count

        deadline = time.time() + watchdog
        sim = Sim(
            sim_matrix, distributions, queue_list, seeds=seeds, log_path=log_path,
            generate_log=True, animation=False, record_history=False,
            logging_mode="Music", max_sim_time=min(float(gen2_output[index][5]), 1.0),
            deadline=deadline,
        )

        output = np.zeros((2, 128, end - start))
        sim_died = False
        try:
            run_simulation(sim, num_customers)
        except Exception:
            # the reference's watchdog thread swallows in-sim exceptions
            # (prints the traceback, thread ends) and the caller then
            # decodes whatever partial log exists — reproduce that.
            traceback.print_exc()
            sim_died = True
        try:
            if not sim_died and time.time() > deadline:
                # reference: watchdog join(2.5) expired -> blank roll
                print("Simulation took too long, stopping")
                failed_simulations += 1
            elif (skip_trivial_decode and not generate and not force_roll
                    and min(sim.log_line_count(), 5001) % 100 != 0):
                # parity-EXACT shortcut: with generate=False and a line
                # count not divisible by 100, the reference's save gate
                # (sim_log_to_midi.py:268-272) leaves the in-memory
                # MidiFile trackless, so the decoded roll is all zeros —
                # no need to run the generator at all.
                COUNTERS.add(decodes_skipped=1)
            else:
                COUNTERS.add(rolls_decoded=1)
                roll, durations, _ = process_adjsim_log_v2(
                    instruments=instruments, note_levels=note_levels,
                    gen2_output=gen2_output[index][10:], count=this_count,
                    start=start, end=end, generate=generate,
                    lines=sim.music_lines() if not write_log_file else None,
                    log_file=log_path + "simulation.log", out_dir=out_dir,
                    force_roll=force_roll,
                )
                if roll is None:  # pragma: no cover - defensive, as reference :173
                    failed_simulations += 1
                    midi_rolls.append(output)
                    continue
                output[0] = roll
                output[1] = durations
        except Exception:
            # reference :180-183 prints, counts, and re-raises as ValueError
            print("Error in simulation thread, using blank piano roll instead.")
            failed_simulations += 1
            raise ValueError("Error in simulation thread, using blank piano roll instead.")

        del sim
        midi_rolls.append(output)

    return midi_rolls, failed_simulations


class _BatchSimShim:
    """Just enough of ``Sim``'s log surface for the record decoders:
    ``log.lines`` starts with the shortest-queue notice lines (emitted by
    ``Sim.__init__`` in the sequential path) and the native records are
    pending, so ``music_lines()``/``log_line_count()``/
    ``decode_records_v2`` all work through the same code paths."""

    def __init__(self, notice_nodes, records, emitted):
        self.log = EventLog(None)
        self.log.lines.extend(
            f"INFO:root:{int(i)} branch method set as shortest queue"
            for i in notice_nodes
        )
        self._pending_records = records
        self._pending_offset = 0
        self._pending_total = int(emitted)
        self._dropped_records = self._pending_total - len(records[0])

    log_line_count = Sim.log_line_count
    music_lines = Sim.music_lines


def _matrix_to_midi_batch(gen1_output, gen2_output, dim, size, num_aug,
                          instrument, start, end, count, generate, out_dir,
                          watchdog, n_threads, skip_trivial_decode,
                          force_roll):
    """Single-native-call fast mode (see matrix_to_midi dispatch). Returns
    None on a decode error, with the global RNG already restored."""
    g1 = gen1_output
    if g1.ndim == 4:  # (B, 1, A, A) channel axis, as the torch models emit
        g1 = g1[:, 0]
    B = len(g1)
    with span("des.batch", sims=B) as s:
        res = native.host_batch(g1, gen2_output, size=size, num_aug=num_aug,
                                instrument=instrument, watchdog=watchdog,
                                n_threads=n_threads)
        if res is None:
            return None
        timed_out, events = int(res["timed_out"].sum()), int(res["emitted"].sum())
        capped = int(res["capped"].sum())
        COUNTERS.add(sims_run=B, sims_timed_out=timed_out, sims_capped=capped,
                     des_events=events)
        s.set(timed_out=timed_out, capped=capped, events=events)

    midi_rolls = []
    failed = n_decoded = n_skipped = 0
    with span("des.decode") as s:
        for index in range(B):
            output = np.zeros((2, 128, end - start))
            if res["timed_out"][index]:
                print("Simulation took too long, stopping")
                failed += 1
                midi_rolls.append(output)
                continue
            n_notices = int(res["notice_counts"][index])
            line_count = n_notices + int(res["emitted"][index])
            gate_saves = min(line_count, 5001) % 100 == 0
            if (skip_trivial_decode and not generate and not force_roll
                    and not gate_saves):
                # parity-exact zero-roll shortcut (see sequential path)
                n_skipped += 1
                midi_rolls.append(output)
                continue
            n_decoded += 1
            n = int(res["stored"][index])
            records = tuple(a[index, :n] for a in res["records"])
            sim = _BatchSimShim(
                res["notice_nodes"][index, :n_notices], records,
                res["emitted"][index])
            if instrument is None:
                instruments = res["instruments"][index]
            else:
                instruments = np.array([instrument] * dim)  # int dtype, as ref
            note_levels = res["note_levels"][index]
            try:
                decoded = None
                if force_roll and not generate and not gate_saves:
                    # in-memory roll only: native record decoder first
                    decoded = native_decode.decode_records_v2(
                        sim, instruments, note_levels, gen2_output[index][10:],
                        start, end)
                if decoded is None:
                    decoded = process_adjsim_log_v2(
                        instruments=instruments, note_levels=note_levels,
                        gen2_output=gen2_output[index][10:],
                        count=(count if index == 0 else 1), start=start, end=end,
                        generate=generate, lines=sim.music_lines(limit=5001),
                        out_dir=out_dir, force_roll=force_roll)
                roll, durations, _ = decoded
                if roll is None:  # pragma: no cover - defensive, as reference :173
                    failed += 1
                    midi_rolls.append(output)
                    continue
                output[0] = roll
                output[1] = durations
            except Exception:
                print("Error in simulation thread, using blank piano roll instead.")
                failed += 1
                raise ValueError(
                    "Error in simulation thread, using blank piano roll instead.")
            midi_rolls.append(output)
        COUNTERS.add(rolls_decoded=n_decoded, decodes_skipped=n_skipped)
        s.set(decoded=n_decoded, skipped=n_skipped)
    return midi_rolls, failed


def _matrix_to_midi_parallel(gen1_output, gen2_output, dim, size, num_aug,
                             instrument, start, end, count, generate,
                             log_path, out_dir, watchdog, parallel,
                             skip_trivial_decode=True, force_roll=False):
    """Fast mode: sequential decode, concurrent native sims, sequential
    log decode. See module docstring for the RNG-stream caveat."""
    B = len(gen1_output)
    sims, metas = [], []
    for index, matrix in enumerate(gen1_output):
        sim_matrix, distributions, instruments, note_levels, seeds, num_customers = _decode_sample(
            matrix, gen2_output[index], dim, size, num_aug, instrument
        )
        routing_seed = int(np.random.randint(0, 2**31 - 1))
        sim = Sim(
            sim_matrix, distributions, [2 * 127] * dim, seeds=seeds,
            log_path=log_path, log_name=f"simulation.{index}.log",
            generate_log=True, record_history=False, logging_mode="Music",
            max_sim_time=min(float(gen2_output[index][5]), 1.0),
            engine="native",
        )
        sim.log.path = None  # in-memory only; no per-sample file artifacts
        sim.routing_rng = np.random.RandomState(routing_seed)
        sims.append(sim)
        metas.append((instruments, note_levels, num_customers))

    timed_out = [False] * B
    # rolls decoded inside the workers, overlapped with still-running sims
    # (the native engine releases the GIL, so the GIL-bound Python decode of
    # finished sims rides under the remaining sims' wall budgets). Only
    # in-memory decodes are eligible — decodes that write MIDI artifacts
    # (generate=True, or the lines%100==0 save gate) stay sequential below
    # so the last-written-file semantics match the reference's ordering.
    early_rolls: list = [None] * B
    early_errors: list = [None] * B

    def worker(i):
        t0 = time.time()
        sims[i].deadline = t0 + watchdog
        try:
            run_simulation(sims[i], metas[i][2])
            timed_out[i] = time.time() - t0 > watchdog
        except Exception as e:  # matches the swallowed-thread semantics
            traceback.print_exc()
            return e
        if (force_roll and not generate and not timed_out[i]
                and min(sims[i].log_line_count(), 5001) % 100 != 0):
            try:
                # native record-array decoder first (no string formatting,
                # no regex; bit-identical rolls), Python decoder fallback
                early_rolls[i] = native_decode.decode_records_v2(
                    sims[i], metas[i][0], metas[i][1], gen2_output[i][10:],
                    start, end,
                )
                if early_rolls[i] is None:
                    early_rolls[i] = process_adjsim_log_v2(
                        instruments=metas[i][0], note_levels=metas[i][1],
                        gen2_output=gen2_output[i][10:], count=1, start=start,
                        end=end, generate=False,
                        lines=sims[i].music_lines(limit=5001),
                        out_dir=out_dir, force_roll=True,
                    )
            except Exception as e:
                early_errors[i] = e
        return None

    with ThreadPoolExecutor(max_workers=min(parallel, B)) as pool:
        errors = list(pool.map(worker, range(B)))

    midi_rolls = []
    failed = 0
    for index, sim in enumerate(sims):
        instruments, note_levels, _num = metas[index]
        output = np.zeros((2, 128, end - start))
        if errors[index] is None and timed_out[index]:
            print("Simulation took too long, stopping")
            failed += 1
            midi_rolls.append(output)
            continue
        if (skip_trivial_decode and not generate and not force_roll
                and min(sim.log_line_count(), 5001) % 100 != 0):
            # parity-exact zero-roll shortcut (see sequential path)
            COUNTERS.add(decodes_skipped=1)
            midi_rolls.append(output)
            continue
        COUNTERS.add(rolls_decoded=1)
        try:
            if early_errors[index] is not None:
                raise early_errors[index]
            if early_rolls[index] is not None:
                roll, durations, _ = early_rolls[index]
            else:
                roll, durations, _ = process_adjsim_log_v2(
                    instruments=instruments, note_levels=note_levels,
                    gen2_output=gen2_output[index][10:],
                    count=(count if index == 0 else 1), start=start, end=end,
                    generate=generate, lines=sim.music_lines(limit=5001),
                    out_dir=out_dir, force_roll=force_roll,
                )
            output[0] = roll
            output[1] = durations
        except Exception:
            print("Error in simulation thread, using blank piano roll instead.")
            failed += 1
            raise ValueError("Error in simulation thread, using blank piano roll instead.")
        midi_rolls.append(output)
    return midi_rolls, failed
