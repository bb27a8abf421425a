"""MM-GAN matrix -> DES -> piano-roll bridge (port of
``gandes_tpu/bridge/mmgan_decode.py``, sequential path).

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

The whole-batch native paths (``parallel >= 1``: ``music/native_decode.py``
and ``mmgan_host_batch``) are not ported yet and raise.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from gandes_tpu_torch.des import native
from gandes_tpu_torch.des.engine import Sim
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

    if parallel and parallel >= 1:
        raise NotImplementedError(
            "matrix_to_midi(parallel>=1) needs music/native_decode.py and the batch "
            "paths, which are not ported to gandes_tpu_torch yet; pass parallel=None")

    # load (on first use, build with g++) the native DES core before any
    # sim's deadline is taken: a one-time build is not sim wall time
    native.get_lib()

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
                pass
            else:
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
