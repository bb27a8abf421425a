"""The DES round trips of both families, for the benchmark's plain reference.

``_decode_sample`` and ``_decode_gandes_sample`` are frozen copies of the
JAX package's matrix decoders, which are pure NumPy and which the port
shares line for line (they consume the global numpy RNG draw for draw as
the published scripts do). The functions below run every sim on the Python
engine of ``engine.py`` (a frozen copy of the JAX package's Python DES, not
the C++ core the port runs) with no wall budget, so a sim ends by its customer
count, and decode its log with the frozen generators. This module imports no
torch, so that a pool of worker processes can run a batch's sims.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from portbench.reference.engine import Sim
from portbench.reference.generators import process_adjsim_log_v2

NO_BUDGET = float("inf")


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


def _python_sim(sim_matrix, distributions, dim, seeds):
    sim = Sim(sim_matrix, distributions, [2 * 127] * dim, seeds=seeds, log_path="",
              generate_log=True, record_history=False, logging_mode="Music",
              max_sim_time=NO_BUDGET, engine="python")
    sim.log.path = None  # lines in memory only
    return sim


def mmgan_generate_midi(mat, vec, seed: int, adj_size=(64, 64), instrument=0, start=100,
                        end=150) -> bytes | None:
    """The MIDI bytes that one MM-GAN sample of a request decodes to: the
    service seeds the global RNG with ``seed`` and decodes with
    ``generate=True`` (``generation.mid``). ``mat`` (A, A) and ``vec`` (20,)
    are G1's and G2's outputs as float32 numpy arrays."""
    num_aug = 3
    size = adj_size[0]
    dim = size - num_aug
    np.random.seed(seed)
    sim_matrix, distributions, _instr, note_levels, seeds, num_customers = _decode_sample(
        np.asarray(mat), np.asarray(vec), dim, size, num_aug, instrument)
    sim = _python_sim(sim_matrix, distributions, dim, seeds)
    sim.run(number_of_customers=num_customers)
    with tempfile.TemporaryDirectory() as tmp:
        process_adjsim_log_v2(instruments=np.array([instrument] * dim), note_levels=note_levels,
                              gen2_output=np.asarray(vec)[10:], count=0, start=start, end=end,
                              generate=True, lines=sim.music_lines(), out_dir=tmp)
        path = os.path.join(tmp, "generation.mid")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()


def _roll_of_sim(task):
    """One sample of the training host stage, from its decoded network on: its
    sim routed on its own stream, and its roll where the save gate passes."""
    (sim_matrix, distributions, dim, seeds, num_customers, routing_seed, note_levels, gen2,
     count, instrument, start, end) = task
    sim = _python_sim(sim_matrix, distributions, dim, seeds)
    np.random.set_state(np.random.RandomState(routing_seed).get_state())
    sim.run(number_of_customers=num_customers)
    lines = sim.music_lines()
    if min(len(lines), 5001) % 100 != 0:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        roll, durations, _ = process_adjsim_log_v2(
            instruments=np.array([instrument] * dim), note_levels=note_levels,
            gen2_output=gen2, count=count, start=start, end=end, generate=False,
            lines=lines[:5001], out_dir=tmp)
    return roll, durations


def mmgan_host_stage(mats, vecs, rng_state, count: int, adj_size=(64, 64), instrument=0,
                     start=100, end=150, pool=None):
    """A training batch's fake rolls as the loop's whole-batch host stage makes
    them at ``des_parallel > 1`` in ``g_update='none'``: every matrix decoded
    on the global stream (set to ``rng_state`` first), a private routing seed
    drawn after each, every sim routed on its own stream, and a roll decoded
    only where the log's line count passes the published save gate (a
    multiple of 100). ``pool`` (an executor) runs the sims. Returns ((B, 2,
    128, end - start) float64 rolls, the wall budgets)."""
    num_aug = 3
    size = adj_size[0]
    dim = size - num_aug
    saved = np.random.get_state()
    np.random.set_state(rng_state)
    tasks = []
    for index, (mat, vec) in enumerate(zip(mats, vecs)):
        sim_matrix, distributions, _i, note_levels, seeds, num_customers = _decode_sample(
            np.asarray(mat), np.asarray(vec), dim, size, num_aug, instrument)
        tasks.append((sim_matrix, distributions, dim, seeds, num_customers,
                      int(np.random.randint(0, 2**31 - 1)), note_levels,
                      np.asarray(vec)[10:], count if index == 0 else 1, instrument, start, end))
    np.random.set_state(saved)
    rolls = np.zeros((len(mats), 2, 128, end - start))
    for index, out in enumerate((pool.map if pool is not None else map)(_roll_of_sim, tasks)):
        if out is not None:
            rolls[index, 0], rolls[index, 1] = out
    return rolls, [min(float(v[5]), 1.0) for v in vecs]
