"""ctypes bindings + build for the native C++ DES engine.

Builds this package's ``des/csrc/des_engine.cpp`` (a copy of the
repository's ``native/des_engine.cpp`` whose MM-GAN thread-mode batch stops
each sim at its record limit) with g++ on first use (cached in this
package's ``_build/`` directory, keyed by content hash),
exposes :func:`run_native`, and
:func:`native_eligible` which gates which Sim configurations the native
core supports (the rest fall back to the Python engine transparently):

* logging_mode == 'Music' (the training/data channel; 'All' has dozens of
  verbose line kinds that aren't on the hot path),
* all seven distribution kinds incl. 'discrete' (sorted-support cumsum
  searchsorted, int-vs-float support formatting per scipy rvs dtype),
* seeds in [0, 2^32) (numpy's legacy integer seeding range).
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "des", "csrc", "des_engine.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_DIST_CODES = {
    "exponential": 0,
    "normal": 1,
    "uniform": 2,
    "gamma": 3,
    "beta": 4,
    "branch": 5,
    "queue": 6,
    "discrete": 7,
}

_lib = None
_build_failed = False


def build_native_lib(src: str, prefix: str,
                     extra_flags: tuple[str, ...] = ()) -> str | None:
    """Compile ``src`` to a content-hash-named .so in ``BUILD_DIR`` (cached)
    and return the path, or None on failure. Concurrency-safe: each build
    writes a unique tmp (pid-suffixed) and atomically os.replace()s it in,
    so racing first-use builds from worker threads/processes all end with a
    complete library. -ffp-contract=off everywhere: FMA contraction changes
    low float bits vs Python's unfused math, breaking bit parity."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{prefix}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
           "-std=c++17", *extra_flags, "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


_BUILD_LOCK = threading.Lock()


def get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None or _build_failed:
            return _lib
        path = build_native_lib(_SRC, "libdes",
                                extra_flags=("-march=native", "-pthread"))
        if path is None:
            _build_failed = True
            return None
        try:
            lib = C.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.des_run.restype = C.c_int
        lib.des_free_records.restype = None
        lib.des_format_records.restype = C.c_int64
        lib.mmgan_host_batch.restype = C.c_int
        _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def native_eligible(sim) -> bool:
    if sim.animation or sim.verbose:
        return False
    if sim.generate_log and sim.logging_mode != "Music":
        return False
    if sim.record_history and sim.generate_log:
        # the reference interleaves per-replication metric log lines with
        # event lines; the native path can't preserve that ordering
        return False
    for spec in sim.distributions:
        if spec[0] not in _DIST_CODES:
            return False
    for s in sim.seeds:
        if not (0 <= int(s) < 2**32):
            return False
    # a probability-routing row that can deliver customers to a source node
    # makes the reference/Python engine raise KeyError; the C++ core would
    # draw from an unseeded stream instead — keep such nets on Python
    for node in {**sim.servers, **sim.sources}.values():
        dest = node.destination
        if not dest.shortest_queue:
            for c in dest.children:
                if c in sim.sources:
                    return False
    return native_available()


def materialize_records(sim, limit: int | None = None) -> None:
    """Format pending native records into log lines, up to ``limit`` total
    records — in C++ (``des_format_records``): Python-repr-exact floats
    (shortest round trip + CPython's fixed/exponential layout rules),
    identical bytes to the Python engine's lines, ~15x faster than the
    former per-record f-string loop. Includes the branch/'queue'-node quirk:
    the Python engine's service_time there is the *int* 0 (str "0", not
    "0.0") — drawn times are always > 0, so a 0.0 processing value can only
    be that case."""
    pend = getattr(sim, "_pending_records", None)
    if pend is None:
        return
    values, ids, servers_l, kinds = pend
    total = len(values)
    want = total if limit is None else min(limit, total)
    off = sim._pending_offset
    if want > off:
        lib = get_lib()
        ptr = lambda a: a.ctypes.data_as(C.c_void_p)
        lines = sim.log.lines
        # chunked so the staging buffer stays small for multi-million-record
        # logs; np.empty (no zero-fill) + tobytes = one copy out
        chunk = 131072
        buf = np.empty(128 * min(chunk, want - off), np.uint8)
        for lo in range(off, want, chunk):
            hi = min(lo + chunk, want)
            nb = lib.des_format_records(ptr(values), ptr(ids), ptr(servers_l),
                                        ptr(kinds), C.c_int64(lo), C.c_int64(hi),
                                        ptr(buf), C.c_int64(len(buf)))
            if nb < 0:  # not assert: stripped under python -O, and a -1
                # return would silently index buf[:-1] into a garbled line
                raise RuntimeError("des_format_records buffer overflow")
            lines.extend(buf[:nb].tobytes().decode("ascii").split("\n"))
        sim._pending_offset = want
    if sim._pending_offset >= total:
        sim._pending_records = None


def host_batch(gen1, gen2, *, size, num_aug, instrument, watchdog,
               n_threads, record_limit=5100):
    """One C++ round trip for a whole MM-GAN batch: decode every generator
    matrix (consuming the global numpy RNG exactly like the sequential
    bridge), build the routing tables, run every sim (``n_threads == 1``:
    inline with global-stream routing — bit-identical to the sequential
    parity path; ``> 1``: C++ worker threads with private routing streams,
    the thread mode's stream discipline, each sim stopping once it has
    emitted ``record_limit`` records: every reader of the batch reads at
    most the first 5,001 log lines, and a private stream's later draws
    reach nothing, so the rolls, failures and the global RNG state are
    those of sims run to their customer counts).

    Returns ``None`` on a decode error (empty repair-candidate row) with
    the global RNG restored, so the caller can replay on the Python path
    and surface the reference's ValueError; otherwise a dict of per-sample
    arrays (records, line counts, timeout flags, the flags of the sims
    stopped at ``record_limit``, notices, instruments, note levels) with the
    global RNG advanced identically to the sequential decode+run sequence.
    ``records`` are four (B, record_limit) arrays, of which sample ``b``'s
    first ``stored[b]`` entries are its records. ``emitted`` counts the
    records a sim emitted, stored or not: a stopped sim's count passes
    ``record_limit`` by the records of its last event.
    """
    if record_limit < 0:
        raise ValueError(f"record_limit must be >= 0, got {record_limit}")
    lib = get_lib()
    B = int(len(gen1))
    dim = size - num_aug
    g1 = np.ascontiguousarray(gen1, np.float32)
    gen2_is_f32 = 1 if np.asarray(gen2).dtype == np.float32 else 0
    g2 = np.ascontiguousarray(gen2, np.float64)

    snapshot = np.random.get_state()
    g_key = np.ascontiguousarray(snapshot[1], np.uint32)
    g_pos = C.c_int(int(snapshot[2]))
    g_has_gauss = C.c_int(int(snapshot[3]))
    g_gauss = C.c_double(float(snapshot[4]))

    out_emitted = np.zeros(B, np.int64)
    out_timed_out = np.zeros(B, np.int8)
    out_capped = np.zeros(B, np.int8)
    out_customers = np.zeros(B, np.int64)
    out_notice_nodes = np.zeros((B, dim), np.int32)
    out_notice_counts = np.zeros(B, np.int64)
    out_instruments = np.zeros((B, dim), np.float64)
    out_note_levels = np.zeros((B, dim), np.float64)

    # written by the sims' threads, each into its own samples' rows
    values = np.empty((B, record_limit), np.float64)
    ids = np.empty((B, record_limit), np.int64)
    servers_l = np.empty((B, record_limit), np.int32)
    kinds = np.empty((B, record_limit), np.uint8)
    stored = np.zeros(B, np.int64)
    err_index = C.c_int32(-1)

    ptr = lambda a: a.ctypes.data_as(C.c_void_p)
    rc = lib.mmgan_host_batch(
        C.c_int(B), C.c_int(size), C.c_int(num_aug),
        ptr(g1), ptr(g2), C.c_int(g2.shape[1]), C.c_int(gen2_is_f32),
        C.c_int(-1 if instrument is None else int(instrument)),
        C.c_double(float(watchdog)), C.c_int64(record_limit),
        C.c_int(int(n_threads)),
        ptr(g_key), C.byref(g_pos), C.byref(g_has_gauss), C.byref(g_gauss),
        ptr(out_emitted), ptr(out_timed_out), ptr(out_capped), ptr(out_customers),
        ptr(out_notice_nodes), ptr(out_notice_counts),
        ptr(out_instruments), ptr(out_note_levels),
        ptr(values), ptr(ids), ptr(servers_l), ptr(kinds), ptr(stored),
        C.byref(err_index),
    )
    if rc != 0:
        np.random.set_state(snapshot)
        return None
    np.random.set_state(("MT19937", g_key, int(g_pos.value),
                         int(g_has_gauss.value), float(g_gauss.value)))

    return {
        "emitted": out_emitted, "timed_out": out_timed_out, "capped": out_capped,
        "customers": out_customers, "notice_nodes": out_notice_nodes,
        "notice_counts": out_notice_counts, "instruments": out_instruments,
        "note_levels": out_note_levels,
        "records": (values, ids, servers_l, kinds), "stored": stored,
    }


def run_native(sim, number_of_customers: int, use_next_available_server: bool):
    """Execute sim.run on the native engine. Mutates ``sim`` (stats, seeds,
    log lines) to match the Python engine's post-run state."""
    lib = get_lib()
    n = len(np.diag(sim.adj_matrix))

    node_is_source = np.zeros(n, np.int8)
    for i in sim.sources:
        node_is_source[i] = 1
    dist_kind = np.zeros(n, np.int8)
    dist_params = np.zeros((n, 4), np.float64)
    nodes_by_id = {**sim.servers, **sim.sources}
    disc_xk_flat, disc_cum_flat, disc_offsets = [], [], [0]
    disc_int = np.zeros(n, np.int8)
    for i, spec in enumerate(sim.distributions):
        dist_kind[i] = _DIST_CODES[spec[0]]
        if spec[0] == "discrete":
            # reuse the node Sampler's sorted support/cumsum so the C++
            # search walks bit-identical float64 tables
            sampler = nodes_by_id[i].sampler
            disc_xk_flat.extend(sampler._xk.tolist())
            disc_cum_flat.extend(sampler._cum.tolist())
            disc_int[i] = 1 if sampler._int_support else 0
        else:
            for j, p in enumerate(spec[1:5]):
                dist_params[i, j] = float(p)
        disc_offsets.append(len(disc_xk_flat))
    disc_xk = np.asarray(disc_xk_flat, np.float64)
    disc_cum = np.asarray(disc_cum_flat, np.float64)
    disc_offsets = np.asarray(disc_offsets, np.int64)
    queue_caps = np.asarray(sim.queue_list, np.int64)

    children_flat, cdf_flat, offsets = [], [], [0]
    route_mode = np.zeros(n, np.int8)
    is_sink = np.zeros(n, np.int8)
    nodes = {**sim.servers, **sim.sources}
    for i in range(n):
        dest = nodes[i].destination
        ch = dest.children
        children_flat.extend(int(c) for c in ch)
        if dest.shortest_queue:
            route_mode[i] = 2
            cdf_flat.extend([0.0] * len(ch))
        elif dest._p_is_exact:
            route_mode[i] = 0
            cdf = np.cumsum(np.asarray(dest.probabilities, np.float64))
            cdf = cdf / cdf[-1]
            cdf_flat.extend(cdf.tolist())
        else:
            route_mode[i] = 1
            cdf_flat.extend([0.0] * len(ch))
        is_sink[i] = 1 if dest.is_sink() else 0
        offsets.append(len(children_flat))

    children_arr = np.asarray(children_flat, np.int32)
    cdf_arr = np.asarray(cdf_flat, np.float64)
    offsets_arr = np.asarray(offsets, np.int64)
    seeds_arr = np.asarray([int(s) for s in sim.seeds], np.int64)
    num_seeds = len(seeds_arr)

    # routing RNG snapshot in/out — the numpy global stream by default
    # (reference parity), or an injected RandomState (thread-parallel fast
    # mode: each sim owns a private routing stream)
    routing_rng = getattr(sim, "routing_rng", None)
    g_state = routing_rng.get_state() if routing_rng is not None else np.random.get_state()
    g_key = np.ascontiguousarray(g_state[1], np.uint32)
    g_pos = C.c_int(int(g_state[2]))
    g_has_gauss = C.c_int(int(g_state[3]))
    g_gauss = C.c_double(float(g_state[4]))

    qlt_cap = int(min(max(int(queue_caps.max(initial=0)) + 1024, 256), 65536))
    ptr = lambda a: a.ctypes.data_as(C.c_void_p)

    out_tis = np.zeros(n, np.float64)
    out_served = np.zeros(n, np.int64)
    out_tiq = np.zeros(n, np.float64)
    out_cql = np.zeros(n, np.float64)
    out_mql = np.zeros(n, np.int64)
    out_ren = np.zeros(n, np.int64)
    out_del = np.zeros(n, np.int64)
    out_qlt = np.zeros((n, qlt_cap), np.float64)
    out_sat = np.zeros(n, np.float64)
    out_scust = np.zeros(n, np.int64)
    dealt = np.zeros((num_seeds, n), np.int64)
    out_totals = np.zeros(7, np.float64)

    # per-replication stats for record_history (metrics history parity)
    if sim.record_history:
        rep_stats = np.zeros((num_seeds, n, 9), np.float64)
        rep_totals = np.zeros((num_seeds, 4), np.float64)
        rep_qlt = np.zeros((num_seeds, n, qlt_cap), np.float64)
        rep_ptrs = (ptr(rep_stats), ptr(rep_totals), ptr(rep_qlt))
    else:
        rep_stats = rep_totals = rep_qlt = None
        null = C.c_void_p()
        rep_ptrs = (null, null, null)

    rec_values = C.POINTER(C.c_double)()
    rec_ids = C.POINTER(C.c_int64)()
    rec_servers = C.POINTER(C.c_int32)()
    rec_kinds = C.POINTER(C.c_uint8)()
    rec_count = C.c_int64(0)

    # when the log is in-memory-only, storing every record is wasted work:
    # downstream consumers read at most ~5001 lines + the total line count
    record_limit = -1 if (sim.log is not None and sim.log.path is not None) else 5100
    deadline_budget = sim.max_sim_time
    budget_binds = True  # the wall budget, not an earlier watchdog, stops the run
    if sim.deadline is not None:
        import time as _t

        left = max(sim.deadline - _t.time(), 0.0)
        budget_binds = deadline_budget <= left
        deadline_budget = min(deadline_budget, left)

    ended = lib.des_run(
        C.c_int(n), ptr(node_is_source), ptr(dist_kind), ptr(dist_params),
        ptr(queue_caps), ptr(children_arr), ptr(offsets_arr), ptr(cdf_arr),
        ptr(route_mode), ptr(is_sink),
        ptr(disc_xk), ptr(disc_cum), ptr(disc_offsets), ptr(disc_int),
        ptr(seeds_arr), C.c_int(num_seeds), C.c_int64(number_of_customers),
        C.c_int(1 if use_next_available_server else 0),
        C.c_double(float(deadline_budget)), C.c_int(1 if sim.generate_log else 0),
        C.c_int64(record_limit),
        ptr(g_key), C.byref(g_pos), C.byref(g_has_gauss), C.byref(g_gauss),
        ptr(out_tis), ptr(out_served), ptr(out_tiq), ptr(out_cql), ptr(out_mql),
        ptr(out_ren), ptr(out_del), ptr(out_qlt), C.c_int(qlt_cap),
        ptr(out_sat), ptr(out_scust), ptr(dealt),
        rep_ptrs[0], rep_ptrs[1], rep_ptrs[2],
        ptr(out_totals),
        C.byref(rec_values), C.byref(rec_ids), C.byref(rec_servers),
        C.byref(rec_kinds), C.byref(rec_count),
    )

    # a replication ended on its wall deadline, and that deadline was the budget's
    sim.budget_cut = bool(ended & 2) and budget_binds
    # write the advanced routing stream back
    new_state = ("MT19937", g_key, int(g_pos.value),
                 int(g_has_gauss.value), float(g_gauss.value))
    if routing_rng is not None:
        routing_rng.set_state(new_state)
    else:
        np.random.set_state(new_state)

    # copy stats onto the python-side objects
    for i, server in sim.servers.items():
        server.total_time_in_service = float(out_tis[i])
        server.total_customers_served = int(out_served[i])
        server.total_time_in_queue = float(out_tiq[i])
        server.cumulative_queue_length = float(out_cql[i])
        server.max_queue_length = int(out_mql[i])
        server.reneges = int(out_ren[i])
        server.delayed_departures = int(out_del[i])
        qlt = {0: 0}
        nonzero = np.nonzero(out_qlt[i])[0]
        for length in nonzero:
            qlt[int(length)] = float(out_qlt[i][length])
        server.queue_length_times = qlt
    for i, source in sim.sources.items():
        source.arrival_times = float(out_sat[i])
        source.customers_generated = int(out_scust[i])

    for r in range(num_seeds):
        for i in range(n):
            if i in sim.servers:
                sim.server_seeds[i].append(int(dealt[r, i]))
            else:
                sim.source_seeds[i].append(int(dealt[r, i]))

    if sim.record_history:
        for r in range(num_seeds):
            for i, server in sim.servers.items():
                row = rep_stats[r, i]
                server.total_time_in_service = float(row[0])
                server.total_time_in_queue = float(row[1])
                server.total_customers_served = int(row[2])
                server.reneges = int(row[3])
                server.max_queue_length = int(row[4])
                server.cumulative_queue_length = float(row[5])
                server.delayed_departures = int(row[6])
                qlt = {0: 0}
                for length in np.nonzero(rep_qlt[r, i])[0]:
                    qlt[int(length)] = float(rep_qlt[r, i][length])
                server.queue_length_times = qlt
            for i, source in sim.sources.items():
                source.arrival_times = float(rep_stats[r, i, 7])
                source.customers_generated = int(rep_stats[r, i, 8])
            sim.Clock = float(rep_totals[r, 0])
            sim.total_customers = int(rep_totals[r, 1])
            if sim.Clock != 0:  # reference gate (fixed .clock crash)
                sim.calculate_metrics()

    sim.Clock = float(out_totals[0])
    sim.previous_time = float(out_totals[1])
    sim.total_arrival_time = float(out_totals[2])
    sim.total_time_in_queues = float(out_totals[3])
    sim.total_customers = int(out_totals[4])
    sim.current_customers_in_system = int(out_totals[5])

    # Log records: stored raw; materialized to strings lazily (the decoder
    # reads at most ~5001 lines, and formatting is the GIL-bound part of a
    # run). A file-backed log materializes fully and flushes immediately
    # (artifact parity with the Python engine); a path-less log defers.
    if sim.generate_log and rec_count.value:
        cnt = rec_count.value
        # memcpy into numpy; python-object conversion (tolist) is deferred
        # to materialization and bounded by its limit
        values = np.ctypeslib.as_array(rec_values, shape=(cnt,)).copy()
        ids = np.ctypeslib.as_array(rec_ids, shape=(cnt,)).copy()
        servers_l = np.ctypeslib.as_array(rec_servers, shape=(cnt,)).copy()
        kinds = np.ctypeslib.as_array(rec_kinds, shape=(cnt,)).copy()
        lib.des_free_records(rec_values, rec_ids, rec_servers, rec_kinds)
        sim._pending_records = (values, ids, servers_l, kinds)
        sim._pending_offset = 0
        sim._pending_total = int(out_totals[6])
        # records beyond the storage cap were counted but not stored
        sim._dropped_records = sim._pending_total - cnt
        if sim.log.path is not None:
            materialize_records(sim)
            sim.log.flush()
    elif sim.generate_log:
        sim._pending_total = int(out_totals[6])
        sim._dropped_records = 0
        sim.log.flush()
