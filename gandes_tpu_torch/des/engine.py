"""Discrete-event simulator for queueing networks (host engine).

Re-implementation of the reference DES (`simulation_v3.py`, 3 identical
copies in marja-w/gan-des-midi-music-gen) with the same observable behavior:

* node typing from the adjacency-matrix diagonal (>0 source, <=0 server;
  reference :362, :377),
* per-row ``FlowBranchOperator`` routing with zero-prob pruning,
  normalization, and shortest-queue fallback when a row isn't a proper
  probability vector (reference :25-74),
* heap-ordered event loop with queue caps + reneging, delayed departures,
  and the 'Music' event-log line format (reference :426-697),
* per-replication reseeding of per-node RandomState streams from a master
  seed (reference :446-456) — draw-for-draw identical, see core/rng.py.

Performance-motivated re-designs (observable behavior preserved):

* The reference sweeps *all* servers on every event to accumulate
  time-at-queue-length histograms (reference :476-481, O(events*n)). We use
  lazy per-server accounting: a bucket is only touched when that server's
  effective queue length actually changes — O(1) per event, identical
  totals.
* scipy frozen-distribution ``rvs`` calls are replaced by direct
  ``RandomState`` draws with bit-identical sequences (core/rng.py).
* Log lines are buffered in memory and flushed once per run; the in-memory
  list is exposed so downstream decoders can skip file I/O (core/eventlog.py).

Reference quirks preserved (they shape the generated music):

* A source's routing is sampled once at Initialization; every subsequent
  arrival from that source reuses the same ``server_id`` (reference :580).
* Routing randomness (``np.random.choice``) uses the *global* numpy RNG,
  not the per-node streams (reference :57,:62).
* ``FlowBranchOperator.is_sink`` is ``sum(children) == 0`` — a node whose
  only positive-probability child is node 0 is treated as a sink
  (reference :74).
* Idle servers record ``servers_next_departure = 0`` (reference :648), so
  delayed departures can be scheduled in the past.
* ``max_sim_time`` is a wall-clock budget, not simulated time
  (reference :496).

Quirks fixed (the reference code path crashes, so nothing can depend on it):

* ``record_history=True`` works (reference reads undefined ``self.clock``
  at :510);
* ``num_runs`` without ``seeds`` works (reference ``list+int`` TypeError
  at :352);
* the ``while service_time <= 0`` redraw loop (reference :598-600) is
  capped — after 10_000 rejected draws the service time falls back to a
  tiny positive constant instead of spinning forever (the reference relies
  on an abandoned watchdog thread to escape this).
* ``animation=True`` is accepted but inert (reference calls an undefined
  ``get_graph_state`` at :619 and crashes).
"""

from __future__ import annotations

import heapq
import math
import os
import time as _time

import numpy as np

from gandes_tpu_torch.core.eventlog import EventLog
from gandes_tpu_torch.core.profiling import COUNTERS, span
from gandes_tpu_torch.core.rng import Sampler

_REDRAW_CAP = 10_000
_REDRAW_FALLBACK = 1e-9


class SimBudgetExceeded(Exception):
    """Raised internally when a cooperative deadline interrupts a run."""


class FlowBranchOperator:
    """Routing operator for one node's outgoing row.

    Mirrors reference :25-74: children with probability > 0 are kept, the
    kept probabilities are renormalized, and if the *original* row wasn't
    within 1e-4 of summing to 1 the node routes by shortest queue instead.
    """

    __slots__ = ("probabilities", "children", "shortest_queue", "_p_is_exact")

    def __init__(self, probabilities, children=None, origin=None, log: EventLog | None = None):
        probs = np.asarray(probabilities, dtype="float64")
        if children is None:
            children = []
        keep = np.nonzero(probs > 0)[0]
        children_arr = np.asarray(children)
        self.children = children_arr[keep].tolist() if len(keep) else []
        kept = probs[keep]
        # left-to-right accumulation over np.float64 scalars: CPython's
        # sum() applies Neumaier compensation to *python* floats (3.12+)
        # and numpy's np.sum is pairwise — both diverge in low bits from
        # the reference's ``sum(list_of_np.float64)``, whose exact
        # ``sum(probabilities) != 1`` branch downstream depends on it.
        total = np.float64(0.0)
        for v in kept:
            total = total + v
        # elementwise array division == per-scalar division bitwise;
        # iterating the result keeps np.float64 elements (see above)
        self.probabilities = list(kept / total) if len(kept) else []

        self.shortest_queue = False
        if np.abs(1 - np.sum(self.probabilities)) > 0.0001 and origin is not None:
            if log is not None:
                log.info(f"{origin} branch method set as shortest queue")
            self.shortest_queue = True
        # Exact float comparison, as in reference :55 — an epsilon-off sum
        # silently falls back to a *uniform* choice over children.
        self._p_is_exact = bool(self.probabilities) and sum(self.probabilities) == 1

    def randomly_select_child(self):
        if not self._p_is_exact:
            if len(self.children) > 0:
                return np.random.choice(self.children)
            raise ValueError("No children available to select from")
        return np.random.choice(self.children, p=self.probabilities)

    def get_children_ids(self):
        return self.children

    def uses_shortest_queue(self):
        return self.shortest_queue

    def is_sink(self):
        return sum(self.children) == 0 if self.children is not None else False


class Event:
    """One scheduled arrival/departure. Orders by time only; ties resolve by
    heap structure exactly as in the reference (same heapq algorithm, same
    insertion order)."""

    __slots__ = (
        "event_type",
        "time",
        "server_id",
        "source_id",
        "event_id",
        "delayed_event",
        "delayed_time",
        "arrival_time",
    )

    def __init__(self, event_type, time, server_id=None, source_id=None, event_id=None):
        self.event_type = event_type
        self.time = time
        self.server_id = server_id
        self.source_id = source_id
        self.event_id = event_id
        self.delayed_event = False
        self.delayed_time = 0
        self.arrival_time = 0

    def __lt__(self, other):
        return self.time < other.time

    def get_type(self):
        return self.event_type

    def get_time(self):
        return self.time

    def get_server_id(self):
        return self.server_id

    def get_source_id(self):
        return self.source_id

    def get_event_id(self):
        return self.event_id


class EventList:
    """Future event list: binary heap + per-server next-departure table."""

    def __init__(self):
        self.events: list[Event] = []
        self.servers_next_departure: dict = {}

    def get_time_of_next_departure(self, server_id):
        return self.servers_next_departure.get(server_id, math.inf)

    def enqueue(self, event):
        heapq.heappush(self.events, event)

    def dequeue(self):
        return heapq.heappop(self.events)

    def getMin(self):
        return self.events[0]


class Queue:
    """FIFO of waiting arrival events."""

    def __init__(self):
        self.queue: list[Event] = []

    def enqueue(self, event):
        self.queue.append(event)

    def dequeue(self):
        return self.queue.pop(0)

    def size(self):
        return len(self.queue)


class Server:
    """A service node. ``distribution`` follows the reference list form,
    e.g. ``['normal', loc, scale]``; kinds 'branch' and 'queue' are
    pseudo-servers (reference :181-199)."""

    def __init__(self, distribution, destinations=None, server_id=None):
        self.queue = Queue()
        self.sampler = Sampler(distribution)
        # per-replication stream; Sim.run reseeds it before any draw
        # (engine.py ~:480). Creating an *unseeded* RandomState here — as
        # the reference does — costs ~0.1 ms of urandom entropy per node
        # that is never observed; deferring it is behavior-invariant.
        self.rng = None
        self.server_id = server_id
        self.mean_service_time = (
            0 if (self.sampler.is_branch or self.sampler.is_queue) else self.sampler.mean
        )
        self.destination = destinations
        self.in_service = 0
        self.total_time_in_service = 0
        self.total_customers_served = 0
        self.max_queue_length = 0
        self.reneges = 0
        self.total_time_in_queue = 0
        self.cumulative_queue_length = 0
        self.queue_length_counts: dict = {}
        self.queue_length_times: dict = {}
        self.delayed_departures = 0
        # lazy queue-length-time accounting (replaces reference :476-481)
        self._len_since = 0.0

    @property
    def branch(self):
        return self.sampler.is_branch

    @property
    def distribution(self):
        # API parity: reference exposes `.distribution is None` for 'queue'
        # nodes. We expose the sampler (or None) under the same name.
        return None if self.sampler.is_queue else self.sampler

    def is_busy(self):
        return self.in_service

    def get_queue_size(self):
        return self.queue.size()

    def is_branch(self):
        return self.sampler.is_branch

    def is_queue(self):
        return self.sampler.is_queue

    def get_server_id(self):
        return self.server_id

    def get_destination(self):
        return self.destination

    # -- lazy time-at-length accounting ------------------------------------
    def _account_len(self, now: float) -> None:
        """Close the current constant-length interval at sim time ``now``."""
        length = self.queue.size() + self.delayed_departures
        dt = now - self._len_since
        if dt != 0:
            bucket = self.queue_length_times
            bucket[length] = bucket.get(length, 0) + dt
        self._len_since = now


class Source:
    """An arrival-generating node."""

    def __init__(self, distribution, source_id=None, destinations=None):
        self.sampler = Sampler(distribution)
        if self.sampler.is_branch or self.sampler.is_queue:
            raise ValueError("Distribution not supported")
        self.rng = None  # reseeded per replication before any draw
        self.mean_inter_arrival_time = self.sampler.mean
        self.destination = destinations
        self.arrival_times = 0
        self.customers_generated = 0
        self.source_id = source_id

    @property
    def distribution(self):
        return self.sampler


class Sim:
    """Queueing-network simulation.

    Same construction surface as the reference ``Sim`` (simulation_v3.py:309):
    ``adj_matrix`` (diag > 0 => source, <= 0 => server), per-node
    ``distributions`` list, per-node ``queue_list`` caps, ``seeds`` or
    ``num_runs`` replications, 'All' | 'Music' ``logging_mode``,
    wall-clock ``max_sim_time``.
    """

    arrival = 1
    departure = 2

    def __init__(
        self,
        adj_matrix,
        distributions,
        queue_list,
        seeds=None,
        num_runs=None,
        generate_log=False,
        log_path="logs/",
        log_name=None,
        animation=False,
        record_history=False,
        logging_mode="All",
        max_sim_time=1000,
        verbose=False,
        deadline=None,
        engine="auto",
    ):
        self.generate_log = generate_log
        self.animation = animation
        self.record_history = record_history
        self.logging_mode = logging_mode
        self.max_sim_time = max_sim_time
        self.verbose = verbose
        # 'auto' (native C++ core when the config is eligible, else the
        # Python loop), 'native' (force; error if ineligible), 'python'.
        # Both engines are draw-for-draw and log-byte identical; see
        # des/native.py and tests/test_native_engine.py.
        self.engine = os.environ.get("GANDES_ENGINE", engine) if engine == "auto" else engine
        # cooperative absolute wall-clock deadline (time.time() value); this
        # replaces the reference's leaked watchdog threads
        # (MMGAN_MIDI_DES/matrix_sim_process.py:159-168).
        self.deadline = deadline
        # optional private routing stream (native engine only); defaults to
        # the numpy global RNG for reference parity
        self.routing_rng = None

        if self.generate_log:
            # log_path None: the log stays in memory
            filename = (None if log_path is None
                        else log_path + ("simulation.log" if log_name is None else log_name))
            self.log = EventLog(filename)
        else:
            self.log = None

        if seeds is not None:
            self.seeds = seeds
            self.num_runs = len(seeds)
        elif num_runs is not None:
            self.seeds = [1000 + i for i in range(num_runs)]
            self.num_runs = num_runs
        else:
            raise ValueError("Either seeds or num_runs must be provided.")

        self.adj_matrix = adj_matrix
        self.queue_list = queue_list
        self.distributions = distributions

        diag = np.diag(adj_matrix)
        n = len(diag)
        self.sources = {i: Source(distributions[i], source_id=i) for i in range(n) if diag[i] > 0}
        self.servers = {i: Server(distributions[i], server_id=i) for i in range(n) if diag[i] <= 0}

        log_all = self.log if (self.generate_log and self.logging_mode == "All") else None
        # the shortest-queue notice is logged regardless of logging_mode in
        # the reference (simulation_v3.py:51 goes through the root logger),
        # so 'Music' log files contain it too.
        log_any = self.log if self.generate_log else None
        adj = np.asarray(adj_matrix, dtype="float64")
        idx_n = np.arange(n)

        def _destiny(i):
            mask = (adj[i] > 0) & (idx_n != i)
            return np.where(mask, idx_n, 0)

        for i, source in self.sources.items():
            probabilities = adj[i].copy()
            probabilities[i] = 0
            destiny = _destiny(i)
            source.destination = FlowBranchOperator(
                probabilities=probabilities, children=destiny, origin=i, log=log_any
            )
            if log_all is not None:
                # reference logs the python-list repr of destiny
                log_all.info(f"Source {i} has destination {destiny.tolist()}")
                log_all.info(f"Source {i} has distribution {distributions[i]}")
                log_all.info(f"Source {i} has mean inter-arrival time {source.mean_inter_arrival_time}")

        for i, server in self.servers.items():
            probabilities = adj[i].copy()
            probabilities[i] = 0
            destiny = _destiny(i)
            server.destination = FlowBranchOperator(
                probabilities=probabilities, children=destiny, origin=i, log=log_any
            )
            if log_all is not None:
                log_all.info(f"Server {i} has destination {destiny.tolist()}")
                log_all.info(f"Server {i} has distribution {distributions[i]}")
                log_all.info(f"Server {i} has mean service time {server.mean_service_time}")

        self.FutureEventList = EventList()
        self.Clock = 0.0

        self.total_time_in_queues = 0
        self.total_customers = 0
        self.total_reneges = 0
        self.total_arrival_time = 0
        self.current_customers_in_system = 0
        self.customers_in_system = [0]

        self.avg_queue_length_history = []
        self.avg_server_length_history = []
        self.total_arrival_time_history = []
        self.total_service_time_history = []
        self.avg_queue_time_history = []
        self.renege_rate_history = []
        self.server_utilizations_history = []
        self.total_customers_history = []
        self.max_queue_lengths_history = []
        self.avg_time_at_server_history = []
        self.customers_served_per_server = []
        self.probabilities_of_queue_lengths_history = []

        # experimental scratch lists, kept for API parity (reference :422-424)
        self.test_variable = []
        self.test_variable_two = []
        self.test_variable_three = []

    # ------------------------------------------------------------------ run

    def run(self, number_of_customers=50, use_next_available_server=False):
        """Run the replications, inside a ``des`` span. Counts the sim in
        ``core/profiling.py``'s ``COUNTERS``: its log lines as DES events, a
        run that ended past ``deadline`` as timed out, one that its wall
        budget ``max_sim_time`` stopped before its customer count as cut
        (``budget_cut``; a stop on an earlier ``deadline`` is the watchdog's,
        not the budget's), one that raised as failed; the span carries the
        same increments."""
        with span("des", customers=number_of_customers) as s:
            try:
                self._run(number_of_customers, use_next_available_server)
            except Exception:
                COUNTERS.add(sims_run=1, sims_failed=1)
                s.set(failed=1)
                raise
            timed_out = int(self.deadline is not None and _time.time() > self.deadline)
            cut = int(self.budget_cut)
            events = self.log_line_count()
            COUNTERS.add(sims_run=1, sims_timed_out=timed_out, sims_budget_cut=cut,
                         des_events=events)
            s.set(timed_out=timed_out, budget_cut=cut, events=events)

    def _run(self, number_of_customers, use_next_available_server):
        n = len(np.diag(self.adj_matrix))
        self.server_seeds = [[] for _ in range(n)]
        self.source_seeds = [[] for _ in range(n)]
        self.number_of_customers = number_of_customers
        self.use_next_available_server = use_next_available_server
        self.budget_cut = False  # set by the engine that runs

        if self.engine in ("auto", "native"):
            from gandes_tpu_torch.des import native

            if native.native_eligible(self):
                native.run_native(self, number_of_customers, use_next_available_server)
                return
            if self.engine == "native":
                raise ValueError("Sim configuration not supported by the native engine")

        try:
            self._run_replications(number_of_customers)
        finally:
            # the reference's incremental root-logger writes leave a partial
            # log behind even when a replication dies; flushing in a finally
            # preserves that observable behavior with buffered logging.
            if self.log is not None:
                self.log.flush()

    def _run_replications(self, number_of_customers):

        log = self.log
        music = self.logging_mode == "Music"
        log_all = log if (log is not None and not music) else None
        log_music = log if (log is not None and music) else None

        if number_of_customers > 1000:
            if log_all is not None:
                log_all.info("Animation and logging disabled due to large number of customers")
            self.animation = False

        for i, seed in enumerate(self.seeds):
            rng = np.random.RandomState(seed)
            for server in self.servers.values():
                server_seed = rng.randint(3, 9999999)
                server.rng = np.random.RandomState(server_seed)
                self.server_seeds[server.server_id].append(server_seed)
            for source in self.sources.values():
                source_seed = rng.randint(3, 9999999)
                source.rng = np.random.RandomState(source_seed)
                self.source_seeds[source.source_id].append(source_seed)

            self.FutureEventList = EventList()
            self.reset_variables()
            try:
                self.Initialization()
            except SimBudgetExceeded:  # on the previous replication's deadline
                self.budget_cut = self._budget_binds
                break

            self.previous_time = 0
            start_time = _time.time()
            deadline = start_time + self.max_sim_time
            # which clock stops the run: the wall budget, or an earlier watchdog
            self._budget_binds = self.deadline is None or deadline <= self.deadline
            if not self._budget_binds:
                deadline = self.deadline
            # let the service-time redraw loop see the wall budget too: a
            # near-degenerate normal (loc~0, scale~0) costs ~N(loc/scale)
            # redraws per draw, which the reference lets spin unboundedly
            self._run_deadline = deadline

            events = self.FutureEventList.events
            servers = self.servers
            interrupted = False

            while events:
                evt = heapq.heappop(events)

                t = evt.time
                td = t - self.previous_time
                sid = evt.server_id
                srv = servers.get(sid)
                if srv is not None:
                    srv.cumulative_queue_length += td * srv.queue.size()
                self.previous_time = t

                if self.total_customers > number_of_customers - 1:
                    break

                self.Clock = t
                try:
                    if evt.event_type == self.arrival:
                        self.ProcessArrival(evt)
                    else:
                        self.ProcessDeparture(evt)
                except SimBudgetExceeded:
                    interrupted = True
                    self.budget_cut = self._budget_binds
                    break

                if _time.time() > deadline:
                    self.budget_cut = self._budget_binds
                    if self.verbose:
                        print(
                            f"Simulation time exceeded max_sim_time input:{self.max_sim_time} "
                            "seconds, ending simulation"
                        )
                    break

            # close the lazy time-at-length accounting at the last popped
            # event's time (reference accumulates up to and including the
            # pop that triggers a break, :472-484).
            for server in servers.values():
                server._account_len(self.previous_time)

            elapsed_time = _time.time() - start_time
            if self.verbose:
                print(
                    f"{i + 1}: {elapsed_time} elapsed time for {self.Clock} simulation time "
                    f"with {self.total_customers} customers"
                )
            if log_all is not None and self.total_customers < 100:
                log_all.info(
                    f"{i + 1}: {elapsed_time} elapsed time for {self.Clock} simulation time "
                    f"with {self.total_customers} customers"
                )

            if self.record_history and self.Clock != 0:
                self.calculate_metrics()

            if interrupted:
                break

    # ---------------------------------------------------------------- steps

    def Initialization(self):
        log = self.log
        log_all = log if (log is not None and self.logging_mode == "All") else None
        if log_all is not None:
            log_all.info("Initialization")
            log_all.info("TIME - EVENT ID - SERVER ID - EVENT TYPE")
        for key, source in self.sources.items():
            time_to_next_arrival = source.sampler.draw(source.rng)
            self.total_arrival_time += time_to_next_arrival
            source.arrival_times += time_to_next_arrival
            next_server_id = self.get_destination(key)
            evt = Event(
                self.arrival,
                self.Clock + time_to_next_arrival,
                server_id=next_server_id,
                source_id=key,
                event_id=self.total_customers,
            )
            self.total_customers += 1
            source.customers_generated += 1
            self.FutureEventList.enqueue(evt)
            if log_all is not None and self.total_customers < 100:
                log_all.info(
                    f"{self.Clock} - {evt.event_id} - {evt.server_id} - Enqueued arrival at {evt.time}"
                )

    def ProcessArrival(self, evt):
        server_id = evt.server_id
        log = self.log
        music = self.logging_mode == "Music"
        if log is not None:
            if music:
                log.info(f"{self.Clock} - {evt.event_id} - {server_id} - arrival")
            elif self.total_customers < 100:
                log.info(f"{self.Clock} - {evt.event_id} - {server_id} - Processing arrival")

        if server_id is not None:
            server = self.servers[server_id]
            if server.in_service == 0:
                self.ScheduleDeparture(server_id, evt.event_id)
            else:
                if (server.queue.size() + server.delayed_departures) < self.queue_list[server_id]:
                    server._account_len(self.Clock)
                    evt.arrival_time = self.Clock
                    server.queue.enqueue(evt)
                    if server.queue.size() > server.max_queue_length:
                        server.max_queue_length = server.queue.size()
                else:
                    server.reneges += 1
                    if log is not None and not music and self.total_customers < 100:
                        log.info(f"{self.Clock} - {evt.event_id} - {server_id} - Customer reneged")

        if evt.source_id is not None:
            self.current_customers_in_system += 1
            source_id = evt.source_id
            source = self.sources[source_id]
            time_to_next_arrival = source.sampler.draw(source.rng)
            self.total_arrival_time += time_to_next_arrival
            source.arrival_times += time_to_next_arrival
            source.customers_generated += 1
            # Quirk preserved: the next arrival reuses this event's
            # server_id — source routing is only sampled at Initialization
            # (reference :580).
            nxt = Event(
                self.arrival,
                self.Clock + time_to_next_arrival,
                server_id=server_id,
                source_id=source_id,
                event_id=self.total_customers,
            )
            self.total_customers += 1
            self.FutureEventList.enqueue(nxt)
            if log is not None and not music and self.total_customers < 100:
                log.info(f"{self.Clock} - {nxt.event_id} - {nxt.server_id} - Enqueued arrival at {nxt.time}")

    def ScheduleDeparture(self, server_id, event_id=None):
        log = self.log
        music = self.logging_mode == "Music"
        if log is not None and not music and self.total_customers < 100:
            log.info(f"{self.Clock} - {event_id} - {server_id} - Scheduling departure from server")

        if server_id is None:
            return
        server = self.servers[server_id]
        server.in_service = 1
        server.total_customers_served += 1
        service_time = 0
        if not server.sampler.is_queue and not server.sampler.is_branch:
            redraws = 0
            deadline = getattr(self, "_run_deadline", None)
            while service_time <= 0:
                service_time = server.sampler.draw(server.rng)
                redraws += 1
                if redraws >= _REDRAW_CAP:
                    # Reference spins forever here for degenerate
                    # distributions (:598-600); cap and clamp instead.
                    service_time = _REDRAW_FALLBACK
                    break
                if redraws % 1024 == 0 and deadline is not None and _time.time() > deadline:
                    raise SimBudgetExceeded

        if log is not None and music:
            log.info(f"{service_time} - {event_id} - {server_id} - processing")

        server.total_time_in_service += service_time
        departure = Event(
            self.departure, self.Clock + service_time, server_id=server_id, source_id=None, event_id=event_id
        )
        self.FutureEventList.enqueue(departure)
        self.FutureEventList.servers_next_departure[server_id] = departure.time

    def ProcessDeparture(self, evt):
        log = self.log
        music = self.logging_mode == "Music"
        if log is not None:
            if music:
                log.info(f"{self.Clock} - {evt.event_id} - {evt.server_id} - departure")
            elif self.total_customers < 100:
                log.info(
                    f"{self.Clock} - {evt.event_id} - {evt.server_id} - Processing departure from server "
                )
        server_id = evt.server_id
        server = self.servers[server_id]
        if evt.delayed_event:
            server._account_len(self.Clock)
            server.delayed_departures -= 1
            evt.delayed_event = False
        next_server_id = self.get_destination(server_id)

        if next_server_id is None:
            for child in server.destination.children:
                ch = self.servers.get(child)
                if ch is not None and ch.in_service == 0:
                    next_server_id = child
                    break

        if next_server_id is not None or server.destination.is_sink():
            if server.queue.size() > 0:
                server._account_len(self.Clock)
                customer = server.queue.dequeue()
                self.total_time_in_queues += self.Clock - customer.time
                server.total_time_in_queue += self.Clock - customer.arrival_time
                self.ScheduleDeparture(server_id, customer.event_id)
                server.in_service = 1
                server.cumulative_queue_length += server.queue.size()
            else:
                server.in_service = 0
                # Quirk preserved: idle marker is 0, not +inf (reference
                # :648) — delayed departures can schedule into the past.
                self.FutureEventList.servers_next_departure[server_id] = 0
            if server.destination.is_sink():
                if log is not None and not music and self.total_customers < 100:
                    log.info(f"{self.Clock} - {evt.event_id} - {evt.server_id} - Customer exited the system")
            else:
                self.ProcessArrival(
                    Event(self.arrival, self.Clock, server_id=next_server_id, source_id=None, event_id=evt.event_id)
                )
        else:
            children = server.destination.children
            fel = self.FutureEventList
            next_departure_time = math.inf
            for child in children:
                if child != server_id:
                    t = fel.get_time_of_next_departure(child)
                    if t < next_departure_time:
                        next_departure_time = t
            self.schedule_delayed_departure(server_id, evt.event_id, next_departure_time)
            if log is not None and not music and self.total_customers < 100:
                log.info(
                    f"{self.Clock} - {evt.event_id} - {evt.server_id} - Customer delayed departure from server"
                )

    def schedule_delayed_departure(self, server_id, event_id, new_departure_time):
        # NOTE: logged regardless of logging_mode, matching reference
        # :684-685 (the line has no (arrival|departure) suffix so the music
        # regex never matches it, but it IS present in 'Music' log files).
        if self.log is not None and self.total_customers < 100:
            self.log.info(f"{self.Clock} - {event_id} - {server_id} - Scheduling delayed departure from server")
        if server_id is None:
            return
        server = self.servers[server_id]
        server.in_service = 1
        departure = Event(
            self.departure, new_departure_time, server_id=server_id, source_id=None, event_id=event_id
        )
        server._account_len(self.Clock)
        server.delayed_departures += 1
        departure.delayed_event = True
        departure.delayed_time += new_departure_time - self.Clock
        self.FutureEventList.enqueue(departure)
        self.FutureEventList.servers_next_departure[server_id] = departure.time
        server.total_time_in_queue += new_departure_time - self.Clock

    def get_destination(self, id):
        """Route a customer leaving node ``id``; reference :699-743."""
        shortest_queue = False
        if id in self.servers:
            node = self.servers[id]
            if node.is_queue() or node.destination.is_sink():
                return None
            shortest_queue = node.destination.shortest_queue
        elif id in self.sources:
            node = self.sources[id]
            shortest_queue = node.destination.shortest_queue
        next_id = None
        if shortest_queue:
            children = node.destination.children
            shortest_queue_length = math.inf
            shortest_queue_id = None
            zero_queue_length = []
            for child in children:
                ch = self.servers.get(child)
                if ch is not None:
                    size = ch.queue.size()
                    if size < shortest_queue_length:
                        shortest_queue_length = size
                        shortest_queue_id = child
                    if size == 0:
                        zero_queue_length.append(child)
            if self.use_next_available_server:
                shortest_remaining_service_time = math.inf
                for child in zero_queue_length:
                    t = self.FutureEventList.get_time_of_next_departure(child)
                    if t < shortest_remaining_service_time:
                        shortest_remaining_service_time = t
                        shortest_queue_id = child
            next_id = shortest_queue_id
        else:
            next_id = node.destination.randomly_select_child()
        return next_id

    def get_queue_lengths(self):
        return [server.queue.size() for server in self.servers.values()]

    # -------------------------------------------------------------- metrics

    def calculate_metrics(self):
        if self.total_customers == 0:
            return 0, 0, 0, [0] * len(self.servers)

        servers = self.servers
        served = {s: srv for s, srv in servers.items() if srv.total_customers_served > 0}
        avg_time_at_server = {
            s: (srv.total_time_in_service + srv.total_time_in_queue) / srv.total_customers_served
            for s, srv in served.items()
        }
        avg_queue_time = {s: srv.total_time_in_queue / srv.total_customers_served for s, srv in served.items()}
        server_utilizations = {s: srv.total_time_in_service / self.Clock for s, srv in servers.items()}
        max_queue_lengths = {s: srv.max_queue_length for s, srv in servers.items()}
        renege_rate = {s: srv.reneges / srv.total_customers_served for s, srv in served.items()}
        service_times = {
            s: srv.total_time_in_service / srv.total_customers_served for s, srv in served.items()
        }
        arrival_times = {
            s: src.arrival_times / src.customers_generated for s, src in self.sources.items()
        }
        customers_served_per_server = {s: srv.total_customers_served for s, srv in servers.items()}
        avg_queue_length = {
            s: sum(length * t for length, t in srv.queue_length_times.items()) / self.Clock
            for s, srv in servers.items()
        }
        avg_server_length = {s: avg_queue_length[s] + server_utilizations[s] for s in servers}
        queue_length_probabilities = {
            s: {length: t / self.Clock for length, t in srv.queue_length_times.items()}
            for s, srv in servers.items()
        }

        if self.record_history:
            self.avg_queue_length_history.append(avg_queue_length)
            self.avg_server_length_history.append(avg_server_length)
            self.avg_time_at_server_history.append(avg_time_at_server)
            self.avg_queue_time_history.append(avg_queue_time)
            self.renege_rate_history.append(renege_rate)
            self.server_utilizations_history.append(server_utilizations)
            self.total_arrival_time_history.append(arrival_times)
            self.total_service_time_history.append(service_times)
            self.total_customers_history.append(self.total_customers)
            self.max_queue_lengths_history.append(max_queue_lengths)
            self.customers_served_per_server.append(customers_served_per_server)
            self.probabilities_of_queue_lengths_history.append(queue_length_probabilities)

        # reference logs a metric block whenever a log exists
        # (simulation_v3.py:804-824) and returns None on this path
        if self.generate_log and self.log is not None:
            total_U = sum(server_utilizations.values())
            total_L = sum(avg_queue_length.values()) + sum(server_utilizations.values())
            total_LQ = sum(avg_queue_length.values())
            total_W = sum(avg_time_at_server.values()) + sum(avg_queue_time.values())
            total_WQ = sum(avg_queue_time.values())
            log = self.log
            log.info(f"Average queue length: {avg_queue_length}")
            log.info(f"Average server length: {avg_server_length}")
            log.info(f"Average time at server: {avg_time_at_server}")
            log.info(f"Average queue_time: {avg_queue_time}")
            log.info(f"Renege rate: {renege_rate}")
            log.info(f"Server utilization: {server_utilizations}")
            log.info(f"Total arrival time: {arrival_times}")
            log.info(f"Total service time: {service_times}")
            log.info(f"Total customers served: {self.total_customers}")
            log.info(f"Max queue length: {max_queue_lengths}")
            log.info(f"Customers served per server: {customers_served_per_server}")
            log.info("--------------------------------------------------")
            log.info(f"Total U: {total_U}")
            log.info(f"Total L: {total_L}")
            log.info(f"Total LQ: {total_LQ}")
            log.info(f"Total W: {total_W}")
            log.info(f"Total WQ: {total_WQ}")
        return None

    def print_test_variables(self):
        print(f"TEST QUEUE LENGTH: {self.test_variable}")

    def print_metrics(self):
        print(f"Average queue length: {self.avg_queue_length_history}")
        print(f"Average server length: {self.avg_server_length_history}")
        print(f"Average time at server: {self.avg_time_at_server_history}")
        print(f"Average queue_time: {self.avg_queue_time_history}")
        print(f"Renege rate: {self.renege_rate_history}")
        print(f"Server utilization: {self.server_utilizations_history}")
        print(f"Total arrival time: {self.total_arrival_time_history}")
        print(f"Total service time: {self.total_service_time_history}")
        print(f"Total customers served: {self.total_customers_history}")
        print(f"Max queue length: {self.max_queue_lengths_history}")
        print(f"Customers served per server: {self.customers_served_per_server}")

    def calculate_confidence_intervals(self, confidence_level):
        from scipy import stats

        queue_time_ci = stats.t.interval(
            confidence_level,
            len(self.avg_queue_time_history) - 1,
            loc=np.mean(self.avg_queue_time_history),
            scale=stats.sem(self.avg_queue_time_history),
        )
        renege_rate_ci = stats.t.interval(
            confidence_level,
            len(self.renege_rate_history) - 1,
            loc=np.mean(self.renege_rate_history),
            scale=stats.sem(self.renege_rate_history),
        )
        return queue_time_ci, renege_rate_ci

    def reset_variables(self):
        self.total_time_in_queues = 0
        self.total_customers = 0
        self.total_reneges = 0
        self.total_arrival_time = 0
        self.Clock = 0.0

        for server in self.servers.values():
            server.queue = Queue()
            server.in_service = 0
            server.total_time_in_service = 0
            server.total_customers_served = 0
            server.max_queue_length = 0
            server.reneges = 0
            server.total_time_in_queue = 0
            server.cumulative_queue_length = 0
            server.queue_length_counts = {}
            server.queue_length_times = {0: 0}
            server.delayed_departures = 0
            server._len_since = 0.0

        for source in self.sources.values():
            source.arrival_times = 0
            source.customers_generated = 0

    # ---------------------------------------------------------- fast access

    def log_line_count(self):
        """Total log lines the run emitted (materialized + pending native
        records, including any beyond the storage cap) without forcing
        string formatting."""
        if self.log is None:
            return 0
        n = len(self.log.lines) + getattr(self, "_dropped_records", 0)
        pend = getattr(self, "_pending_records", None)
        if pend is not None:
            n += len(pend[0]) - self._pending_offset
        return n

    def music_lines(self, limit=None):
        """The buffered log lines (without file I/O); empty when
        ``generate_log=False``. ``limit`` bounds how many native-engine
        records get formatted (the MIDI decoders read at most ~5001 lines);
        more than ``limit`` lines may be returned if already materialized."""
        if self.log is None:
            return []
        if getattr(self, "_pending_records", None) is not None:
            from gandes_tpu_torch.des.native import materialize_records

            materialize_records(self, limit)
        return self.log.lines

    # -------------------------------------------------------------- plots
    # API parity with the reference's Sim plotting surface
    # (simulation_v3.py:850-1353); implementations in des/plots.py.

    def plot_metrics(self, server=1, confidence_level=0.95, **kw):
        from gandes_tpu_torch.des import plots

        return plots.plot_metrics(self, server, confidence_level, **kw)

    def plot_metrics_all_servers(self, confidence_level=0.95, predicted=None,
                                 theoretical=None, **kw):
        from gandes_tpu_torch.des import plots

        return plots.plot_metrics_all_servers(self, confidence_level, predicted,
                                              theoretical, **kw)

    def plot_probability_k_customers_in_system(self, node=1, confidence_level=0.95, **kw):
        from gandes_tpu_torch.des import plots

        return plots.plot_probability_k_customers_in_system(self, node, confidence_level, **kw)

    def plot_cumulative_renege_rates(self, queue_length=None, confidence_level=0.95,
                                     observed=None, **kw):
        from gandes_tpu_torch.des import plots

        return plots.plot_cumulative_renege_rates(self, queue_length, confidence_level,
                                                  observed, **kw)
