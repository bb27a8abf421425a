// Native DES engine — the queueing-network event loop as C++.
//
// gandes_tpu_torch's own copy of the repository's native/des_engine.cpp,
// which the JAX package builds. Its records, statistics and RNG streams
// are that file's; the MM-GAN batch call (mmgan_host_batch) gets there
// with less work:
//   * in thread mode (n_threads > 1) a sim stops once it has emitted
//     record_limit records (Engine::stop_at_record_limit), so its emitted
//     count ends a few records past the limit and out_capped flags it;
//   * its records go straight into the caller's arrays, a fixed slot of
//     record_limit records per sample;
//   * in thread mode the workers build the routing tables and run each sim
//     as soon as this thread has decoded it, and each worker reuses its
//     last sim's heap buffers (EngineBuffers);
//   * its sims keep no queue-length statistics, which it never returns.
// MT19937 regenerates its words without a modulo per index.
//
// Drop-in compute core for gandes_tpu_torch.des.engine.Sim (engine='native'):
// same event semantics, same statistics, and BIT-IDENTICAL randomness to
// the Python engine / the reference, which requires faithful
// re-implementations of numpy's legacy RandomState primitives:
//
//   * MT19937 core with numpy's init_genrand seeding,
//   * random_sample  = ((a>>5)*2^26 + (b>>6)) / 2^53,
//   * standard_normal = Marsaglia polar with the cached-second-value
//     order numpy uses (returns f*x2 first, caches f*x1),
//   * standard_exponential = -log(1 - random_sample),
//   * randint = legacy rk_interval 32-bit masked rejection (no draw when
//     the range is 1),
//   * standard_gamma / beta = numpy's legacy algorithms,
//   * choice(p) = cumsum-normalized searchsorted(random_sample, 'right'),
//   * choice uniform = rk_interval.
//
// Routing randomness flows through the caller-provided GLOBAL RandomState
// snapshot (reference quirk: np.random.choice in FlowBranchOperator uses
// the global stream) which is read in and written back, so Python-side
// code before/after a run sees exactly the stream it would have seen.
//
// The event heap replicates CPython heapq's _siftup/_siftdown index
// mechanics so time ties resolve identically.
//
// Bit-parity with the Python engine is asserted in
// tests/test_native_engine.py over full Music event logs.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <algorithm>
#include <atomic>
#include <deque>
#include <thread>
#include <vector>

namespace {

double wall_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

// ------------------------------------------------------------- MT19937

struct MT19937 {
  uint32_t key[624];
  int pos = 624;
  bool has_gauss = false;
  double gauss = 0.0;

  void seed(uint32_t s) {
    key[0] = s;
    for (int i = 1; i < 624; i++)
      key[i] = 1812433253u * (key[i - 1] ^ (key[i - 1] >> 30)) + (uint32_t)i;
    pos = 624;
    has_gauss = false;
    gauss = 0.0;
  }

  // seed(seeds[k]) on each of gens[0..n), eight generators at a time: the
  // words of one generator form a chain of dependent multiplies, and
  // eight independent chains keep the multiplier busy
  static void seed_many(MT19937* const* gens, const uint32_t* seeds, int n) {
    for (int g = 0; g < n; g += 8) {
      const int m = std::min(8, n - g);
      uint32_t* keys[8];
      for (int k = 0; k < m; k++) {
        keys[k] = gens[g + k]->key;
        keys[k][0] = seeds[g + k];
      }
      for (int i = 1; i < 624; i++)
        for (int k = 0; k < m; k++)
          keys[k][i] = 1812433253u * (keys[k][i - 1] ^ (keys[k][i - 1] >> 30)) + (uint32_t)i;
      for (int k = 0; k < m; k++) {
        gens[g + k]->pos = 624;
        gens[g + k]->has_gauss = false;
        gens[g + k]->gauss = 0.0;
      }
    }
  }

  static uint32_t twist(uint32_t here, uint32_t next, uint32_t far) {
    uint32_t y = (here & 0x80000000u) | (next & 0x7fffffffu);
    return far ^ (y >> 1) ^ ((0u - (y & 1u)) & 2567483615u);
  }

  uint32_t next32() {
    if (pos >= 624) {
      // the in-place regeneration of every word in order, its three index
      // ranges split so that no index wraps (the same words as a loop
      // taking (i + 1) % 624 and (i + 397) % 624)
      int i = 0;
      for (; i < 624 - 397; i++) key[i] = twist(key[i], key[i + 1], key[i + 397]);
      for (; i < 623; i++) key[i] = twist(key[i], key[i + 1], key[i + 397 - 624]);
      key[623] = twist(key[623], key[0], key[396]);
      pos = 0;
    }
    uint32_t y = key[pos++];
    y ^= y >> 11;
    y ^= (y << 7) & 2636928640u;
    y ^= (y << 15) & 4022730752u;
    y ^= y >> 18;
    return y;
  }

  double random_sample() {
    uint32_t a = next32() >> 5, b = next32() >> 6;
    return (a * 67108864.0 + b) / 9007199254740992.0;
  }

  double standard_exponential() { return -std::log(1.0 - random_sample()); }

  double standard_normal() {
    if (has_gauss) {
      has_gauss = false;
      return gauss;
    }
    double x1, x2, r2;
    do {
      x1 = 2.0 * random_sample() - 1.0;
      x2 = 2.0 * random_sample() - 1.0;
      r2 = x1 * x1 + x2 * x2;
    } while (r2 >= 1.0 || r2 == 0.0);
    double f = std::sqrt(-2.0 * std::log(r2) / r2);
    gauss = f * x1;
    has_gauss = true;
    return f * x2;
  }

  // legacy rk_interval: inclusive max, 32-bit masked rejection
  uint32_t interval(uint32_t max) {
    if (max == 0) return 0;
    uint32_t mask = max;
    mask |= mask >> 1;
    mask |= mask >> 2;
    mask |= mask >> 4;
    mask |= mask >> 8;
    mask |= mask >> 16;
    uint32_t v;
    while ((v = next32() & mask) > max) {
    }
    return v;
  }

  long randint(long low, long high) {  // [low, high) as numpy
    return low + (long)interval((uint32_t)(high - low - 1));
  }

  double standard_gamma(double shape) {
    if (shape == 1.0) return standard_exponential();
    if (shape == 0.0) return 0.0;
    if (shape < 1.0) {
      for (;;) {
        double U = random_sample();
        double V = standard_exponential();
        if (U <= 1.0 - shape) {
          double X = std::pow(U, 1.0 / shape);
          if (X <= V) return X;
        } else {
          double Y = -std::log((1.0 - U) / shape);
          double X = std::pow(1.0 - shape + shape * Y, 1.0 / shape);
          if (X <= V + Y) return X;
        }
      }
    }
    double b = shape - 1.0 / 3.0;
    double c = 1.0 / std::sqrt(9.0 * b);
    for (;;) {
      double X, V;
      do {
        X = standard_normal();
        V = 1.0 + c * X;
      } while (V <= 0.0);
      V = V * V * V;
      double U = random_sample();
      if (U < 1.0 - 0.0331 * (X * X) * (X * X)) return b * V;
      if (std::log(U) < 0.5 * X * X + b * (1.0 - V + std::log(V))) return b * V;
    }
  }

  double beta(double a, double b) {
    if (a <= 1.0 && b <= 1.0) {
      for (;;) {
        double U = random_sample();
        double V = random_sample();
        double X = std::pow(U, 1.0 / a);
        double Y = std::pow(V, 1.0 / b);
        if (X + Y <= 1.0) {
          if (X + Y > 0) return X / (X + Y);
          double logX = std::log(U) / a, logY = std::log(V) / b;
          double logM = logX > logY ? logX : logY;
          logX -= logM;
          logY -= logM;
          return std::exp(logX - std::log(std::exp(logX) + std::exp(logY)));
        }
      }
    }
    double Ga = standard_gamma(a);
    double Gb = standard_gamma(b);
    return Ga / (Ga + Gb);
  }
};

// ------------------------------------------------------ events and heap

constexpr uint8_t ARRIVAL = 1, DEPARTURE = 2;

struct Event {
  double time;
  int64_t event_id;
  int32_t server_id;   // -1 == None
  int32_t source_id;   // -1 == None
  uint8_t type;
  bool delayed;
  double arrival_time;
};

// CPython heapq mechanics (time-only strict <, same tie behavior)
struct Heap {
  std::vector<Event> h;

  static bool lt(const Event& a, const Event& b) { return a.time < b.time; }

  void siftdown(size_t startpos, size_t pos) {
    Event item = h[pos];
    while (pos > startpos) {
      size_t parent = (pos - 1) >> 1;
      if (lt(item, h[parent])) {
        h[pos] = h[parent];
        pos = parent;
      } else
        break;
    }
    h[pos] = item;
  }

  void siftup(size_t pos) {
    size_t endpos = h.size(), startpos = pos;
    Event item = h[pos];
    size_t child = 2 * pos + 1;
    while (child < endpos) {
      size_t right = child + 1;
      if (right < endpos && !lt(h[child], h[right])) child = right;
      h[pos] = h[child];
      pos = child;
      child = 2 * pos + 1;
    }
    h[pos] = item;
    siftdown(startpos, pos);
  }

  void push(const Event& e) {
    h.push_back(e);
    siftdown(0, h.size() - 1);
  }

  Event pop() {
    Event last = h.back();
    h.pop_back();
    if (!h.empty()) {
      Event ret = h[0];
      h[0] = last;
      siftup(0);
      return ret;
    }
    return last;
  }

  bool empty() const { return h.empty(); }
};

// -------------------------------------------------------------- network

enum DistKind : int8_t {
  D_EXPONENTIAL = 0,
  D_NORMAL = 1,
  D_UNIFORM = 2,
  D_GAMMA = 3,
  D_BETA = 4,
  D_BRANCH = 5,
  D_QUEUE = 6,
  D_DISCRETE = 7,
};

enum RouteMode : int8_t {
  R_WEIGHTED = 0,   // cdf searchsorted
  R_UNIFORM = 1,    // p not exactly 1 -> uniform over children
  R_SHORTEST = 2,   // shortest-queue (empty rows)
};

struct QueuedCustomer {
  double time;          // event scheduled time (total_time_in_queues uses it)
  double arrival_time;  // clock at enqueue
  int64_t event_id;
};

struct ServerState {
  std::deque<QueuedCustomer> queue;
  MT19937 rng;
  int in_service = 0;
  double total_time_in_service = 0;
  int64_t total_customers_served = 0;
  int64_t max_queue_length = 0;
  int64_t reneges = 0;
  double total_time_in_queue = 0;
  double cumulative_queue_length = 0;
  int64_t delayed_departures = 0;
  double len_since = 0;  // lazy time-at-length accounting
};

struct Record {
  double value;  // time or service_time
  int64_t event_id;
  int32_t server_id;
  uint8_t kind;  // 0 arrival, 1 processing, 2 departure, 3 delayed-sched
};

struct Engine {
  int n = 0;
  const int8_t* node_is_source;
  const int8_t* dist_kind;
  const double* dist_params;  // n*4
  // discrete distributions: per-node [disc_offsets[i], disc_offsets[i+1])
  // slices of sorted support (disc_xk) and its cumsum (disc_cum);
  // disc_int[i] != 0 -> integer support (scipy rv_discrete.rvs returns
  // int64, which str-formats without a trailing .0 -> record kind 4)
  const double* disc_xk = nullptr;
  const double* disc_cum = nullptr;
  const int64_t* disc_offsets = nullptr;
  const int8_t* disc_int = nullptr;
  const int64_t* queue_caps;
  // routing tables
  const int32_t* children;       // flattened
  const int64_t* child_offsets;  // n+1
  const double* cdf;             // aligned with children (weighted nodes)
  const int8_t* route_mode;
  const int8_t* is_sink;

  MT19937 global;  // routing RNG (the numpy global stream)
  std::vector<ServerState> servers;
  std::vector<MT19937> source_rngs;
  std::vector<double> source_arrival_times;
  std::vector<int64_t> source_customers;
  std::vector<double> next_departure;  // servers_next_departure (inf none)

  int64_t total_customers = 0;
  double total_arrival_time = 0;
  double total_time_in_queues = 0;
  int64_t current_customers_in_system = 0;
  double clock = 0;
  double previous_time = 0;
  bool use_next_available = false;
  bool gen_log = true;
  double deadline_epoch = 0;  // absolute; 0 = none

  std::vector<Record> records;
  int64_t record_limit = -1;   // -1 = unlimited
  int64_t records_emitted = 0;
  // end the run once record_limit records are emitted; set only where the
  // sim routes on a private stream, so its length moves no shared state
  bool stop_at_record_limit = false;
  bool stopped_at_record_limit = false;
  // the last run_one ended on its wall deadline, before its customer count
  bool stopped_on_wall = false;
  // queue-length-time buckets: dense n x qlt_cap
  std::vector<double> qlt;
  int qlt_cap = 0;

  Heap fel;

  void qlt_add(int sid, int64_t length, double dt) {
    if (length >= qlt_cap) length = qlt_cap - 1;
    qlt[(size_t)sid * qlt_cap + length] += dt;
  }

  void account_len(int sid, double now) {
    ServerState& s = servers[sid];
    int64_t length = (int64_t)s.queue.size() + s.delayed_departures;
    double dt = now - s.len_since;
    if (dt != 0) qlt_add(sid, length, dt);
    s.len_since = now;
  }

  void emit(uint8_t kind, double value, int64_t eid, int32_t sid) {
    if (!gen_log) return;
    records_emitted++;
    if (record_limit < 0 || (int64_t)records.size() < record_limit)
      records.push_back({value, eid, sid, kind});
  }

  double draw_dist(int node, MT19937& rng) {
    const double* p = dist_params + node * 4;
    switch (dist_kind[node]) {
      case D_EXPONENTIAL:
        return p[0] * rng.standard_exponential();
      case D_NORMAL:
        return p[0] + p[1] * rng.standard_normal();
      case D_UNIFORM:
        return p[0] + p[1] * rng.random_sample();
      case D_GAMMA:
        return p[1] + p[2] * rng.standard_gamma(p[0]);
      case D_BETA:
        return p[2] + p[3] * rng.beta(p[0], p[1]);
      case D_DISCRETE: {
        // rv_discrete.rvs == ppf(random_sample()): np.searchsorted(cum, u,
        // side='left') then clamp (core/rng.py Sampler.draw)
        double u = rng.random_sample();
        int64_t lo = disc_offsets[node], hi = disc_offsets[node + 1];
        int64_t a = lo, b = hi;  // first idx with cum[idx] >= u
        while (a < b) {
          int64_t m = (a + b) >> 1;
          if (disc_cum[m] < u) a = m + 1; else b = m;
        }
        if (a >= hi) a = hi - 1;
        return disc_xk[a];
      }
      default:
        return 0.0;
    }
  }

  // FlowBranchOperator.randomly_select_child on the global stream
  int32_t select_child(int node) {
    int64_t lo = child_offsets[node], hi = child_offsets[node + 1];
    int64_t cnt = hi - lo;
    if (route_mode[node] == R_UNIFORM) {
      return children[lo + (int64_t)global.interval((uint32_t)(cnt - 1))];
    }
    // weighted: searchsorted(cdf, u, 'right')
    double u = global.random_sample();
    int64_t a = lo, b = hi;  // first index with cdf[idx] > u
    while (a < b) {
      int64_t mid = (a + b) >> 1;
      if (cdf[mid] <= u)
        a = mid + 1;
      else
        b = mid;
    }
    int64_t idx = a - lo;
    if (idx >= cnt) idx = cnt - 1;
    return children[lo + idx];
  }

  // Sim.get_destination (reference :699-743)
  int32_t get_destination(int id) {
    bool shortest = route_mode[id] == R_SHORTEST;
    if (!node_is_source[id]) {
      if (dist_kind[id] == D_QUEUE || is_sink[id]) return -1;
    }
    if (shortest) {
      int64_t lo = child_offsets[id], hi = child_offsets[id + 1];
      int64_t best_len = INT64_MAX;
      int32_t best = -1;
      std::vector<int32_t> zero_children;
      for (int64_t k = lo; k < hi; k++) {
        int32_t c = children[k];
        if (c >= 0 && c < n && !node_is_source[c]) {
          int64_t sz = (int64_t)servers[c].queue.size();
          if (sz < best_len) {
            best_len = sz;
            best = c;
          }
          if (sz == 0) zero_children.push_back(c);
        }
      }
      if (use_next_available) {
        double best_t = HUGE_VAL;
        for (int32_t c : zero_children) {
          double t = next_departure[c];
          if (t < best_t) {
            best_t = t;
            best = c;
          }
        }
      }
      return best;
    }
    return select_child(id);
  }

  void schedule_departure(int32_t server_id, int64_t event_id, double wall_deadline) {
    if (server_id < 0) return;
    ServerState& s = servers[server_id];
    s.in_service = 1;
    s.total_customers_served += 1;
    double service_time = 0;
    bool fell_back = false;  // redraw-cap fallback yields a Python *float*
    if (dist_kind[server_id] != D_QUEUE && dist_kind[server_id] != D_BRANCH) {
      int redraws = 0;
      while (service_time <= 0) {
        service_time = draw_dist(server_id, s.rng);
        if (++redraws >= 10000) {
          service_time = 1e-9;
          fell_back = true;
          break;
        }
        if ((redraws & 1023) == 0 && wall_now() > wall_deadline) throw 1;
      }
    }
    // int-support discrete draws log as Python ints ("3"), but the 1e-9
    // fallback is assigned as a float in the Python engine and must log
    // as "1e-09" — kind must follow the VALUE's provenance, not the node.
    uint8_t pkind = (dist_kind[server_id] == D_DISCRETE &&
                     disc_int && disc_int[server_id] && !fell_back) ? 4 : 1;
    emit(pkind, service_time, event_id, server_id);
    s.total_time_in_service += service_time;
    Event dep{clock + service_time, event_id, server_id, -1, DEPARTURE, false, 0};
    fel.push(dep);
    next_departure[server_id] = dep.time;
  }

  void process_arrival(Event& evt, double wall_deadline) {
    int32_t server_id = evt.server_id;
    emit(0, clock, evt.event_id, server_id);

    if (server_id >= 0) {
      ServerState& s = servers[server_id];
      if (s.in_service == 0) {
        schedule_departure(server_id, evt.event_id, wall_deadline);
      } else if ((int64_t)s.queue.size() + s.delayed_departures < queue_caps[server_id]) {
        account_len(server_id, clock);
        s.queue.push_back({evt.time, clock, evt.event_id});
        if ((int64_t)s.queue.size() > s.max_queue_length)
          s.max_queue_length = (int64_t)s.queue.size();
      } else {
        s.reneges += 1;
      }
    }

    if (evt.source_id >= 0) {
      current_customers_in_system += 1;
      int sid = evt.source_id;
      double t = draw_dist(sid, source_rngs[sid]);
      total_arrival_time += t;
      source_arrival_times[sid] += t;
      source_customers[sid] += 1;
      // quirk: next arrival reuses this event's server_id (reference :580)
      Event nxt{clock + t, total_customers, server_id, sid, ARRIVAL, false, 0};
      total_customers += 1;
      fel.push(nxt);
    }
  }

  void process_departure(Event& evt, double wall_deadline) {
    emit(2, clock, evt.event_id, evt.server_id);
    int32_t server_id = evt.server_id;
    ServerState& s = servers[server_id];
    if (evt.delayed) {
      account_len(server_id, clock);
      s.delayed_departures -= 1;
      evt.delayed = false;
    }
    int32_t next_id = get_destination(server_id);

    if (next_id < 0) {
      int64_t lo = child_offsets[server_id], hi = child_offsets[server_id + 1];
      for (int64_t k = lo; k < hi; k++) {
        int32_t c = children[k];
        if (c >= 0 && c < n && !node_is_source[c] && servers[c].in_service == 0) {
          next_id = c;
          break;
        }
      }
    }

    if (next_id >= 0 || is_sink[server_id]) {
      if (!s.queue.empty()) {
        account_len(server_id, clock);
        QueuedCustomer customer = s.queue.front();
        s.queue.pop_front();
        total_time_in_queues += clock - customer.time;
        s.total_time_in_queue += clock - customer.arrival_time;
        schedule_departure(server_id, customer.event_id, wall_deadline);
        s.in_service = 1;
        s.cumulative_queue_length += (double)s.queue.size();
      } else {
        s.in_service = 0;
        next_departure[server_id] = 0;  // quirk: idle marker is 0
      }
      if (!is_sink[server_id]) {
        Event internal{clock, evt.event_id, next_id, -1, ARRIVAL, false, 0};
        process_arrival(internal, wall_deadline);
      }
    } else {
      int64_t lo = child_offsets[server_id], hi = child_offsets[server_id + 1];
      double next_dep = HUGE_VAL;
      for (int64_t k = lo; k < hi; k++) {
        int32_t c = children[k];
        if (c != server_id) {
          double t = (c >= 0 && c < n) ? next_departure[c] : HUGE_VAL;
          if (t < next_dep) next_dep = t;
        }
      }
      // schedule_delayed_departure (reference :679-697)
      if (total_customers < 100) emit(3, clock, evt.event_id, server_id);
      s.in_service = 1;
      account_len(server_id, clock);
      s.delayed_departures += 1;
      Event dep{next_dep, evt.event_id, server_id, -1, DEPARTURE, true, 0};
      fel.push(dep);
      next_departure[server_id] = dep.time;
      s.total_time_in_queue += next_dep - clock;
    }
  }

  void reset() {
    for (auto& s : servers) {
      s.queue.clear();
      s.in_service = 0;
      s.total_time_in_service = 0;
      s.total_customers_served = 0;
      s.max_queue_length = 0;
      s.reneges = 0;
      s.total_time_in_queue = 0;
      s.cumulative_queue_length = 0;
      s.delayed_departures = 0;
      s.len_since = 0;
    }
    std::fill(qlt.begin(), qlt.end(), 0.0);
    for (int i = 0; i < n; i++)
      source_arrival_times[i] = 0, source_customers[i] = 0;
    total_time_in_queues = 0;
    total_customers = 0;
    total_arrival_time = 0;
    clock = 0;
    std::fill(next_departure.begin(), next_departure.end(), HUGE_VAL);
  }

  void initialization(double wall_deadline) {
    for (int sid = 0; sid < n; sid++) {
      if (!node_is_source[sid]) continue;
      double t = draw_dist(sid, source_rngs[sid]);
      total_arrival_time += t;
      source_arrival_times[sid] += t;
      int32_t next_server = get_destination(sid);
      Event evt{clock + t, total_customers, next_server, sid, ARRIVAL, false, 0};
      total_customers += 1;
      source_customers[sid] += 1;
      fel.push(evt);
      (void)wall_deadline;
    }
  }

  // one replication; returns wall-interrupted flag
  bool run_one(int64_t number_of_customers, double wall_deadline) {
    fel = Heap();
    reset();
    stopped_on_wall = false;
    try {
      initialization(wall_deadline);
    } catch (int) {
      stopped_on_wall = true;
      return true;
    }
    previous_time = 0;
    bool interrupted = false;
    int64_t iter = 0;
    while (!fel.empty()) {
      Event evt = fel.pop();
      double td = evt.time - previous_time;
      if (evt.server_id >= 0 && evt.server_id < n && !node_is_source[evt.server_id]) {
        servers[evt.server_id].cumulative_queue_length +=
            td * (double)servers[evt.server_id].queue.size();
      }
      previous_time = evt.time;
      if (total_customers > number_of_customers - 1) break;
      clock = evt.time;
      try {
        if (evt.type == ARRIVAL)
          process_arrival(evt, wall_deadline);
        else
          process_departure(evt, wall_deadline);
      } catch (int) {
        interrupted = true;
        stopped_on_wall = true;
        break;
      }
      ++iter;
      // Records come a few per event, so records_emitted may pass the
      // limit by a few; the stored records are the first record_limit all
      // the same. Every later event only adds records nobody stores, so
      // nothing a caller reads changes, except for a sim that the caller's
      // watchdog would have cut after this point.
      if (stop_at_record_limit && records_emitted >= record_limit) {
        stopped_at_record_limit = true;
        break;
      }
      if (wall_now() > wall_deadline) {
        stopped_on_wall = true;
        break;
      }
    }
    for (int i = 0; i < n; i++)
      if (!node_is_source[i]) account_len(i, previous_time);
    return interrupted;
  }
};

// ------------------------------------------------- Python float repr
//
// CPython repr(float): shortest round-trip digit string (dtoa mode 0),
// fixed notation when the decimal point lands in [-3, 16] (i.e. exponential
// iff decpt-1 < -4 or decpt-1 >= 16), ".0" appended to integral fixed
// forms, exponent sign always written with >= 2 digits. std::to_chars
// (scientific, no precision) provides the same shortest digit string (both
// pick the representation nearest the value among the shortest); we
// re-assemble it under CPython's layout rules. Byte equality with repr()
// is fuzz-tested across magnitudes in tests/test_native_engine.py.
int py_float_repr(double v, char* out) {
  char tmp[64];
  auto res = std::to_chars(tmp, tmp + sizeof(tmp), v,
                           std::chars_format::scientific);
  if (!std::isfinite(v)) {
    // to_chars emits "inf"/"-inf"/"nan" with no exponent — exactly
    // CPython's repr — so copy it verbatim instead of parsing digits
    int n = int(res.ptr - tmp);
    std::memcpy(out, tmp, size_t(n));
    return n;
  }
  const char* p = tmp;
  char* q = out;
  if (*p == '-') { *q++ = '-'; ++p; }
  char digits[40];
  int nd = 0;
  digits[nd++] = *p++;
  if (p < res.ptr && *p == '.') {
    ++p;
    while (p < res.ptr && *p != 'e') digits[nd++] = *p++;
  }
  ++p;  // 'e'
  int esign = 1;
  if (*p == '-') { esign = -1; ++p; } else if (*p == '+') { ++p; }
  int e = 0;
  while (p < res.ptr) e = e * 10 + (*p++ - '0');
  e *= esign;            // value = d.ddd * 10^e
  int decpt = e + 1;     // value = 0.digits * 10^decpt
  if (decpt - 1 >= -4 && decpt - 1 < 16) {
    if (decpt <= 0) {
      *q++ = '0'; *q++ = '.';
      for (int i = 0; i < -decpt; i++) *q++ = '0';
      for (int i = 0; i < nd; i++) *q++ = digits[i];
    } else if (decpt >= nd) {
      for (int i = 0; i < nd; i++) *q++ = digits[i];
      for (int i = nd; i < decpt; i++) *q++ = '0';
      *q++ = '.'; *q++ = '0';
    } else {
      for (int i = 0; i < decpt; i++) *q++ = digits[i];
      *q++ = '.';
      for (int i = decpt; i < nd; i++) *q++ = digits[i];
    }
  } else {
    *q++ = digits[0];
    if (nd > 1) {
      *q++ = '.';
      for (int i = 1; i < nd; i++) *q++ = digits[i];
    }
    *q++ = 'e';
    int ev = decpt - 1;
    *q++ = ev < 0 ? '-' : '+';
    if (ev < 0) ev = -ev;
    char eb[8];
    int ne = 0;
    while (ev) { eb[ne++] = char('0' + ev % 10); ev /= 10; }
    while (ne < 2) eb[ne++] = '0';
    while (ne) *q++ = eb[--ne];
  }
  return int(q - out);
}

const char* const kKindNames[5] = {
    "arrival", "processing", "departure",
    "Scheduling delayed departure from server",
    "processing"};  // kind 4: processing with INTEGER time formatting
const int kKindLens[5] = {7, 10, 9, 40, 10};

// ------------------------------------------- MM-GAN batch host stage
//
// One call for the whole training batch: decode the generator matrices
// exactly as gandes_tpu.bridge.mmgan_decode._decode_sample does (same
// global-MT19937 consumption: Fisher-Yates permutation for the source
// subset, one uniform choice per row repair, the self-reseed, the
// replication-seed draw), build the FlowBranchOperator routing tables with
// the same float semantics (numpy pairwise row sums, left-to-right kept
// normalization, builtin-sum exactness test for the uniform fallback,
// cumsum cdf), then run every sim on the engine above. With n_threads==1
// the sims route on the global stream in sample order — BIT-IDENTICAL to
// the sequential parity path (matrix_to_midi(parallel=None)). With
// n_threads>1 each sample gets a private routing stream seeded from one
// extra global randint(0, 2^31-1) per sample (the Python thread mode's
// stream discipline) and sims run on C++ worker threads so their wall
// budgets overlap.
//
// numpy's pairwise summation (umath loops.c.src): sequential under 8
// elements, 8 unrolled accumulators up to a 128 block, halved recursion
// (cut to a multiple of 8) above. Verified bit-equal to np.sum across
// magnitudes/sizes in tests/test_native_batch.py.
double np_pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; i++) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
    double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8) {
      r0 += a[i + 0]; r1 += a[i + 1]; r2 += a[i + 2]; r3 += a[i + 3];
      r4 += a[i + 4]; r5 += a[i + 5]; r6 += a[i + 6]; r7 += a[i + 7];
    }
    double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
    for (; i < n; i++) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return np_pairwise_sum(a, n2) + np_pairwise_sum(a + n2, n - n2);
}

// everything one decoded sample needs to run independently
struct BatchSample {
  int dim = 0;
  std::vector<int8_t> node_is_source;
  std::vector<int8_t> dist_kind;
  std::vector<double> dist_params;   // dim*4
  std::vector<int64_t> queue_caps;
  std::vector<int32_t> children;
  std::vector<int64_t> child_offsets;
  std::vector<double> cdf;
  std::vector<int8_t> route_mode;
  std::vector<int8_t> is_sink;
  int64_t seed = 0;
  int64_t num_customers = 0;
  double budget = 0;     // min(gen2[5], 1.0) sim wall budget
  uint32_t routing_seed = 0;  // threads mode only
  // the repaired routing matrix (dim*dim), from decode_one to build_routing
  std::vector<double> A;
  // results
  int64_t stored = 0;  // records in the sample's slot of the output arrays
  int64_t emitted = 0;
  int8_t timed_out = 0;
  int8_t capped = 0;  // the run stopped at record_limit
};

// decode one sample, consuming `global` exactly like _decode_sample; the
// routing tables, which draw nothing, are left to build_routing.
// Returns 0 ok, 1 "no nonzero off-diagonal" repair error (the Python path
// raises ValueError there; the caller restores its RNG snapshot and
// replays the batch on the Python path so the exception surfaces
// identically).
int decode_one(const float* mat /*size*size, already |.|? no: raw*/,
               const double* g2, int gen2_is_f32, int size, int num_aug,
               MT19937& global, BatchSample& s,
               double* out_instruments, double* out_note_levels,
               int instrument_override) {
  const int dim = size - num_aug;
  s.dim = dim;

  // |matrix| in float32, as the Python decode does before any other use
  std::vector<float> m((size_t)size * size);
  for (int i = 0; i < size * size; i++) m[i] = std::fabs(mat[i]);

  // sources = np.random.choice(dim, dim//4, replace=False)
  //         = permutation(dim)[:dim//4] = legacy Fisher-Yates shuffle
  std::vector<int32_t> perm(dim);
  for (int i = 0; i < dim; i++) perm[i] = i;
  for (int i = dim - 1; i > 0; i--) {
    uint32_t j = global.interval((uint32_t)i);
    std::swap(perm[i], perm[j]);
  }
  const int n_src = dim / 4;
  std::vector<int8_t> is_source(dim, 0);
  for (int k = 0; k < n_src; k++) is_source[perm[k]] = 1;

  for (int i = 0; i < dim; i++) {
    if (instrument_override >= 0) {
      out_instruments[i] = (double)instrument_override;
    } else {
      out_instruments[i] = (double)(int64_t)(m[(size_t)(dim + 1) * size + i] * 126.0f);
    }
    // max(0, int(x*126) % 128) with x >= 0: C % matches Python here
    int64_t v = (int64_t)(m[(size_t)(dim + 2) * size + i] * 126.0f) % 128;
    out_note_levels[i] = (double)(v < 0 ? 0 : v);
  }

  // distributions: normal(|g2[1]|*50, |g2[2]|*50) for sources,
  // normal(|g2[3]|*10, |g2[4]|*10) for servers — the multiply happens in
  // the generator output's dtype (f32 under NumPy 2 weak promotion)
  double src_loc, src_scale, srv_loc, srv_scale;
  if (gen2_is_f32) {
    src_loc = (double)std::fabs((float)g2[1] * 50.0f);
    src_scale = (double)std::fabs((float)g2[2] * 50.0f);
    srv_loc = (double)std::fabs((float)g2[3] * 10.0f);
    srv_scale = (double)std::fabs((float)g2[4] * 10.0f);
  } else {
    src_loc = std::fabs(g2[1] * 50.0);
    src_scale = std::fabs(g2[2] * 50.0);
    srv_loc = std::fabs(g2[3] * 10.0);
    srv_scale = std::fabs(g2[4] * 10.0);
  }

  // routing sub-matrix: zero source columns + diagonals in f32, then f64
  std::vector<double> A((size_t)dim * dim);
  for (int i = 0; i < dim; i++)
    for (int j = 0; j < dim; j++) {
      float v = m[(size_t)i * size + j];
      if (is_source[j] || i == j) v = 0.0f;
      A[(size_t)i * dim + j] = (double)v;
    }

  // row normalize (numpy pairwise row sums; 0/0 -> NaN -> 0)
  for (int i = 0; i < dim; i++) {
    double* row = A.data() + (size_t)i * dim;
    double rs = np_pairwise_sum(row, dim);
    for (int j = 0; j < dim; j++) {
      double v = row[j] / rs;
      row[j] = std::isnan(v) ? 0.0 : v;
    }
  }

  // row repair: one uniform choice over nonzero off-diagonals per row,
  // drawn unconditionally (reference consumes the draw even when the row
  // already sums to 1)
  std::vector<int32_t> cand(dim);
  for (int i = 0; i < dim; i++) {
    double* row = A.data() + (size_t)i * dim;
    int nc = 0;
    for (int j = 0; j < dim; j++)
      if (j != i && row[j] != 0.0) cand[nc++] = j;
    if (nc == 0) return 1;
    int32_t pick = cand[global.interval((uint32_t)(nc - 1))];
    row[pick] += 1.0 - np_pairwise_sum(row, dim);
  }
  for (int i = 0; i < dim; i++)
    A[(size_t)i * dim + i] = is_source[i] ? 1.0 : -1.0;

  // np.random.seed(np.random.randint(0, 99999, size=1)): a length-1 array
  // seed squeezes to a scalar -> plain init_genrand (verified vs numpy)
  long v1 = global.randint(0, 99999);
  global.seed((uint32_t)v1);
  s.seed = global.randint(0, 99999);

  double c6 = gen2_is_f32 ? (double)(3000.0f * (float)g2[6]) : 3000.0 * g2[6];
  int64_t num_customers = (int64_t)c6;
  if (num_customers < 1000) num_customers = 1000;
  if (num_customers < 200) num_customers = 200;  // structural parity
  s.num_customers = num_customers;
  s.budget = std::min(g2[5], 1.0);  // float(gen2[5]) is exact for f32

  // ---- FlowBranchOperator tables (Sim.__init__ semantics) ----
  s.node_is_source.assign(dim, 0);
  s.dist_kind.assign(dim, D_NORMAL);
  s.dist_params.assign((size_t)dim * 4, 0.0);
  s.queue_caps.assign(dim, 2 * 127);
  s.child_offsets.assign(dim + 1, 0);
  s.route_mode.assign(dim, R_WEIGHTED);
  s.is_sink.assign(dim, 0);
  s.children.clear();
  s.cdf.clear();
  for (int i = 0; i < dim; i++) {
    s.node_is_source[i] = is_source[i];
    s.dist_params[(size_t)i * 4 + 0] = is_source[i] ? src_loc : srv_loc;
    s.dist_params[(size_t)i * 4 + 1] = is_source[i] ? src_scale : srv_scale;
  }
  s.A = std::move(A);
  return 0;
}

// FlowBranchOperator tables (Sim.__init__ semantics) of a decoded sample,
// and its shortest-queue notices. Draws nothing, so in thread mode each
// worker builds its own sample's.
void build_routing(BatchSample& s, int32_t* notice_nodes, int64_t* notice_count) {
  const int dim = s.dim;
  const int8_t* is_source = s.node_is_source.data();
  std::vector<int8_t> row_shortest(dim, 0);
  std::vector<double> plist(dim);
  for (int i = 0; i < dim; i++) {
    const double* row = s.A.data() + (size_t)i * dim;
    // probabilities = row with diag zeroed; children = indices with p > 0
    int np_ = 0;
    int64_t child_id_sum = 0;
    double total = 0.0;  // left-to-right over kept, like the Python loop
    int first_child = -1;
    for (int j = 0; j < dim; j++) {
      double p = (j == i) ? 0.0 : row[j];
      if (p > 0.0) {
        s.children.push_back(j);
        child_id_sum += j;
        plist[np_] = p;  // raw kept value; normalized below
        total += p;
        if (first_child < 0) first_child = j;
        np_++;
      }
    }
    s.child_offsets[i + 1] = (int64_t)s.children.size();
    for (int k = 0; k < np_; k++) plist[k] /= total;

    double np_sum = np_pairwise_sum(plist.data(), np_);
    bool shortest = std::fabs(1.0 - np_sum) > 0.0001;
    row_shortest[i] = shortest ? 1 : 0;
    // builtin sum() left-to-right from int 0 — the exact-1.0 gate that
    // picks weighted-cdf vs uniform routing
    double bsum = 0.0;
    for (int k = 0; k < np_; k++) bsum += plist[k];
    bool p_exact = np_ > 0 && bsum == 1.0;
    s.route_mode[i] = shortest ? R_SHORTEST : (p_exact ? R_WEIGHTED : R_UNIFORM);
    s.is_sink[i] = (np_ == 0 || child_id_sum == 0) ? 1 : 0;

    // cdf = cumsum(plist)/cumsum[-1] (sequential accumulate, as np.cumsum)
    double acc = 0.0;
    size_t cdf_base = s.cdf.size();
    for (int k = 0; k < np_; k++) {
      acc += plist[k];
      s.cdf.push_back(acc);
    }
    for (int k = 0; k < np_; k++) s.cdf[cdf_base + k] /= acc;
  }

  // shortest-queue notices appear in the log in Sim.__init__ order:
  // sources ascending, then servers ascending
  int64_t nn = 0;
  for (int pass = 0; pass < 2; pass++)
    for (int i = 0; i < dim; i++)
      if ((pass == 0) == (is_source[i] != 0) && row_shortest[i])
        notice_nodes[nn++] = i;
  *notice_count = nn;
  s.A = std::vector<double>();
}

// the heap buffers a worker hands from one sample's engine to the next: a
// sim then reuses pages the worker's last sim touched, where fresh ones
// would each cost a page fault
struct EngineBuffers {
  std::vector<ServerState> servers;
  std::vector<MT19937> source_rngs;
  std::vector<Record> records;
};

// the output arrays' slot of one sample: record_limit records from these
struct RecordSlot {
  double* values;
  int64_t* ids;
  int32_t* servers;
  uint8_t* kinds;
};

void run_batch_sample(BatchSample& s, MT19937* global, double watchdog,
                      int64_t record_limit, RecordSlot out, EngineBuffers& keep) {
  Engine eng;
  const int dim = s.dim;
  eng.n = dim;
  eng.node_is_source = s.node_is_source.data();
  eng.dist_kind = s.dist_kind.data();
  eng.dist_params = s.dist_params.data();
  eng.queue_caps = s.queue_caps.data();
  eng.children = s.children.data();
  eng.child_offsets = s.child_offsets.data();
  eng.cdf = s.cdf.data();
  eng.route_mode = s.route_mode.data();
  eng.is_sink = s.is_sink.data();
  eng.use_next_available = false;
  eng.gen_log = true;
  eng.record_limit = record_limit;
  eng.records = std::move(keep.records);
  eng.records.clear();
  eng.records.reserve((size_t)record_limit);
  if (global != nullptr) {
    eng.global = *global;  // sequential parity mode: shared global stream
  } else {
    eng.global.seed(s.routing_seed);  // threads mode: private stream
    // a private stream's draws past the last stored record reach nobody
    eng.stop_at_record_limit = true;
  }
  // a kept server's state is the last sim's until run_one's reset(), which
  // clears all of it but the rng; every server's rng is seeded below, and
  // so is every source's (a node's other rng is never drawn from)
  eng.servers = std::move(keep.servers);
  eng.servers.resize(dim);
  eng.source_rngs = std::move(keep.source_rngs);
  eng.source_rngs.resize(dim);
  eng.source_arrival_times.assign(dim, 0.0);
  eng.source_customers.assign(dim, 0);
  eng.next_departure.assign(dim, HUGE_VAL);
  eng.qlt_cap = 1;  // the queue-length statistics are unused by this path
  eng.qlt.assign((size_t)dim * eng.qlt_cap, 0.0);

  double t0 = wall_now();
  MT19937 master;
  master.seed((uint32_t)s.seed);
  std::vector<MT19937*> gens;
  std::vector<uint32_t> seeds;
  gens.reserve(dim);
  seeds.reserve(dim);
  for (int i = 0; i < dim; i++)
    if (!s.node_is_source[i]) gens.push_back(&eng.servers[i].rng);
  for (int i = 0; i < dim; i++)
    if (s.node_is_source[i]) gens.push_back(&eng.source_rngs[i]);
  for (size_t k = 0; k < gens.size(); k++) seeds.push_back((uint32_t)master.randint(3, 9999999));
  MT19937::seed_many(gens.data(), seeds.data(), (int)gens.size());
  double budget = std::min(s.budget, watchdog);
  eng.run_one(s.num_customers, t0 + budget);
  s.timed_out = (wall_now() - t0 > watchdog) ? 1 : 0;
  s.capped = eng.stopped_at_record_limit ? 1 : 0;
  s.emitted = eng.records_emitted;
  s.stored = (int64_t)eng.records.size();
  for (int64_t k = 0; k < s.stored; k++) {
    const Record& r = eng.records[(size_t)k];
    out.values[k] = r.value;
    out.ids[k] = r.event_id;
    out.servers[k] = r.server_id;
    out.kinds[k] = r.kind;
  }
  if (global != nullptr) *global = eng.global;
  keep.servers = std::move(eng.servers);
  keep.source_rngs = std::move(eng.source_rngs);
  keep.records = std::move(eng.records);
}

}  // namespace

extern "C" {

// Format records [start, end) as newline-separated log lines, byte-equal
// to gandes_tpu.des.native.materialize_records' Python formatting
// (incl. the branch-node "0" processing-time quirk and server -1 -> None).
// Returns bytes written, or -1 if out_cap could be exceeded.
int64_t des_format_records(const double* values, const int64_t* ids,
                           const int32_t* servers, const uint8_t* kinds,
                           int64_t start, int64_t end,
                           char* out, int64_t out_cap) {
  char* q = out;
  char* lim = out + out_cap;
  for (int64_t k = start; k < end; k++) {
    if (lim - q < 128) return -1;
    if (k > start) *q++ = '\n';
    std::memcpy(q, "INFO:root:", 10); q += 10;
    uint8_t kk = kinds[k];
    if (kk == 1 && values[k] == 0.0) {
      *q++ = '0';
    } else if (kk == 4) {
      // integer-support discrete service time: Python logs the int64
      q = std::to_chars(q, q + 24, (long long)values[k]).ptr;
    } else {
      q += py_float_repr(values[k], q);
    }
    std::memcpy(q, " - ", 3); q += 3;
    q = std::to_chars(q, q + 24, (long long)ids[k]).ptr;
    std::memcpy(q, " - ", 3); q += 3;
    if (servers[k] >= 0 || (kk == 1 && values[k] == 0.0)) {
      q = std::to_chars(q, q + 16, (int)servers[k]).ptr;
    } else {
      std::memcpy(q, "None", 4); q += 4;
    }
    std::memcpy(q, " - ", 3); q += 3;
    std::memcpy(q, kKindNames[kk], kKindLens[kk]); q += kKindLens[kk];
  }
  return q - out;
}

// Runs all replications. Returns a bit set: 1 a replication was interrupted
// inside an event (the seed loop stops, as the Python engine's does), 2 a
// replication ended on its wall deadline (max_sim_time) before its customer
// count, whether inside an event or between two.
// Outputs are written into caller buffers; the record buffer is allocated
// here (grown as needed) and must be freed with des_free_records.
int des_run(
    // network
    int n, const int8_t* node_is_source, const int8_t* dist_kind,
    const double* dist_params, const int64_t* queue_caps,
    const int32_t* children, const int64_t* child_offsets, const double* cdf,
    const int8_t* route_mode, const int8_t* is_sink,
    // discrete-distribution tables (may be NULL when no discrete nodes)
    const double* disc_xk, const double* disc_cum,
    const int64_t* disc_offsets, const int8_t* disc_int,
    // run config
    const int64_t* seeds, int num_seeds, int64_t number_of_customers,
    int use_next_available, double max_sim_time_s, int gen_log,
    int64_t record_limit,
    // global RNG state in/out
    uint32_t* g_key, int* g_pos, int* g_has_gauss, double* g_gauss,
    // outputs (per-node arrays of length n; LAST replication)
    double* out_time_in_service, int64_t* out_served, double* out_time_in_queue,
    double* out_cumulative_queue_length, int64_t* out_max_queue_length,
    int64_t* out_reneges, int64_t* out_delayed,
    double* out_qlt, int qlt_cap,
    double* out_src_arrival_times, int64_t* out_src_customers,
    int64_t* dealt_seeds,  // num_seeds * n (server/source dealing order: node id)
    // per-replication stats (record_history support): pass NULL to skip.
    // rep_stats: (num_seeds, n, 9) = [tis, tiq, served, reneges, mql, cql,
    //            delayed, src_arrival_times, src_customers]
    // rep_totals: (num_seeds, 4) = [clock, total_customers,
    //            total_arrival_time, total_time_in_queues]
    // rep_qlt: (num_seeds, n, qlt_cap)
    double* rep_stats, double* rep_totals, double* rep_qlt,
    double* out_totals,    // [clock, previous_time, total_arrival_time,
                           //  total_time_in_queues, total_customers, ccis,
                           //  records_emitted]
    // records
    double** rec_values, int64_t** rec_ids, int32_t** rec_servers,
    uint8_t** rec_kinds, int64_t* rec_count) {
  Engine eng;
  eng.n = n;
  eng.node_is_source = node_is_source;
  eng.dist_kind = dist_kind;
  eng.dist_params = dist_params;
  eng.queue_caps = queue_caps;
  eng.children = children;
  eng.child_offsets = child_offsets;
  eng.cdf = cdf;
  eng.route_mode = route_mode;
  eng.is_sink = is_sink;
  eng.disc_xk = disc_xk;
  eng.disc_cum = disc_cum;
  eng.disc_offsets = disc_offsets;
  eng.disc_int = disc_int;
  eng.use_next_available = use_next_available != 0;
  eng.gen_log = gen_log != 0;
  eng.record_limit = record_limit;

  std::memcpy(eng.global.key, g_key, 624 * sizeof(uint32_t));
  eng.global.pos = *g_pos;
  eng.global.has_gauss = *g_has_gauss != 0;
  eng.global.gauss = *g_gauss;

  eng.servers.resize(n);
  eng.source_rngs.resize(n);
  eng.source_arrival_times.assign(n, 0.0);
  eng.source_customers.assign(n, 0);
  eng.next_departure.assign(n, HUGE_VAL);
  eng.qlt_cap = qlt_cap;
  eng.qlt.assign((size_t)n * qlt_cap, 0.0);

  bool interrupted = false, stopped_on_wall = false;
  for (int r = 0; r < num_seeds; r++) {
    MT19937 master;
    master.seed((uint32_t)seeds[r]);
    // deal seeds: servers in id order, then sources (reference :446-456)
    for (int i = 0; i < n; i++) {
      if (!node_is_source[i]) {
        long s = master.randint(3, 9999999);
        eng.servers[i].rng.seed((uint32_t)s);
        dealt_seeds[(size_t)r * n + i] = s;
      }
    }
    for (int i = 0; i < n; i++) {
      if (node_is_source[i]) {
        long s = master.randint(3, 9999999);
        eng.source_rngs[i].seed((uint32_t)s);
        dealt_seeds[(size_t)r * n + i] = s;
      }
    }
    // the Python engine always has a wall budget (max_sim_time defaults
    // to 1000); a zero or negative budget means "stop after the first
    // event", not "unlimited"
    double wall_deadline = wall_now() + max_sim_time_s;
    bool rep_interrupted = eng.run_one(number_of_customers, wall_deadline);
    interrupted = interrupted || rep_interrupted;
    stopped_on_wall = stopped_on_wall || eng.stopped_on_wall;
    if (rep_stats != nullptr) {
      for (int i = 0; i < n; i++) {
        double* row = rep_stats + ((size_t)r * n + i) * 9;
        row[0] = eng.servers[i].total_time_in_service;
        row[1] = eng.servers[i].total_time_in_queue;
        row[2] = (double)eng.servers[i].total_customers_served;
        row[3] = (double)eng.servers[i].reneges;
        row[4] = (double)eng.servers[i].max_queue_length;
        row[5] = eng.servers[i].cumulative_queue_length;
        row[6] = (double)eng.servers[i].delayed_departures;
        row[7] = eng.source_arrival_times[i];
        row[8] = (double)eng.source_customers[i];
      }
      rep_totals[(size_t)r * 4 + 0] = eng.clock;
      rep_totals[(size_t)r * 4 + 1] = (double)eng.total_customers;
      rep_totals[(size_t)r * 4 + 2] = eng.total_arrival_time;
      rep_totals[(size_t)r * 4 + 3] = eng.total_time_in_queues;
      if (rep_qlt != nullptr)
        std::memcpy(rep_qlt + (size_t)r * n * qlt_cap, eng.qlt.data(),
                    sizeof(double) * (size_t)n * qlt_cap);
    }
    if (rep_interrupted) break;  // Python engine breaks the seed loop too
  }

  for (int i = 0; i < n; i++) {
    out_time_in_service[i] = eng.servers[i].total_time_in_service;
    out_served[i] = eng.servers[i].total_customers_served;
    out_time_in_queue[i] = eng.servers[i].total_time_in_queue;
    out_cumulative_queue_length[i] = eng.servers[i].cumulative_queue_length;
    out_max_queue_length[i] = eng.servers[i].max_queue_length;
    out_reneges[i] = eng.servers[i].reneges;
    out_delayed[i] = eng.servers[i].delayed_departures;
    out_src_arrival_times[i] = eng.source_arrival_times[i];
    out_src_customers[i] = eng.source_customers[i];
  }
  std::memcpy(out_qlt, eng.qlt.data(), sizeof(double) * (size_t)n * qlt_cap);
  out_totals[0] = eng.clock;
  out_totals[1] = eng.previous_time;
  out_totals[2] = eng.total_arrival_time;
  out_totals[3] = eng.total_time_in_queues;
  out_totals[4] = (double)eng.total_customers;
  out_totals[5] = (double)eng.current_customers_in_system;
  out_totals[6] = (double)eng.records_emitted;

  std::memcpy(g_key, eng.global.key, 624 * sizeof(uint32_t));
  *g_pos = eng.global.pos;
  *g_has_gauss = eng.global.has_gauss ? 1 : 0;
  *g_gauss = eng.global.gauss;

  int64_t cnt = (int64_t)eng.records.size();
  *rec_count = cnt;
  if (cnt > 0) {
    double* v = (double*)std::malloc(sizeof(double) * cnt);
    int64_t* ids = (int64_t*)std::malloc(sizeof(int64_t) * cnt);
    int32_t* srv = (int32_t*)std::malloc(sizeof(int32_t) * cnt);
    uint8_t* kinds = (uint8_t*)std::malloc(sizeof(uint8_t) * cnt);
    for (int64_t i = 0; i < cnt; i++) {
      v[i] = eng.records[i].value;
      ids[i] = eng.records[i].event_id;
      srv[i] = eng.records[i].server_id;
      kinds[i] = eng.records[i].kind;
    }
    *rec_values = v;
    *rec_ids = ids;
    *rec_servers = srv;
    *rec_kinds = kinds;
  } else {
    *rec_values = nullptr;
    *rec_ids = nullptr;
    *rec_servers = nullptr;
    *rec_kinds = nullptr;
  }
  return (interrupted ? 1 : 0) | (stopped_on_wall ? 2 : 0);
}

void des_free_records(double* v, int64_t* ids, int32_t* srv, uint8_t* kinds) {
  std::free(v);
  std::free(ids);
  std::free(srv);
  std::free(kinds);
}

// MM-GAN host stage for one whole training batch (see decode_one above).
// Returns 0 ok; 1 decode error at *err_index (global RNG state is then
// mid-stream garbage — the caller must restore its own snapshot and replay
// on the Python path, which raises the matching ValueError); 2 a negative
// record_limit (the records' arrays need a bound).
// n_threads == 1: sims run inline, routing on the global stream, output
// bit-identical to matrix_to_midi(parallel=None). n_threads > 1: sims run
// on worker threads with private routing streams (one extra global
// randint(0, 2^31-1) per sample, the Python thread mode's discipline), and
// each stops once it has emitted record_limit records (out_capped).
int mmgan_host_batch(
    int B, int size, int num_aug,
    const float* gen1,              // B*size*size
    const double* gen2,             // B*gen2_width (f64 view of the batch)
    int gen2_width, int gen2_is_f32,
    int instrument_override,        // -1 = decode from matrix row dim+1
    double watchdog, int64_t record_limit, int n_threads,
    // global RNG state in/out
    uint32_t* g_key, int* g_pos, int* g_has_gauss, double* g_gauss,
    // per-sample outputs (caller-allocated)
    int64_t* out_emitted, int8_t* out_timed_out, int8_t* out_capped,
    int64_t* out_customers,
    int32_t* out_notice_nodes,      // B*(size-num_aug)
    int64_t* out_notice_counts,     // B
    double* out_instruments,        // B*(size-num_aug)
    double* out_note_levels,        // B*(size-num_aug)
    // records (caller-allocated, B*record_limit each): sample b's first
    // out_stored[b] records from b*record_limit on
    double* rec_values, int64_t* rec_ids, int32_t* rec_servers,
    uint8_t* rec_kinds, int64_t* out_stored,
    int32_t* err_index) {
  const int dim = size - num_aug;
  *err_index = -1;
  if (record_limit < 0) return 2;

  MT19937 global;
  std::memcpy(global.key, g_key, 624 * sizeof(uint32_t));
  global.pos = *g_pos;
  global.has_gauss = *g_has_gauss != 0;
  global.gauss = *g_gauss;

  auto slot = [&](int b) {
    size_t at = (size_t)b * (size_t)record_limit;
    return RecordSlot{rec_values + at, rec_ids + at, rec_servers + at, rec_kinds + at};
  };
  std::vector<BatchSample> samples(B);
  auto decode = [&](int b) {
    return decode_one(gen1 + (size_t)b * size * size,
                      gen2 + (size_t)b * gen2_width, gen2_is_f32, size,
                      num_aug, global, samples[b],
                      out_instruments + (size_t)b * dim,
                      out_note_levels + (size_t)b * dim,
                      instrument_override);
  };
  auto run = [&](int b, MT19937* routing, EngineBuffers& keep) {
    build_routing(samples[b], out_notice_nodes + (size_t)b * dim, out_notice_counts + b);
    run_batch_sample(samples[b], routing, watchdog, record_limit, slot(b), keep);
  };

  if (n_threads <= 1) {
    // sequential mode: sims route on the global stream, so decode and run
    // must INTERLEAVE per sample exactly like the Python loop (decode(b)
    // reads the stream run(b-1) left behind)
    EngineBuffers keep;
    for (int b = 0; b < B; b++) {
      if (decode(b) != 0) {
        *err_index = b;
        return 1;
      }
      out_customers[b] = samples[b].num_customers;
      run(b, &global, keep);
    }
  } else {
    // thread mode: this thread decodes the batch in order (the Python
    // thread path's draws: each sample's decode, then its private routing
    // seed) while the workers take each decoded sample, build its routing
    // tables and run its sim
    std::atomic<int> decoded(0);  // samples [0, decoded) are ready
    std::atomic<bool> stop(false);
    std::atomic<int> next(0);
    auto worker = [&]() {
      EngineBuffers keep;
      for (;;) {
        int b = next.fetch_add(1);
        if (b >= B) return;
        while (decoded.load(std::memory_order_acquire) <= b) {
          if (stop.load(std::memory_order_acquire)) return;
          std::this_thread::yield();
        }
        run(b, nullptr, keep);
      }
    };
    int nt = std::min(n_threads, B);
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; t++) pool.emplace_back(worker);
    for (int b = 0; b < B; b++) {
      if (decode(b) != 0) {
        *err_index = b;
        stop.store(true, std::memory_order_release);
        break;
      }
      samples[b].routing_seed = (uint32_t)global.randint(0, 2147483647L);
      out_customers[b] = samples[b].num_customers;
      decoded.store(b + 1, std::memory_order_release);
    }
    for (auto& t : pool) t.join();
    if (*err_index >= 0) return 1;
  }

  for (int b = 0; b < B; b++) {
    out_stored[b] = samples[b].stored;
    out_emitted[b] = samples[b].emitted;
    out_timed_out[b] = samples[b].timed_out;
    out_capped[b] = samples[b].capped;
  }

  std::memcpy(g_key, global.key, 624 * sizeof(uint32_t));
  *g_pos = global.pos;
  *g_has_gauss = global.has_gauss ? 1 : 0;
  *g_gauss = global.gauss;
  return 0;
}
}
