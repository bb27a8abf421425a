// K1: piano-roll rasterizer for Hopper, sm_90a.
//
// Replaces the TPU kernel gandes_tpu/ops/pallas_roll.py::_kernel, launched by
// _rasterize_pallas (pl.pallas_call at pallas_roll.py:95). Same function: for
// each sample b, walk its events e in order (last writer wins) and, for a note
// in [0, 128),
//   channel 0: roll[b, 0, note, on]      = vel      (if vel >= 0, 0 <= on < T)
//   channel 1: roll[b, 1, note, on:off]  = off - on (clipped to [0, T))
// with on/off already shifted by `start`. Slots with note < 0 are padding; the
// walk stops after the sample's last valid event (its trip count), so a
// shared pad tail is never walked.
//
// What bounds it on this card: bytes. It reads 16 B per event (the notes of
// a pad tail only) and writes 4 B per roll cell, with a few integer
// operations per event and cell; at the pickler's shape (B 8, E 4096,
// T 300) that is 2.98 MB, 0.9 us at 3.35 TB/s. What the design does:
//
// * Order is a maximum, not a walk. "The last writer wins" is "the highest
//   event index that covers the cell wins". A CTA keeps, per cell of its
//   tile, the highest covering index + 1 in shared memory and folds events
//   in with atomicMax, in any order and from any thread; a maximum does not
//   depend on the order, so every launch gives the same bits. No thread
//   walks a pitch row alone: a skewed file (one pitch) spreads over all the
//   CTA's lanes, merged by the larger index.
// * Fill the card. The grid is (sample, 4-pitch tile, 512-column tile):
//   32 x ceil(T / 512) CTAs per sample, 256 at the pickler's B = 8, two on
//   an SM. Any T >= 1: a tile's 16 KB index array and 16 KB of event
//   queues are static shared memory.
// * Loads in flight, full warps. A thread takes 16 events of each
//   4096-event chunk and issues their 16 coalesced note loads together
//   (pickler rows hold any E, so a row is not 16-byte aligned; 4-byte loads
//   with neighbouring threads on neighbouring events move the same 32-byte
//   sectors). A warp ballots which of its 512 events lie in the tile and
//   queues them in shared memory, in order of a prefix count; its lanes then
//   take the queue four events each, with those events' on / off / vel loads
//   in flight together, and fold them. A lane folds whole events, so a
//   shared-memory atomic has as many active lanes as the warp has events.
// * The trip count. Chunks are walked from the last one down; chunks whose
//   notes are all < 0 (the pad tail) are skipped after their notes are read,
//   one block-wide vote each, and no other field of them is read. Within the
//   first chunk that holds a valid note, the slots past it are pad (note < 0)
//   and are never queued.
// * One pass out. After the fold (one barrier), warp w writes the tile's
//   rows w, w + 8, ... ([channel][row]) with lanes on neighbouring columns:
//   zero where no event won, else the winner's velocity or off - on, loaded
//   by index (the row's loads in flight together). Every output cell is
//   written once, by one thread; no zero-fill or copy of the roll.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 16;                       // events per thread per chunk
constexpr int CHUNK = THREADS * UNROLL;          // 4096 events
constexpr int PITCH_TILE = 4;                    // pitch rows per CTA
constexpr int N_PITCH_TILES = 128 / PITCH_TILE;  // 32
constexpr int ROW_BITS = 2;                      // a queued event: chunk offset << 2 | row
static_assert(PITCH_TILE <= 1 << ROW_BITS, "a queued event keeps its row in ROW_BITS");
constexpr int COL_TILE = 512;                    // roll columns per CTA
constexpr int CELLS = 2 * PITCH_TILE * COL_TILE;  // [channel][row][column - t0]
constexpr int WARPS = THREADS / 32;
constexpr int QUEUE = CHUNK / WARPS;  // a warp's events of one chunk, at most
constexpr int QUEUE_UNROLL = 4;       // queued events a lane loads together
constexpr unsigned FULL = 0xffffffffu;

// Fold one event (index + 1 = e1) into the tile's rows from p0 and columns
// [t0, t0 + tc): its velocity cell and its duration span.
__device__ __forceinline__ void fold(int* win, int e1, int r, long long on, long long off,
                                     int vel, int t0, int tc) {
  if (vel >= 0 && on >= t0 && on < t0 + tc)
    atomicMax(&win[r * COL_TILE + static_cast<int>(on - t0)], e1);
  const long long lo = on > t0 ? on : t0;
  const long long hi = off < t0 + tc ? off : t0 + tc;
  if (lo >= hi) return;  // now t0 <= lo < hi <= t0 + tc
  int* row = win + (PITCH_TILE + r) * COL_TILE - t0;
  for (int t = static_cast<int>(lo); t < static_cast<int>(hi); ++t) atomicMax(&row[t], e1);
}

__global__ void __launch_bounds__(THREADS)
roll_rasterize_kernel(const int* __restrict__ notes, const int* __restrict__ ons,
                      const int* __restrict__ offs, const int* __restrict__ vels, int E,
                      int T, int start, int n_col_tiles, float* __restrict__ out) {
  __shared__ __align__(16) int win[CELLS];  // highest covering event index + 1; 0: none
  __shared__ int queue[WARPS][QUEUE];         // each warp's queued events of one chunk

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ct = blockIdx.x % n_col_tiles;
  const int pt = (blockIdx.x / n_col_tiles) % N_PITCH_TILES;
  const int b = blockIdx.x / (n_col_tiles * N_PITCH_TILES);
  const int p0 = pt * PITCH_TILE;
  const int t0 = ct * COL_TILE;
  const int tc = min(COL_TILE, T - t0);
  const size_t row = static_cast<size_t>(b) * E;
  notes += row;
  ons += row;
  offs += row;
  vels += row;

  for (int i = tid; i < CELLS / 4; i += THREADS)
    reinterpret_cast<int4*>(win)[i] = make_int4(0, 0, 0, 0);

  // fold: chunks from the last down; the pad tail's chunks are skipped
  const int n_chunks = E / CHUNK + (E % CHUNK != 0);
  bool started = false;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const long long c0 = static_cast<long long>(k) * CHUNK;
    int note[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = c0 + u * THREADS + tid;
      note[u] = i < E ? notes[i] : -1;
    }
    if (!started) {  // uniform: every thread sees the same vote
      bool valid = false;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) valid |= note[u] >= 0;
      if (!__syncthreads_or(valid)) continue;  // also orders the zero-fill first
      started = true;
    }
    // queue this warp's events of the tile, in order, then fold them
    int* q = queue[tid / 32];
    int n = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = note[u] - p0;
      const bool keep = static_cast<unsigned>(r) < static_cast<unsigned>(PITCH_TILE);
      const unsigned m = __ballot_sync(FULL, keep);
      if (keep) q[n + __popc(m & ((1u << lane) - 1u))] = (u * THREADS + tid) << ROW_BITS | r;
      n += __popc(m);
    }
    __syncwarp();
    for (int j0 = 0; j0 < n; j0 += 32 * QUEUE_UNROLL) {
      int x[QUEUE_UNROLL], on[QUEUE_UNROLL], off[QUEUE_UNROLL], vel[QUEUE_UNROLL];
#pragma unroll
      for (int a = 0; a < QUEUE_UNROLL; ++a) {
        const int j = j0 + 32 * a + lane;
        x[a] = j < n ? q[j] : -1;
      }
#pragma unroll
      for (int a = 0; a < QUEUE_UNROLL; ++a) {
        if (x[a] >= 0) {
          const long long i = c0 + (x[a] >> ROW_BITS);
          on[a] = ons[i];
          off[a] = offs[i];
          vel[a] = vels[i];
        }
      }
#pragma unroll
      for (int a = 0; a < QUEUE_UNROLL; ++a) {
        if (x[a] >= 0)
          fold(win, static_cast<int>(c0 + (x[a] >> ROW_BITS)) + 1,
               x[a] & ((1 << ROW_BITS) - 1), static_cast<long long>(on[a]) - start,
               static_cast<long long>(off[a]) - start, vel[a], t0, tc);
      }
    }
    __syncwarp();  // the queue is read before the next chunk refills it
  }
  __syncthreads();

  // the tile out, zeros included: warp w writes rows w, w + 8, ...
  // ([channel][row]), lanes on neighbouring columns; each cell takes its
  // winner's value, the row's loads in flight together
  float* dst = out + static_cast<size_t>(b) * 2 * 128 * T + t0;
  for (int cr = tid / 32; cr < 2 * PITCH_TILE; cr += THREADS / 32) {
    const int* w = win + cr * COL_TILE;
    int e1[COL_TILE / 32];
#pragma unroll
    for (int j = 0; j < COL_TILE / 32; ++j) {
      const int t = lane + 32 * j;
      e1[j] = t < tc ? w[t] : 0;
    }
    float v[COL_TILE / 32];
#pragma unroll
    for (int j = 0; j < COL_TILE / 32; ++j) {
      const int e = e1[j] - 1;
      v[j] = e1[j] == 0 ? 0.f
             : cr < PITCH_TILE ? static_cast<float>(vels[e])
                               : static_cast<float>(static_cast<long long>(offs[e]) - ons[e]);
    }
    float* d = dst + (static_cast<size_t>(cr / PITCH_TILE) * 128 + p0 + cr % PITCH_TILE) * T;
#pragma unroll
    for (int j = 0; j < COL_TILE / 32; ++j) {
      const int t = lane + 32 * j;
      if (t < tc) d[t] = v[j];
    }
  }
}

}  // namespace

extern "C" {

// notes/ons/offs/vels: contiguous int32 (B, E); out: float32 (B, 2, 128, T),
// fully written. Any T >= 1 and E >= 0 (E < 2^31). Returns a cudaError_t.
int roll_rasterize_launch(const int* notes, const int* ons, const int* offs, const int* vels,
                          int B, int E, int T, int start, float* out, void* stream) {
  if (B < 0 || E < 0 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int n_col_tiles = (T + COL_TILE - 1) / COL_TILE;
  const long long blocks = static_cast<long long>(B) * N_PITCH_TILES * n_col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  roll_rasterize_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(notes, ons, offs, vels, E, T,
                                                               start, n_col_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

const char* roll_rasterize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
