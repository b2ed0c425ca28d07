// compact_runs: lane-segmented decode store -> flat CSR successor array.
//
// Replaces: the Pallas ragged-compaction kernel of the JAX package
// (webgraph_tpu/ops/kcompact.py, _make_kernel, launched by _run_compact).
//
// csr[p] = store[src0[r] + p - arc_start[r]] for every position p of a valid
// run r; positions of invalid runs are not written (the caller splices them).
//
// What bounds it on this card: memory bandwidth.  Each arc is one 4-byte
// read and one 4-byte write, 8 bytes per arc, and nothing is computed.  To
// run at the copy rate an SM needs tens of KB of reads in flight (Little's
// law: ~3.35 TB/s times ~700 ns over 132 SMs is ~18 KB); one 4-byte read
// at a time per thread, behind a binary search in device memory per
// element, reaches about half of that.
//
// What the design does about it:
//  - one block per output tile of TILE positions (a persistent grid of
//    PERSIST blocks per SM walks the tiles where PERSIST > 0).  The block
//    loads the tile's slice of the run table (the planner's bracket
//    tile_run0[b] .. tile_run0[b + 1]) into shared memory in one coalesced
//    pass, as relative starts and source shifts, at most CAP runs at a
//    time: a tile with more runs walks them in chunks of CAP;
//  - every thread writes whole 16-byte vectors (tiles start at multiples
//    of TILE, so output vectors are aligned), neighbouring threads taking
//    neighbouring vectors, and issues the reads of K vectors before it
//    stores any.  A vector's run comes from a search in shared memory, K
//    searches advancing level by level side by side;
//  - the source of a vector inside one run starts at any 4-byte alignment.
//    LOAD 0 reads its four words one by one (neighbouring threads read
//    neighbouring words, so each read is coalesced); LOAD 1 reads the two
//    aligned 16-byte words that cover it and selects four.  A vector that
//    crosses a run boundary or touches an invalid run reads word by word
//    and writes only its valid positions;
//  - TMA 1 (a variant): warp 0 stages each run's aligned source window
//    into shared memory with one bulk copy (cp.async.bulk, completing on
//    an mbarrier) per run, one tile ahead in a ring of two stages, and all
//    warps write the tile's vectors out of shared memory.  A tile with more
//    than CAP runs, or whose last window would read past the store, is
//    copied from device memory position by position instead.
//
// The shipped macros (LOAD 0, TILE 8192, K 4, 256 threads) were the
// fastest of tools/b2_sweep.py's variants on an H100 (~86% of the byte
// bound, ~5% above a device-to-device copy of the same bytes).  What a
// block cannot hide itself is its prologue (the bracket, then the runs,
// then a barrier), so resident blocks count more than bytes per thread:
// LOAD 1, larger K and persistent grids cost registers or blocks and lost.
//
// The per-tile arithmetic (tile span, run slice, each vector's run and
// source, the aligned windows and shifts, the staging layout) is in
// WG_HD functions.  Under WG_HOST_BUILD the file compiles with a host C++
// compiler alone, without the kernels, and wg_compact_runs_host drives the
// same functions tile by tile and thread by thread on the CPU (the tests
// build it that way).

#include <stdint.h>

#ifdef WG_HOST_BUILD
#include <string.h>
#define WG_HD inline
struct int4 {
  int x, y, z, w;
};
static inline int4 make_int4(int x, int y, int z, int w) {
  return int4{x, y, z, w};
}
#else
#include <cuda_runtime.h>
#define WG_HD __host__ __device__ __forceinline__
#endif

#ifndef WG_B2_TILE
#define WG_B2_TILE 8192   // output positions per tile; ops/kcompact.py TILE
#endif
#ifndef WG_B2_THREADS
#define WG_B2_THREADS 256
#endif
#ifndef WG_B2_K
#define WG_B2_K 4         // vectors a thread reads before it stores
#endif
#ifndef WG_B2_CAP
#define WG_B2_CAP 256     // runs of a tile in shared memory at a time
#endif
#ifndef WG_B2_LOAD
#define WG_B2_LOAD 0      // 1: aligned 16-byte reads and a shift; 0: 4-byte
#endif
#ifndef WG_B2_TMA
#define WG_B2_TMA 0       // 1: bulk copies into a two-stage ring
#endif
#ifndef WG_B2_PERSIST
#define WG_B2_PERSIST 0   // > 0: a grid of that many blocks per SM
#endif
#ifndef WG_B2_MINB
#define WG_B2_MINB 0      // > 0: blocks per SM that ptxas must fit
#endif
#if WG_B2_MINB > 0
#define WG_B2_BOUNDS __launch_bounds__(WG_B2_THREADS, WG_B2_MINB)
#else
#define WG_B2_BOUNDS __launch_bounds__(WG_B2_THREADS)
#endif

namespace {

constexpr int TILE = WG_B2_TILE;
constexpr int THREADS = WG_B2_THREADS;
constexpr int K = WG_B2_K;
constexpr int CAP = WG_B2_CAP;
constexpr int64_t INVALID = INT64_MIN;      // Runs::delta of an invalid run
constexpr int32_t INVALID_BASE = INT32_MIN; // Stage::base of an invalid run
// a stage's staging words: run i's window starts at (start & ~3) + 8 i,
// which keeps windows apart (each is at most its length + 6 words); 8 more
// for the second aligned word read past a window's end
constexpr int STAGE_WORDS = TILE + 8 * CAP + 16;

static_assert(TILE % 4 == 0 && TILE <= (1 << 24), "TILE: a multiple of 4");
static_assert(THREADS >= 32 && THREADS % 32 == 0, "THREADS: whole warps");
static_assert(CAP >= 1 && K >= 1, "CAP, K >= 1");

struct Tables {   // what the wrapper passes: the plan's run table
  const int32_t* store;
  int64_t store_n;
  int32_t* csr;
  int64_t m;
  const int64_t* arc_start;   // [R + 1]
  const int64_t* src0;        // [R]
  const uint8_t* valid;       // [R]
  const int64_t* tile_run0;   // [n_tiles + 1]
  int64_t n_tiles;
};

struct Runs {     // one chunk of a tile's runs (shared memory)
  int32_t start[CAP + 1];   // first position, relative to the tile, in [0, L]
  int64_t delta[CAP];       // src0 - arc_start, or INVALID
};

// ---- loads and stores: __ldg and 16-byte accesses on the card ----

#ifdef WG_HOST_BUILD
// The host build counts the store reads that fall outside the store (the
// kernel must make none).
static const int32_t* g_store_lo;
static const int32_t* g_store_hi;
static int64_t g_stray_reads;
inline void note_read(const int32_t* p, int n) {
  if (p < g_store_lo || p + n > g_store_hi) ++g_stray_reads;
}
#endif

WG_HD int32_t ld1(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
#ifdef WG_HOST_BUILD
  note_read(p, 1);
#endif
  return *p;
#endif
}

WG_HD int4 ld4(const int32_t* p) {   // p 16-byte aligned
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const int4*>(p));
#else
#ifdef WG_HOST_BUILD
  note_read(p, 4);
#endif
  int4 v;
  memcpy(&v, p, sizeof v);
  return v;
#endif
}

WG_HD int4 lds4(const int32_t* p) {  // shared memory, p 16-byte aligned
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const int4*>(p);
#else
  int4 v;
  memcpy(&v, p, sizeof v);
  return v;
#endif
}

WG_HD void st4(int32_t* p, int4 v) {  // p 16-byte aligned
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = v;
#else
  memcpy(p, &v, sizeof v);
#endif
}

// ---- the per-tile arithmetic ----

// The output positions [t0, t0 + L) of tile b.
WG_HD void tile_span(int64_t b, int64_t m, int64_t* t0, int32_t* L) {
  *t0 = b * TILE;
  const int64_t left = m - *t0;
  *L = int32_t(left < TILE ? left : TILE);
}

// Runs in the chunk that starts at run c0 of a tile whose last run is r1.
WG_HD int chunk_runs(int64_t c0, int64_t r1) {
  const int64_t n = r1 - c0 + 1;
  return int(n < CAP ? n : CAP);
}

// A run table position relative to the tile, clamped to [0, L].
WG_HD int32_t rel_pos(int64_t p, int64_t t0, int32_t L) {
  const int64_t a = p - t0;
  return int32_t(a < 0 ? 0 : a > L ? L : a);
}

// Entry i (0 <= i <= n) of a chunk's run slice.  Entry n holds only the
// start of the run after the chunk: the chunk covers [start[0], start[n]).
WG_HD void load_run(const Tables& T, int64_t t0, int32_t L, int64_t c0, int n,
                    int i, Runs& s) {
  const int64_t a = T.arc_start[c0 + i];
  s.start[i] = rel_pos(a, t0, L);
  if (i < n) s.delta[i] = T.valid[c0 + i] ? T.src0[c0 + i] - a : INVALID;
}

// The largest power of two <= x (x >= 1), else 0.
WG_HD int floor_pow2(int x) {
  int p = x >= 1 ? 1 : 0;
  while (p > 0 && 2 * p <= x) p *= 2;
  return p;
}

// For each of NK positions q[k], the largest i < n with start[i] <= q[k]
// (start ascending, start[0] <= q[k]): that is the run holding q[k], as
// empty runs share their start with the next.  The NK searches advance
// one level at a time side by side, so their shared-memory reads overlap.
template <int NK>
WG_HD void find_runs(const int32_t* start, int n, const int32_t* q, int* r) {
#pragma unroll
  for (int k = 0; k < NK; ++k) r[k] = 0;
  for (int step = floor_pow2(n - 1); step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = r[k] + step;
      if (c < n && start[c] <= q[k]) r[k] = c;
    }
  }
}

// The four words from place sh (0..3) of the eight words a, b.
WG_HD int4 shift_words(int4 a, int4 b, int sh) {
  int4 o;
  o.x = sh == 0 ? a.x : sh == 1 ? a.y : sh == 2 ? a.z : a.w;
  o.y = sh == 0 ? a.y : sh == 1 ? a.z : sh == 2 ? a.w : b.x;
  o.z = sh == 0 ? a.z : sh == 1 ? a.w : sh == 2 ? b.x : b.y;
  o.w = sh == 0 ? a.w : sh == 1 ? b.x : sh == 2 ? b.y : b.z;
  return o;
}

// Write a vector's valid positions: the four words from place sh of
// (w0, w1); mask bit j set where position j is valid.
WG_HD void put_vector(int32_t* dst, int4 w0, int4 w1, int sh, int mask) {
  const int4 v = shift_words(w0, w1, sh);
  if (mask == 15) {
    st4(dst, v);
    return;
  }
  if (mask & 1) dst[0] = v.x;
  if (mask & 2) dst[1] = v.y;
  if (mask & 4) dst[2] = v.z;
  if (mask & 8) dst[3] = v.w;
}

// Read the vector of positions q .. q + 3 of the tile at t0 (all inside
// the chunk s, run r holding q) from device memory.  Out: the words to
// shift (w0, w1, sh) and the mask of valid positions.
WG_HD void gather_vector(const Tables& T, const Runs& s, int64_t t0,
                         int32_t q, int r, int4& w0, int4& w1, int& sh,
                         int& mask) {
  const int64_t d = s.delta[r];
  sh = 0;
  mask = 15;
  if (s.start[r + 1] >= q + 4 && d != INVALID) {   // one valid run
    const int64_t src = t0 + q + d;
#if WG_B2_LOAD == 1
    const int64_t a = src & ~int64_t(3);
    if (a + 8 <= T.store_n) {
      w0 = ld4(T.store + a);
      w1 = ld4(T.store + a + 4);
      sh = int(src - a);
      return;
    }
#endif
    w0 = make_int4(ld1(T.store + src), ld1(T.store + src + 1),
                   ld1(T.store + src + 2), ld1(T.store + src + 3));
    w1 = w0;
    return;
  }
  // across a run boundary, or touching an invalid run: word by word
  int v[4];
  mask = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    while (s.start[r + 1] <= q + j) ++r;
    v[j] = 0;
    if (s.delta[r] != INVALID) {
      v[j] = ld1(T.store + (t0 + q + j + s.delta[r]));
      mask |= 1 << j;
    }
  }
  w0 = make_int4(v[0], v[1], v[2], v[3]);
  w1 = w0;
}

// Copy position q of the tile (inside the chunk s), if its run is valid.
WG_HD void copy_one(const Tables& T, const Runs& s, int n, int64_t t0,
                    int32_t q) {
  int r;
  find_runs<1>(s.start, n, &q, &r);
  if (s.delta[r] != INVALID)
    T.csr[t0 + q] = ld1(T.store + (t0 + q + s.delta[r]));
}

// Whole vectors [v_lo, v_hi) of a chunk covering [P0, P1), and the first
// position of its tail: the positions outside whole vectors are
// [P0, 4 v_lo) and [tail, P1), at most three each.
WG_HD void chunk_vectors(int32_t P0, int32_t P1, int32_t* v_lo, int32_t* v_hi,
                         int32_t* head_end, int32_t* tail) {
  *v_lo = (P0 + 3) >> 2;
  *v_hi = P1 >> 2;
  if (*v_hi < *v_lo) *v_hi = *v_lo;
  *head_end = 4 * *v_lo < P1 ? 4 * *v_lo : P1;
  *tail = 4 * *v_hi > *head_end ? 4 * *v_hi : *head_end;
}

// The position outside whole vectors that thread tid copies, or -1.
WG_HD int32_t edge_position(int32_t P0, int32_t P1, int32_t head_end,
                            int32_t tail, int tid) {
  const int32_t nh = head_end - P0;
  const int32_t e = tid < nh ? P0 + tid : tail + (tid - nh);
  return e < (tid < nh ? head_end : P1) ? e : -1;
}

// Thread tid's share of a chunk: whole vectors, K read before any store,
// then at most one position at the chunk's ends.
WG_HD void copy_chunk(const Tables& T, const Runs& s, int n, int64_t t0,
                      int tid) {
  const int32_t P0 = s.start[0], P1 = s.start[n];
  int32_t v_lo, v_hi, head_end, tail;
  chunk_vectors(P0, P1, &v_lo, &v_hi, &head_end, &tail);
  int32_t* out = T.csr + t0;
  for (int32_t v = v_lo + tid; v < v_hi; v += THREADS * K) {
    int32_t q[K];
    int r[K], sh[K], mask[K];
    int4 w0[K], w1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t vk = v + k * THREADS;
      q[k] = 4 * (vk < v_hi ? vk : v_hi - 1);
    }
    find_runs<K>(s.start, n, q, r);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mask[k] = 0;
      if (v + k * THREADS < v_hi)
        gather_vector(T, s, t0, q[k], r[k], w0[k], w1[k], sh[k], mask[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (mask[k]) put_vector(out + q[k], w0[k], w1[k], sh[k], mask[k]);
  }
  const int32_t e = edge_position(P0, P1, head_end, tail, tid);
  if (e >= 0) copy_one(T, s, n, t0, e);
}

// Position q of the tile at t0 whose runs are [r0, r1], by a binary search
// over the run table in device memory (the staged variant's path for a
// tile it cannot stage).
WG_HD void copy_one_global(const Tables& T, int64_t t0, int64_t r0,
                           int64_t r1, int32_t q) {
  const int64_t p = t0 + q;
  int64_t lo = r0, hi = r1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (T.arc_start[mid] <= p)
      lo = mid;
    else
      hi = mid - 1;
  }
  if (T.valid[lo])
    T.csr[p] = ld1(T.store + (T.src0[lo] + (p - T.arc_start[lo])));
}

// ---- the staged variant's layout ----

struct alignas(16) Stage {   // one tile staged in shared memory
  int32_t words[STAGE_WORDS];   // first: 16-byte aligned for the bulk copies
  int32_t start[CAP + 1];       // as Runs::start
  int32_t base[CAP];            // position q of run i is words[q + base[i]]
  int32_t n;                    // runs of the tile
  int32_t direct;               // 1: copied from device memory instead
  uint64_t full;                // mbarrier: the stage's bulk copies landed
};

struct Window {   // one run's staged source window
  int64_t src;    // first store index copied (16-byte aligned)
  int32_t off;    // its staging index (a multiple of 4)
  int32_t words;  // words copied (a multiple of 4; 0: nothing)
  int32_t base;   // position q of the run is staging index q + base
};

// The window of run i (< n) of tile t0/L whose runs start at r0.  The
// run's positions [st, en) read the store at [lo, lo + en - st), lo =
// src0 + st + t0 - arc_start; the aligned cover of that range goes to
// staging index (st & ~3) + 8 i.
WG_HD Window run_window(const Tables& T, int64_t t0, int32_t L, int64_t r0,
                        int i) {
  Window w{0, 0, 0, INVALID_BASE};
  if (!T.valid[r0 + i]) return w;
  const int64_t a = T.arc_start[r0 + i];
  const int32_t st = rel_pos(a, t0, L);
  const int32_t en = rel_pos(T.arc_start[r0 + i + 1], t0, L);
  const int64_t lo = T.src0[r0 + i] - a + t0 + st;
  w.src = lo & ~int64_t(3);
  w.off = (st & ~3) + 8 * i;
  w.base = w.off + int32_t(lo - w.src) - st;
  if (en > st) w.words = int32_t(((lo + (en - st) + 3) & ~int64_t(3)) - w.src);
  return w;
}

// Stage entry i (0 <= i <= n): the run's start and staging base; returns
// its window (nothing for entry n, which holds only the end of the tile's
// last run).
WG_HD Window stage_run(const Tables& T, int64_t t0, int32_t L, int64_t r0,
                       int n, int i, Stage& S) {
  S.start[i] = rel_pos(T.arc_start[r0 + i], t0, L);
  if (i >= n) return Window{0, 0, 0, INVALID_BASE};
  const Window w = run_window(T, t0, L, r0, i);
  S.base[i] = w.base;
  return w;
}

// Whether a window reads past the end of the store (the tile then goes
// the direct way).
WG_HD bool past_store(const Tables& T, const Window& w) {
  return w.words > 0 && w.src + w.words > T.store_n;
}

// Thread tid's share of a staged tile: whole vectors out of shared memory.
WG_HD void copy_staged(const Tables& T, const Stage& S, int64_t t0, int32_t L,
                       int tid) {
  const int n = S.n;
  int32_t v_lo, v_hi, head_end, tail;
  chunk_vectors(0, L, &v_lo, &v_hi, &head_end, &tail);
  int32_t* out = T.csr + t0;
  for (int32_t v = tid; v < v_hi; v += THREADS * K) {
    int32_t q[K];
    int r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t vk = v + k * THREADS;
      q[k] = 4 * (vk < v_hi ? vk : v_hi - 1);
    }
    find_runs<K>(S.start, n, q, r);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (v + k * THREADS >= v_hi) continue;
      int rr = r[k];
      const int32_t b = S.base[rr];
      if (S.start[rr + 1] >= q[k] + 4 && b != INVALID_BASE) {
        const int32_t x = q[k] + b;
        const int32_t ax = x & ~3;
        put_vector(out + q[k], lds4(S.words + ax), lds4(S.words + ax + 4),
                   x - ax, 15);
        continue;
      }
      int vals[4], mask = 0;
      for (int j = 0; j < 4; ++j) {
        while (S.start[rr + 1] <= q[k] + j) ++rr;
        vals[j] = 0;
        if (S.base[rr] != INVALID_BASE) {
          vals[j] = S.words[q[k] + j + S.base[rr]];
          mask |= 1 << j;
        }
      }
      const int4 w = make_int4(vals[0], vals[1], vals[2], vals[3]);
      put_vector(out + q[k], w, w, 0, mask);
    }
  }
  const int32_t e = edge_position(0, L, head_end, tail, tid);
  if (e >= 0) {
    int rr;
    find_runs<1>(S.start, n, &e, &rr);
    if (S.base[rr] != INVALID_BASE) out[e] = S.words[e + S.base[rr]];
  }
}

#ifndef WG_HOST_BUILD

// ---- the kernels ----

__global__ void WG_B2_BOUNDS compact_runs_kernel(Tables T) {
  __shared__ Runs s;
  for (int64_t b = blockIdx.x; b < T.n_tiles; b += gridDim.x) {
    int64_t t0;
    int32_t L;
    tile_span(b, T.m, &t0, &L);
    const int64_t r1 = T.tile_run0[b + 1];
    for (int64_t c0 = T.tile_run0[b]; c0 <= r1; c0 += CAP) {
      const int n = chunk_runs(c0, r1);
      __syncthreads();   // the last chunk's readers are done with s
      for (int i = threadIdx.x; i <= n; i += THREADS)
        load_run(T, t0, L, c0, n, i, s);
      __syncthreads();
      copy_chunk(T, s, n, t0, threadIdx.x);
    }
  }
}

#if WG_B2_TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Warp 0 stages tile b into S: the run slice, then one bulk copy per run's
// window, all completing on S.full.
__device__ void produce(const Tables& T, int64_t b, Stage& S, int lane) {
  int64_t t0;
  int32_t L;
  tile_span(b, T.m, &t0, &L);
  const int64_t r0 = T.tile_run0[b];
  const int64_t nr = T.tile_run0[b + 1] - r0 + 1;
  const uint32_t bar = smem_addr(&S.full);
  const int n = int(nr < CAP ? nr : CAP);
  bool past = nr > CAP;
  uint32_t bytes = 0;
  if (!past) {
    for (int i = lane; i <= n; i += 32) {
      const Window w = stage_run(T, t0, L, r0, n, i, S);
      past |= past_store(T, w);
      bytes += uint32_t(w.words) * 4u;
    }
  }
  past = __any_sync(0xffffffffu, past);
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  __syncwarp();   // every lane's table entries before the arrive
  if (lane == 0) {
    S.n = n;
    S.direct = past;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(past ? 0u : bytes)
        : "memory");
  }
  __syncwarp();
  if (past) return;
  // the last reads of these words (generic proxy) come before this tile's
  // bulk writes into them (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int i = lane; i < n; i += 32) {
    const Window w = run_window(T, t0, L, r0, i);
    if (w.words > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(S.words + w.off)),
          "l"(T.store + w.src), "r"(uint32_t(w.words) * 4u), "r"(bar)
          : "memory");
  }
}

__global__ void WG_B2_BOUNDS compact_runs_tma_kernel(Tables T) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Stage* S = reinterpret_cast<Stage*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&S[s].full))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int64_t b = blockIdx.x;
  if (b < T.n_tiles && warp == 0) produce(T, b, S[0], lane);
  for (int i = 0; b < T.n_tiles; b += gridDim.x, ++i) {
    const int64_t nb = b + gridDim.x;
    // stage i + 1 was read in step i - 1, and the barrier closing that
    // step is behind us
    if (nb < T.n_tiles && warp == 0) produce(T, nb, S[(i + 1) & 1], lane);
    Stage& cur = S[i & 1];
    mbar_wait(smem_addr(&cur.full), uint32_t((i >> 1) & 1));
    int64_t t0;
    int32_t L;
    tile_span(b, T.m, &t0, &L);
    if (cur.direct) {
      const int64_t r0 = T.tile_run0[b], r1 = T.tile_run0[b + 1];
      for (int32_t q = tid; q < L; q += THREADS)
        copy_one_global(T, t0, r0, r1, q);
    } else {
      copy_staged(T, cur, t0, L, tid);
    }
    __syncthreads();
  }
}

#endif  // WG_B2_TMA
#endif  // WG_HOST_BUILD

}  // namespace

#ifndef WG_HOST_BUILD

extern "C" int wg_compact_runs(const void* store, int64_t store_n, void* csr,
                               int64_t m, const void* arc_start,
                               const void* src0, const void* valid,
                               const void* tile_run0, int64_t n_tiles,
                               int64_t tile, void* stream) {
  if (tile != TILE) return int(cudaErrorInvalidValue);
  // csr is 16-byte aligned (a fresh tensor); 16-byte reads of the store
  // (LOAD 1) and bulk copies from it (TMA 1) need the store so too
  if ((WG_B2_LOAD == 1 || WG_B2_TMA) && (uintptr_t(store) & 15))
    return int(cudaErrorMisalignedAddress);
  if (m <= 0 || n_tiles <= 0) return int(cudaGetLastError());
  const Tables T{(const int32_t*)store, store_n,     (int32_t*)csr, m,
                 (const int64_t*)arc_start, (const int64_t*)src0,
                 (const uint8_t*)valid,     (const int64_t*)tile_run0,
                 n_tiles};
  int64_t grid = n_tiles;
  if (WG_B2_PERSIST > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t g = int64_t(WG_B2_PERSIST) * sms;
    if (g > 0 && g < grid) grid = g;
  }
  cudaStream_t st = (cudaStream_t)stream;
#if WG_B2_TMA
  const size_t bytes = 2 * sizeof(Stage);
  cudaFuncSetAttribute(compact_runs_tma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(bytes));
  compact_runs_tma_kernel<<<dim3(unsigned(grid)), THREADS, bytes, st>>>(T);
#else
  compact_runs_kernel<<<dim3(unsigned(grid)), THREADS, 0, st>>>(T);
#endif
  return int(cudaGetLastError());
}

#else  // WG_HOST_BUILD

// The kernel's steps on the CPU, tile after tile and, between the block's
// barriers, thread after thread.  Returns the number of store reads that
// fell outside the store.
extern "C" int64_t wg_compact_runs_host(const void* store, int64_t store_n,
                                     void* csr, int64_t m,
                                     const void* arc_start, const void* src0,
                                     const void* valid, const void* tile_run0,
                                     int64_t n_tiles) {
  const Tables T{(const int32_t*)store, store_n,     (int32_t*)csr, m,
                 (const int64_t*)arc_start, (const int64_t*)src0,
                 (const uint8_t*)valid,     (const int64_t*)tile_run0,
                 n_tiles};
  g_store_lo = T.store;
  g_store_hi = T.store + store_n;
  g_stray_reads = 0;
  for (int64_t b = 0; b < n_tiles; ++b) {
    int64_t t0;
    int32_t L;
    tile_span(b, m, &t0, &L);
    const int64_t r0 = T.tile_run0[b], r1 = T.tile_run0[b + 1];
#if WG_B2_TMA
    static Stage S;
    const int64_t nr = r1 - r0 + 1;
    const int n = int(nr < CAP ? nr : CAP);
    bool past = nr > CAP;
    Window w[CAP + 1];
    for (int i = 0; !past && i <= n; ++i) {
      w[i] = stage_run(T, t0, L, r0, n, i, S);
      past = past_store(T, w[i]);
    }
    S.n = n;
    S.direct = past;
    if (past) {
      for (int32_t q = 0; q < L; ++q) copy_one_global(T, t0, r0, r1, q);
      continue;
    }
    memset(S.words, 0xA5, sizeof S.words);   // staging holds old tiles
    for (int i = 0; i < n; ++i)
      if (w[i].words > 0) {
        note_read(T.store + w[i].src, w[i].words);
        memcpy(S.words + w[i].off, T.store + w[i].src, 4 * size_t(w[i].words));
      }
    for (int tid = 0; tid < THREADS; ++tid) copy_staged(T, S, t0, L, tid);
#else
    static Runs s;
    for (int64_t c0 = r0; c0 <= r1; c0 += CAP) {
      const int n = chunk_runs(c0, r1);
      for (int i = 0; i <= n; ++i) load_run(T, t0, L, c0, n, i, s);
      for (int tid = 0; tid < THREADS; ++tid) copy_chunk(T, s, n, t0, tid);
    }
#endif
  }
  return g_stray_reads;
}

#endif  // WG_HOST_BUILD
