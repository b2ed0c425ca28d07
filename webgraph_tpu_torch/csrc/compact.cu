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
//  - one block per output tile of TILE positions.  The block loads the
//    tile's slice of the run table (the planner's bracket tile_run0[b] ..
//    tile_run0[b + 1]) into shared memory in one coalesced pass, as
//    relative starts and source shifts, at most CAP runs at a time: a tile
//    with more runs walks them in chunks of CAP;
//  - every thread writes whole 16-byte vectors (tiles start at multiples
//    of TILE, so output vectors are aligned), neighbouring threads taking
//    neighbouring vectors, and issues the reads of K vectors before it
//    stores any.  A vector's run comes from a search in shared memory, K
//    searches advancing level by level side by side;
//  - the source of a vector inside one run starts at any 4-byte alignment,
//    so its four words are read one by one (neighbouring threads read
//    neighbouring words, so each read is coalesced).  A vector that
//    crosses a run boundary or touches an invalid run reads word by word
//    and writes only its valid positions.
//
// The shipped macros (TILE 8192, K 4, 256 threads) were timed on an H100
// against aligned 16-byte reads with a shift, bulk copies (TMA) staged in a
// shared-memory ring, a persistent grid, larger K and a binary search over
// the run table in device memory, and were the fastest (~86% of the byte
// bound, ~5% above a device-to-device copy of the same bytes).  What a
// block cannot hide itself is its prologue (the bracket, then the runs,
// then a barrier), so resident blocks count more than bytes per thread:
// the others cost registers or blocks and lost.
//
// The per-tile arithmetic (tile span, run slice, each vector's run and
// source, the head and tail splits) is in WG_HD functions.  Under
// WG_HOST_BUILD the file compiles with a host C++ compiler alone, without
// the kernel, and wg_compact_runs_host drives the same functions tile by
// tile and thread by thread on the CPU (the tests build it that way).

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

namespace {

constexpr int TILE = WG_B2_TILE;
constexpr int THREADS = WG_B2_THREADS;
constexpr int K = WG_B2_K;
constexpr int CAP = WG_B2_CAP;
constexpr int64_t INVALID = INT64_MIN;      // Runs::delta of an invalid run

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

// ---- loads and stores: __ldg and 16-byte stores on the card ----

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

// Write a vector's valid positions; mask bit j set where position j is valid.
WG_HD void put_vector(int32_t* dst, int4 v, int mask) {
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
// the chunk s, run r holding q) from device memory.  Out: its words and
// the mask of valid positions.
WG_HD void gather_vector(const Tables& T, const Runs& s, int64_t t0,
                         int32_t q, int r, int4& w, int& mask) {
  const int64_t d = s.delta[r];
  mask = 15;
  if (s.start[r + 1] >= q + 4 && d != INVALID) {   // one valid run
    const int64_t src = t0 + q + d;
    w = make_int4(ld1(T.store + src), ld1(T.store + src + 1),
                  ld1(T.store + src + 2), ld1(T.store + src + 3));
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
  w = make_int4(v[0], v[1], v[2], v[3]);
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
    int r[K], mask[K];
    int4 w[K];
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
        gather_vector(T, s, t0, q[k], r[k], w[k], mask[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (mask[k]) put_vector(out + q[k], w[k], mask[k]);
  }
  const int32_t e = edge_position(P0, P1, head_end, tail, tid);
  if (e >= 0) copy_one(T, s, n, t0, e);
}

#ifndef WG_HOST_BUILD

// ---- the kernel ----

// One block a tile (the grid is n_tiles), written as a grid-stride loop all
// the same: this form compiles to the kernel timed on the H100 (48
// registers, 5 blocks an SM).  The straight form takes 40 registers and 6
// blocks an SM and moves B2's time by -7% to +0.4% with the run lengths.
__global__ void __launch_bounds__(WG_B2_THREADS)
    compact_runs_kernel(Tables T) {
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

#endif  // WG_HOST_BUILD

}  // namespace

#ifndef WG_HOST_BUILD

extern "C" int wg_compact_runs(const void* store, int64_t store_n, void* csr,
                               int64_t m, const void* arc_start,
                               const void* src0, const void* valid,
                               const void* tile_run0, int64_t n_tiles,
                               int64_t tile, void* stream) {
  if (tile != TILE) return int(cudaErrorInvalidValue);
  if (m <= 0 || n_tiles <= 0) return int(cudaGetLastError());
  const Tables T{(const int32_t*)store, store_n,     (int32_t*)csr, m,
                 (const int64_t*)arc_start, (const int64_t*)src0,
                 (const uint8_t*)valid,     (const int64_t*)tile_run0,
                 n_tiles};
  compact_runs_kernel<<<dim3(unsigned(n_tiles)), THREADS, 0,
                        (cudaStream_t)stream>>>(T);
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
  static Runs s;
  for (int64_t b = 0; b < n_tiles; ++b) {
    int64_t t0;
    int32_t L;
    tile_span(b, m, &t0, &L);
    const int64_t r1 = T.tile_run0[b + 1];
    for (int64_t c0 = T.tile_run0[b]; c0 <= r1; c0 += CAP) {
      const int n = chunk_runs(c0, r1);
      for (int i = 0; i <= n; ++i) load_run(T, t0, L, c0, n, i, s);
      for (int tid = 0; tid < THREADS; ++tid) copy_chunk(T, s, n, t0, tid);
    }
  }
  return g_stray_reads;
}

#endif  // WG_HOST_BUILD
