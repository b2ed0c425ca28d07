// hyperball_merge: one HyperBall round's merge, a segmented byte-max over
// each listed node's successor rows; hyperball_estimate (at the end of the
// file): the HyperLogLog count of each listed row.
//
// Replaces: no TPU kernel.  The JAX package's round (webgraph_tpu/algo/
// hyperball.py, device_round) is an XLA program of a gather and a
// scatter-max; the port ran the same two PyTorch library kernels, and an
// H100 trace put ~90% of a HyperBall run in them: the gather wrote every
// successor row to device memory (4.3 GB for a 2^26-arc slice) and
// scatter_reduce_ read it back into a per-byte atomic max.
//
//   out[i]     = max(regs[x_i], max over y in succ[off[x_i] .. off[x_i+1]]
//                    of regs[y])                      bytewise, uint8 rows
//   changed[i] = out[i] != regs[x_i]
//
// x_i = nodes[i], or i where nodes is NULL (a dense round).  regs is only
// read and out is another buffer, so every row merges the previous round's
// registers (the Jacobi round of HyperBall.java), whatever order the nodes
// run in.
//
// What bounds it on this card: memory, and latency more than bandwidth.
// Each arc needs its successor id (4 or 8 bytes) and a 2^log2m-byte row at
// a random address: at log2m 6 and uk-2002's ~297M arcs that is ~20 GB of
// gathered rows a dense round (~6 ms at 3.35 TB/s), or ~3.7 GB counting each
// row once (~1.1 ms: rows in, rows out, ids, offsets).  The row loads hang
// off two dependent loads (the offsets, then the ids), so what sets the
// time is how many independent row loads each SM keeps in flight.
//
// What the design does about it:
//  - a group of T threads merges one node; G threads of it (G = row bytes /
//    V, at most 32) read one row as V-byte vectors (V = 16 where the row
//    and the pointers allow, down to 1 for rows under 4 bytes), and the
//    group's S = T / G sub-groups fold different successors side by side.
//    A row wider than 32 vectors is merged in column chunks of 32.  So the
//    grouping follows the row width the wrapper passes; nothing is set by
//    hand;
//  - each thread loads U successor ids, then U rows, before it folds any
//    (__vmaxu4 per 32-bit word), so a warp keeps 32 U row loads in flight;
//    ids and rows come through the read-only path (__ldg);
//  - the sub-groups' maxima meet by xor shuffles inside the group, then the
//    node's own row (loaded first, beside the ids) is folded in and compared.
//    Only out's row and one changed byte per node are written: no atomics,
//    no per-arc array in device memory.
//
// T is max(G, WG_HB_NODE_THREADS), so short lists (a crawl's mean is ~16)
// share a warp.  On an H100 at uk-2002's shape (log2m 6) the shipped macros
// (8 threads a node, U 4, 128 threads a block) were the fastest of
// tools/hb_sweep.py's variants, ~5.8 ms a dense round: below the bound of
// every gathered row from device memory, as the crawl's locality keeps most
// successor rows in L2, and ~19% of the row-once bound; a warp a node took
// ~2x as long.  A group walks its list alone, ~0.7 us a batch of S U = 8
// successors: uk-2002's longest list (4,097 arcs) costs its group ~0.4 ms,
// inside a round; a list of 10^5 arcs would take ~9 ms by itself, longer
// than the rest of the round, and would want a block of its own (a split of
// such lists by the wrapper, as B1's hub lanes want).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WG_HB_THREADS
#define WG_HB_THREADS 128      // threads a block
#endif
#ifndef WG_HB_NODE_THREADS
#define WG_HB_NODE_THREADS 8   // the least threads a node (a power of two)
#endif
#ifndef WG_HB_U
#define WG_HB_U 4              // successors a thread loads before it folds
#endif

namespace {

constexpr int THREADS = WG_HB_THREADS;
constexpr int U = WG_HB_U;

static_assert(THREADS >= 32 && THREADS % 32 == 0, "THREADS: whole warps");
static_assert(WG_HB_NODE_THREADS >= 1 && WG_HB_NODE_THREADS <= 32 &&
                  (WG_HB_NODE_THREADS & (WG_HB_NODE_THREADS - 1)) == 0,
              "NODE_THREADS: a power of two up to 32");
static_assert(U >= 1, "U >= 1");

// A V-byte vector of a row as NW 32-bit words; under 4 bytes, one word whose
// upper bytes stay 0 (and so never win a max).
template <int V>
struct Vec {
  static constexpr int NW = V >= 4 ? V / 4 : 1;
  uint32_t w[NW];

  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (V == 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (V == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x, w[1] = t.y;
    } else if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (V == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ void store(uint8_t* p) const {
    if constexpr (V == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint16_t*>(p) = uint16_t(w[0]);
    } else {
      *p = uint8_t(w[0]);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q] = 0;
  }
  __device__ __forceinline__ void max_with(const Vec& o) {
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q] = __vmaxu4(w[q], o.w[q]);
  }
  __device__ __forceinline__ bool differs(const Vec& o) const {
    bool d = false;
#pragma unroll
    for (int q = 0; q < NW; ++q) d |= w[q] != o.w[q];
    return d;
  }
};

struct Args {
  const int64_t* off;    // [n + 1]
  const void* succ;      // [m], int32 or int64
  const uint8_t* regs;   // (n, R)
  const int64_t* nodes;  // [k], or NULL: node i is i
  int64_t k;
  uint8_t* out;          // (k, R)
  uint8_t* changed;      // [k]
  int64_t R;             // row bytes
  int g_log2;            // G = 1 << g_log2 vectors a row read
  int t_log2;            // T = 1 << t_log2 threads a node
  int chunks;            // column chunks of G vectors a row
};

template <int V, typename Idx>
__global__ void __launch_bounds__(THREADS)
    hyperball_merge_kernel(const Args a) {
  const int64_t tid = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t i = tid >> a.t_log2;
  if (i >= a.k) return;   // whole groups leave: T divides the block
  const int T = 1 << a.t_log2;
  const int lane = threadIdx.x & 31;
  const int in_group = lane & (T - 1);
  const unsigned mask =
      T == 32 ? 0xffffffffu : ((1u << T) - 1) << (lane & ~(T - 1));
  const int g = in_group & ((1 << a.g_log2) - 1);   // vector of the chunk
  const int s = in_group >> a.g_log2;               // sub-group
  const int S = T >> a.g_log2;

  const int64_t x = a.nodes ? __ldg(a.nodes + i) : i;
  const int64_t beg = __ldg(a.off + x), end = __ldg(a.off + x + 1);
  const Idx* succ = static_cast<const Idx*>(a.succ);
  const uint8_t* own_row = a.regs + x * a.R;
  bool diff = false;
  for (int c = 0; c < a.chunks; ++c) {
    const int64_t col = (int64_t(c) << a.g_log2 | g) * V;
    Vec<V> own, acc;
    own.load(own_row + col);
    acc.zero();
    for (int64_t j0 = beg + s; j0 < end; j0 += int64_t(S) * U) {
      int64_t y[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t j = j0 + int64_t(u) * S;
        y[u] = j < end ? int64_t(__ldg(succ + j)) : -1;
      }
      Vec<V> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (y[u] >= 0)
          v[u].load(a.regs + y[u] * a.R + col);
        else
          v[u].zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) acc.max_with(v[u]);
    }
    // the sub-groups' maxima: xor partners s ^ 1, s ^ 2, ... of the same g
    for (int o = 1 << a.g_log2; o < T; o <<= 1) {
#pragma unroll
      for (int q = 0; q < Vec<V>::NW; ++q)
        acc.w[q] = __vmaxu4(acc.w[q], __shfl_xor_sync(mask, acc.w[q], o));
    }
    acc.max_with(own);
    diff |= acc.differs(own);
    if (s == 0) acc.store(a.out + i * a.R + col);
  }
  diff = __any_sync(mask, diff);
  if (in_group == 0) a.changed[i] = diff ? 1 : 0;
}

template <int V>
cudaError_t launch(const Args& a, bool succ64, cudaStream_t st) {
  const int64_t threads = a.k << a.t_log2;
  const dim3 grid(unsigned((threads + THREADS - 1) / THREADS));
  if (succ64)
    hyperball_merge_kernel<V, int64_t><<<grid, THREADS, 0, st>>>(a);
  else
    hyperball_merge_kernel<V, int32_t><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

int log2_of(int64_t v) {
  int l = 0;
  while ((int64_t(1) << l) < v) ++l;
  return l;
}

}  // namespace

// out (k, row_bytes) and changed [k] for the k nodes of ``nodes`` (NULL: the
// first k nodes).  row_bytes is a power of two; succ is int64 where succ_is64
// is nonzero, else int32.  Returns cudaGetLastError after the launch.
extern "C" int wg_hyperball_merge(const void* off, const void* succ,
                                  int succ_is64, const void* regs,
                                  int64_t row_bytes, const void* nodes,
                                  int64_t k, void* out, void* changed,
                                  void* stream) {
  if (row_bytes < 1 || (row_bytes & (row_bytes - 1))) {
    return int(cudaErrorInvalidValue);
  }
  if (k <= 0) return int(cudaGetLastError());
  // the widest vector that the row width and both row pointers allow
  int64_t V = row_bytes < 16 ? row_bytes : 16;
  while ((uintptr_t(regs) | uintptr_t(out)) & uintptr_t(V - 1)) V >>= 1;
  const int64_t vecs = row_bytes / V;
  const int64_t G = vecs < 32 ? vecs : 32;
  const int64_t T = G > WG_HB_NODE_THREADS ? G : WG_HB_NODE_THREADS;
  if (((k << log2_of(T)) + THREADS - 1) / THREADS > 0x7fffffff) {
    return int(cudaErrorInvalidConfiguration);
  }
  const Args a{static_cast<const int64_t*>(off),
               succ,
               static_cast<const uint8_t*>(regs),
               static_cast<const int64_t*>(nodes),
               k,
               static_cast<uint8_t*>(out),
               static_cast<uint8_t*>(changed),
               row_bytes,
               log2_of(G),
               log2_of(T),
               int(vecs / G)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool s64 = succ_is64 != 0;
  switch (V) {
    case 16: return int(launch<16>(a, s64, st));
    case 8: return int(launch<8>(a, s64, st));
    case 4: return int(launch<4>(a, s64, st));
    case 2: return int(launch<2>(a, s64, st));
    default: return int(launch<1>(a, s64, st));
  }
}

// hyperball_estimate: the HyperLogLog count of each listed register row,
// in one pass over the rows where they lie.
//
// Replaces: no TPU kernel.  The JAX package's estimate_counts (webgraph_tpu/
// algo/hyperball.py) is numpy; the port ran its PyTorch twin,
// estimate_counts_device (algo/hyperball.py), over a gathered copy of the
// rows, and an H100 trace of the uk2002.hyperball cell put ~81% of the
// device time in its six library kernels: the gather, the uint8 -> float64
// copy, the negation, exp2 and two row sums, each through a float64
// (rows, 2^log2m) transient.
//
//   s      = sum over the row's m registers r of 2^-r     (float64)
//   z      = the row's registers equal to 0
//   est    = (1 / s) * c,  c = alpha(m) m^2 from the host
//   lin    = m * log((1 / max(z, 1e-300)) * m)
//   out[i] = lin where est <= 2.5 m and z > 0, else est
//
// for the row x_i = nodes[i], or i where nodes is NULL.  The arithmetic is
// PyTorch's: a scalar divided by a tensor is the tensor's reciprocal times
// the scalar.  2^-r is built from its exponent bits, so every term is
// exact.  While every register of a row is at most 53 - log2m (47 at
// log2m 6), every partial sum is a multiple of 2^-r_max no larger than
// m = 2^log2m, which float64 holds exactly: the sum is the same in any
// order, and so the count equals the twin's bit for bit.  Above that the
// order of the sum may move the last bits.
//
// What bounds it on this card: memory.  A row is read once (2^log2m bytes
// at log2m 6), with an 8-byte id and an 8-byte count: ~1.5 GB for every
// node of uk-2002, ~0.44 ms at 3.35 TB/s.  What the design does about it:
// G threads read one row as V-byte vectors (G = row bytes / V, at most 32,
// V = 16 where the row and its pointer allow), as the merge's grouping
// does; wider rows are read in column chunks of G vectors.  Each thread
// sums its bytes' terms and zeros in registers, the group meets by xor
// shuffles, and its first thread writes the count.  Nothing else is
// written.

namespace {

struct EstArgs {
  const uint8_t* regs;   // (n, R)
  const int64_t* nodes;  // [k], or NULL: row i is i
  int64_t k;
  double* out;           // [k]
  int64_t R;             // row bytes: m
  double c;              // alpha(m) m^2
  int g_log2;            // G = 1 << g_log2 threads a row
  int chunks;            // column chunks of G vectors a row
};

template <int V>
__global__ void __launch_bounds__(THREADS)
    hyperball_estimate_kernel(const EstArgs a) {
  const int64_t tid = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t i = tid >> a.g_log2;
  if (i >= a.k) return;   // whole groups leave: G divides a warp
  const int G = 1 << a.g_log2;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  constexpr int BYTES = V < 4 ? V : 4;   // register bytes in a word

  const int64_t x = a.nodes ? __ldg(a.nodes + i) : i;
  const uint8_t* row = a.regs + x * a.R;
  double s = 0.0;
  int z = 0;
  for (int c = 0; c < a.chunks; ++c) {
    Vec<V> v;
    v.load(row + (int64_t(c) << a.g_log2 | g) * V);
#pragma unroll
    for (int q = 0; q < Vec<V>::NW; ++q) {
#pragma unroll
      for (int b = 0; b < BYTES; ++b) {
        const int r = (v.w[q] >> (8 * b)) & 0xff;
        s += __hiloint2double((1023 - r) << 20, 0);   // 2^-r
        z += r == 0;
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    s += __shfl_xor_sync(mask, s, o);
    z += __shfl_xor_sync(mask, z, o);
  }
  if (g != 0) return;
  const double m = double(a.R);
  const double zf = double(z);
  const double est = (1.0 / s) * a.c;
  const double lin = m * log((1.0 / fmax(zf, 1e-300)) * m);
  a.out[i] = est <= 2.5 * m && zf > 0 ? lin : est;
}

template <int V>
cudaError_t launch_estimate(const EstArgs& a, cudaStream_t st) {
  const int64_t threads = a.k << a.g_log2;
  const dim3 grid(unsigned((threads + THREADS - 1) / THREADS));
  hyperball_estimate_kernel<V><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out [k]: the counts of the k rows of ``nodes`` (NULL: the first k rows) of
// regs (n, row_bytes), row_bytes = m a power of two; c = alpha(m) m^2 as the
// host computes it.  Returns cudaGetLastError after the launch.
extern "C" int wg_hyperball_estimate(const void* regs, int64_t row_bytes,
                                     const void* nodes, int64_t k, double c,
                                     void* out, void* stream) {
  if (row_bytes < 1 || (row_bytes & (row_bytes - 1))) {
    return int(cudaErrorInvalidValue);
  }
  if (k <= 0) return int(cudaGetLastError());
  int64_t V = row_bytes < 16 ? row_bytes : 16;
  while (uintptr_t(regs) & uintptr_t(V - 1)) V >>= 1;
  const int64_t vecs = row_bytes / V;
  const int64_t G = vecs < 32 ? vecs : 32;
  if (((k << log2_of(G)) + THREADS - 1) / THREADS > 0x7fffffff) {
    return int(cudaErrorInvalidConfiguration);
  }
  const EstArgs a{static_cast<const uint8_t*>(regs),
                  static_cast<const int64_t*>(nodes),
                  k,
                  static_cast<double*>(out),
                  row_bytes,
                  c,
                  log2_of(G),
                  int(vecs / G)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (V) {
    case 16: return int(launch_estimate<16>(a, st));
    case 8: return int(launch_estimate<8>(a, st));
    case 4: return int(launch_estimate<4>(a, st));
    case 2: return int(launch_estimate<2>(a, st));
    default: return int(launch_estimate<1>(a, st));
  }
}
