// ef_decode: a whole EFGraph stream, resident on the card, decoded to the
// successors of its CSR in one launch.
//
// Replaces: no TPU kernel.  The JAX package's EF decode
// (webgraph_tpu/ops/efdecode.py, _ef_decode_device) is an XLA program that
// expands the stream to one int32 a bit and ranks the ones by a cumulative
// sum.  The port ran torch ops instead (ops/efdecode.py,
// EFDevicePlan.decode_plain): a rank of every stream word, a searchsorted
// of every arc over those ranks, a SWAR select of ~30 int64 launches, in
// chunks of 2^24 arcs with a readback each.  An H100 trace of a uk-2002-
// scale decode put 83% of its device time in those int64 chains, at 0.25%
// of the byte bound.
//
// Node x's entry (EFGraph.java:140-168) is closed-form in its outdegree d,
// which the CSR's offsets give: gamma(d + 1) in 2 floor(log2(d + 1)) + 1
// bits, npt skip pointers of psize bits, d + 1 lower fields of l bits, then
// the upper bits, where the i-th of d + 1 ones (the last one the sentinel u)
// sits at up_base + (v_i >> l) + i.  So successor j is
//
//   ((pos_j - up_base - j) << l) | (the l bits at low_base + j l)
//
// with pos_j the j-th one at or after up_base.  No other node's one lies
// between up_base and the sentinel, so a node needs only its own upper
// words: no global rank.
//
// What bounds it on this card: memory.  A decode has to read the stream
// once (~23 bits a link for a crawl) and write 4 bytes a successor and 8 a
// node's offset: ~2.2 GB at uk-2002's shape, 0.66 ms at 3.35 TB/s.
//
// What the design does about it: every node's layout, every select and
// every lower field stays on chip; each successor is written once.
//  - a warp owns 32 consecutive nodes; lane i reads node i's start and
//    offsets (coalesced) and computes its layout;
//  - the warp's lists lie in one slice of the stream, from its first lower
//    field to its last upper bit.  A slice of up to STAGE words
//    (the common case) is copied to shared memory by coalesced loads, four
//    in flight a lane, and every later read comes from there, with 32-bit
//    bit positions; a larger one (a long list) is read from device memory,
//    with 64-bit positions;
//  - lists of at most SHORT arcs (most of a crawl's) are decoded
//    flattened: the warp walks their arcs 32 at a time, lane t the t-th.
//    The lists sit in a table in shared memory; each round, one OR over
//    the warp of the lists that start in it gives every lane its list's
//    place by a popcount.  The lane then selects its one alone, from the
//    list's first upper word on, and reads its lower field by one funnel
//    shift, so neighbouring lanes write neighbouring successors;
//  - a longer list is decoded by its warp together: 32 upper words at a
//    time, a shuffle prefix scan of their popcounts, then 32 arcs at a
//    time, each lane finding its word among the 32 by a binary search
//    over the scan and its bit by an in-word select;
//  - a list of more than hub_arcs arcs (the plan's HUB_ARCS) is cut at its
//    skip pointers into segments that the plan lists (each pointer gives
//    the bit after the (k 2^q)-th zero of the upper bits, so the ones
//    before it: a segment needs nothing of the others).  The segments'
//    warps come first in the grid, one a segment, each decoding its words
//    as a warp decodes a longer list; the owner warp skips the list.
// So the work follows each node's outdegree; nothing is set by hand per
// graph.  Successors are int32 (the upper bound is below 2^31).  Every word
// read is clamped to the slice, whatever the offsets say.
//
// On an H100 at uk-2002's shape (297M arcs, 0.658 ms of bytes) it decodes
// in 1.85 ms, 35.6% of the byte bound; a 400,000-arc list alone in 0.21
// ms, most of it the 2^24 nodes' scan; a Graph500 scale-24 graph (520M
// arcs, lists up to ~407k) in 3.51 ms.  The cut is what keeps a long list
// off the critical path: left to its own block's two warps, the 400,000
// arcs took 2.74 ms, and at uk-2002's shape the warps holding four ~4k-arc
// lists ended last (2.19 ms).  Cutting at more than 256 or 1,024 arcs took
// 2% and 1% longer at uk-2002's shape, at 2,048 5% (though 9% less on the
// Graph500 graph); 128 threads a block 5%, 32 threads 1%, SHORT 64 or 256
// 1%, a register cap 1%, no staging 59%.  Most of the time is the select's
// instructions and the latency of each warp's two dependent reads
// (offsets, then its slice).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;          // threads a block, one node each
constexpr int WARPS = THREADS / 32;
constexpr int SHORT = 128;           // the longest list decoded a lane an arc
constexpr int STAGE = 512;           // a warp's stream slice staged in shared
                                     // memory up to this many words
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const uint64_t* words;  // the stream, then two zero guard words
  int64_t nw;             // words, the guards included
  const int64_t* starts;  // [n] bit offset of each node's entry
  const int64_t* off;     // [n + 1] the CSR's offsets
  int32_t* succ;          // [m]
  int64_t n;
  uint32_t u;             // the upper bound, below 2^31
  int log2_quantum;
  int64_t hub_arcs;       // a longer list is decoded by its segments
  const int64_t* segs;    // [nsegs][2]: node, (segment << 32) | segments
  int64_t nsegs;
};

// Words 0..last of a slice of the stream that starts at stream word
// ``first``, and bit positions in it of type P: a warp's slice in shared
// memory (32-bit positions), or the whole stream in device memory.  Every
// read is clamped to the slice.
struct Shared {
  using P = int32_t;
  const uint64_t* w;
  int64_t first;
  P last;
  __device__ __forceinline__ uint64_t word(P k) const { return w[k]; }
  __device__ __forceinline__ uint32_t half(P q) const {
    return reinterpret_cast<const uint32_t*>(w)[q];
  }
};

struct Global {
  using P = int64_t;
  const uint64_t* w;
  int64_t first;
  P last;
  __device__ __forceinline__ uint64_t word(P k) const { return __ldg(w + k); }
  __device__ __forceinline__ uint32_t half(P q) const {
    return __ldg(reinterpret_cast<const uint32_t*>(w) + q);
  }
};

template <typename P>
__device__ __forceinline__ P clamp(P i, P hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// One node's layout, its bit positions in the stream.
struct Node {
  int64_t out;       // off[x]: where its successors go
  int64_t d;         // outdegree
  int64_t low_base;  // bit of its first lower field
  int64_t up_base;   // bit where its upper bits start
  int l;             // lower bits a successor
};

// A list of the warp's flattened short lists, its bit positions in the
// warp's slice.
template <typename P>
struct Entry {
  P up, low;
  int64_t out;
  int l;
  int excl;          // its first arc among the flattened ones
};

union Table {
  Entry<int32_t> s[32];
  Entry<int64_t> g[32];
};

__device__ __forceinline__ Entry<int32_t>* entries(Table& t, const Shared&) {
  return t.s;
}
__device__ __forceinline__ Entry<int64_t>* entries(Table& t, const Global&) {
  return t.g;
}

__device__ __forceinline__ int bit_length(uint64_t v) {
  return 64 - __clzll(static_cast<long long>(v));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a < b ? b : a;
}

// EFGraph.java:140-168 for node x.
__device__ __forceinline__ Node layout(const Args& a, int64_t x) {
  Node v;
  v.out = __ldg(a.off + x);
  v.d = __ldg(a.off + x + 1) - v.out;
  const uint64_t cl = uint64_t(v.d) + 1;
  const int msb = bit_length(cl) - 1;
  const uint32_t q = cl <= 0xffffffffull ? a.u / uint32_t(cl) : 0;
  v.l = q ? bit_length(q) - 1 : 0;
  const uint64_t shifted = uint64_t(a.u) >> v.l;
  const int psize = bit_length(cl + shifted - 1);
  const uint64_t npt = a.log2_quantum < 64 ? shifted >> a.log2_quantum : 0;
  v.low_base = __ldg(a.starts + x) + 2 * msb + 1 + int64_t(npt) * psize;
  v.up_base = v.low_base + int64_t(cl) * v.l;
  return v;
}

// The bit after node v's entry: its upper bits hold u >> l zeros and d + 1
// ones.
__device__ __forceinline__ int64_t entry_end(const Args& a, const Node& v) {
  return v.up_base + int64_t(a.u >> v.l) + v.d + 1;
}

__device__ __forceinline__ Node shfl(const Node& v, int src) {
  Node w;
  w.out = __shfl_sync(FULL, v.out, src);
  w.d = __shfl_sync(FULL, v.d, src);
  w.low_base = __shfl_sync(FULL, v.low_base, src);
  w.up_base = __shfl_sync(FULL, v.up_base, src);
  w.l = __shfl_sync(FULL, v.l, src);
  return w;
}

// The l (below 32) bits at slice bit ``bit``: one funnel shift of two
// 32-bit halves (bit % 32 + l < 64).
template <class S>
__device__ __forceinline__ uint32_t lower(const S& s, typename S::P bit,
                                          int l) {
  using P = typename S::P;
  const P q = clamp<P>(bit >> 5, 2 * s.last);
  const uint32_t v = __funnelshift_r(s.half(q), s.half(q + 1), int(bit & 31));
  return v & ((1u << l) - 1);
}

// Position (0..63) of the r-th (from 0) one of x; r below popc(x).
__device__ __forceinline__ int select64(uint64_t x, int r) {
  uint32_t v = uint32_t(x);
  int base = 0;
  int c = __popc(v);
  if (r >= c) r -= c, v = uint32_t(x >> 32), base = 32;
  c = __popc(v & 0xffffu);
  if (r >= c) r -= c, v >>= 16, base += 16;
  c = __popc(v & 0xffu);
  if (r >= c) r -= c, v >>= 8, base += 8;
  c = __popc(v & 0xfu);
  if (r >= c) r -= c, v >>= 4, base += 4;
  c = __popc(v & 0x3u);
  if (r >= c) r -= c, v >>= 2, base += 2;
  return base + (r >= int(v & 1u));
}

// Inclusive prefix sum over the warp.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += t;
  }
  return x;
}

// Successor j of a list whose j-th one is at slice bit ``pos``.
template <class S>
__device__ __forceinline__ void put(const Args& a, const S& s,
                                    const Entry<typename S::P>& e,
                                    typename S::P j, typename S::P pos) {
  const uint32_t hi = uint32_t(pos - e.up - j);
  a.succ[e.out + j] = int32_t((hi << e.l) | lower(s, e.low + j * e.l, e.l));
}

template <class S>
__device__ __forceinline__ Entry<typename S::P> entry(const S& s,
                                                      const Node& v,
                                                      int excl) {
  using P = typename S::P;
  const int64_t b = s.first << 6;
  return Entry<P>{P(v.up_base - b), P(v.low_base - b), v.out, v.l, excl};
}

// The lists of at most SHORT arcs among the warp's 32 nodes (``mine``),
// their arcs flattened and taken 32 at a time, a lane an arc.  The lists
// go to a table in shared memory; each round, the set of lists that start
// in it (one OR over the warp) gives every lane its list's place there.
template <class S>
__device__ __forceinline__ void short_lists(const Args& a, const S& s,
                                            Table& table, const Node& v,
                                            bool mine, int lane) {
  using P = typename S::P;
  Entry<P>* tab = entries(table, s);
  const int ds = mine ? int(v.d) : 0;
  const int incl = warp_scan(ds, lane);
  const int total = __shfl_sync(FULL, incl, 31);
  const int excl = incl - ds;
  const unsigned below = (1u << lane) - 1, upto = (2u << lane) - 1;
  const unsigned lists = __ballot_sync(FULL, ds > 0);
  if (ds > 0) tab[__popc(lists & below)] = entry(s, v, excl);
  __syncwarp();
  int before = 0;   // lists that start before this round
  for (int b = 0; b < total; b += 32) {
    const bool here = ds > 0 && excl >= b && excl < b + 32;
    const unsigned starts = __reduce_or_sync(FULL, here ? 1u << (excl - b)
                                                        : 0u);
    const int t = b + lane;
    if (t < total) {
      const Entry<P> e = tab[before + __popc(starts & upto) - 1];
      const P j = t - e.excl;
      // the j-th one from e.up on, a word at a time
      P k = clamp<P>(e.up >> 6, s.last);
      uint64_t x = s.word(k) & (~0ull << (e.up & 63));
      int r = int(j), c = __popcll(x);
      while (r >= c && k < s.last) {
        r -= c;
        x = s.word(++k);
        c = __popcll(x);
      }
      put(a, s, e, j, (k << 6) + select64(x, r));
    }
    before += __popc(starts);
  }
  __syncwarp();
}

// Node v's successors whose ones lie in slice words [wa, wb), the first of
// them its ``carry``-th, decoded by the whole warp.
template <class S>
__device__ void warp_words(const Args& a, const S& s, const Node& v,
                           typename S::P wa, typename S::P wb, int64_t carry,
                           int lane) {
  using P = typename S::P;
  const Entry<P> e = entry(s, v, 0);
  const P first = e.up >> 6;
  const uint64_t head = ~0ull << (e.up & 63);
  wa = wa < 0 ? 0 : wa;
  wb = wb > s.last + 1 ? s.last + 1 : wb;
  for (P c0 = wa; c0 < wb && carry < v.d; c0 += 32) {
    const P k = c0 + lane;
    uint64_t x = k < wb ? s.word(k) : 0;
    if (k == first) x &= head;
    const int pc = __popcll(x);
    const int incl = warp_scan(pc, lane);
    const int total = __shfl_sync(FULL, incl, 31);
    const int excl = incl - pc;
    const int64_t end = min64(carry + total, v.d);
    for (int64_t jb = carry; jb < end; jb += 32) {
      const int64_t j = jb + lane;
      const int rel = int(j - carry);
      // the lanes whose words end at or before one ``rel``: its word's lane
      int o = 0;
#pragma unroll
      for (int t = 16; t; t >>= 1) {
        if (__shfl_sync(FULL, incl, o + t - 1) <= rel) o += t;
      }
      const uint64_t xo = __shfl_sync(FULL, x, o);
      const int r = rel - __shfl_sync(FULL, excl, o);
      if (j < end) put(a, s, e, P(j), ((c0 + o) << 6) + select64(xo, r));
    }
    carry += total;
  }
}

// The warp's own lists: the short ones flattened, the others of at most
// hub_arcs arcs one after another by the whole warp.
template <class S>
__device__ __forceinline__ void warp_lists(const Args& a, const S& s,
                                           Table& table, const Node& v,
                                           int lane) {
  using P = typename S::P;
  short_lists(a, s, table, v, v.d <= SHORT, lane);
  for (unsigned mid = __ballot_sync(FULL, v.d > SHORT);
       mid; mid &= mid - 1) {
    const Node nd = shfl(v, __ffs(mid) - 1);
    warp_words(a, s, nd, P((nd.up_base >> 6) - s.first),
               P(((entry_end(a, nd) - 2) >> 6) + 1 - s.first), 0, lane);
  }
}

// Cut k (0 to npt + 1) of node w's upper bits, at its skip pointers: the
// word where the part after the cut starts, and the list's ones before that
// word.  Pointer k (1 to npt) holds the region's bit after its (k 2^q)-th
// zero, so the ones before that bit are pointer k - k 2^q; cut 0 is the
// region's start, cut npt + 1 the word after its last successor's one.
__device__ __forceinline__ void cut(const Args& a, const Node& w, int64_t k,
                                    int64_t npt, int64_t& word,
                                    int64_t& carry) {
  carry = 0;
  if (k == 0) {
    word = w.up_base >> 6;
    return;
  }
  if (k > npt) {
    word = ((entry_end(a, w) - 2) >> 6) + 1;
    return;
  }
  const uint64_t cl = uint64_t(w.d) + 1;
  const int psize = bit_length(cl + (uint64_t(a.u) >> w.l) - 1);
  const int64_t p = w.low_base - (npt - (k - 1)) * psize;
  const int64_t i = clamp<int64_t>(p >> 6, a.nw - 2);
  const int sh = int(p & 63);
  uint64_t ptr = __ldg(a.words + i) >> sh;
  if (sh) ptr |= __ldg(a.words + i + 1) << (64 - sh);
  ptr &= psize < 64 ? (1ull << psize) - 1 : ~0ull;
  const int64_t b = w.up_base + int64_t(ptr);
  word = clamp<int64_t>(b >> 6, a.nw - 1);
  // the ones of the region in word ``word`` before bit b
  uint64_t x = __ldg(a.words + word);
  x &= (b & 63) ? (1ull << (b & 63)) - 1 : 0ull;
  if (word == w.up_base >> 6) x &= ~0ull << (w.up_base & 63);
  carry = max64(int64_t(ptr) - (k << a.log2_quantum) - __popcll(x), 0);
}

// Segment i of the plan's list: segment s of the ns of node x's list,
// between cuts s (npt + 1) / ns and (s + 1) (npt + 1) / ns.
__device__ __forceinline__ void segment(const Args& a, int64_t i, int lane) {
  const int64_t x = __ldg(a.segs + 2 * i);
  const int64_t sn = __ldg(a.segs + 2 * i + 1);
  const int64_t s = sn >> 32, ns = sn & 0xffffffff;
  const Node w = layout(a, x);
  const int64_t npt =
      a.log2_quantum < 64 ? (uint64_t(a.u) >> w.l) >> a.log2_quantum : 0;
  int64_t wa, wb, carry, unused;
  cut(a, w, s * (npt + 1) / ns, npt, wa, carry);
  cut(a, w, (s + 1) * (npt + 1) / ns, npt, wb, unused);
  warp_words(a, Global{a.words, 0, a.nw - 1}, w, wa, wb, carry, lane);
}

__global__ void __launch_bounds__(THREADS) ef_decode_kernel(const Args a) {
  __shared__ Table table[WARPS];
  __shared__ uint64_t stage[WARPS][STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the segments' blocks first, so that no hub is left to the end
  const int64_t seg_blocks = (a.nsegs + WARPS - 1) / WARPS;
  if (blockIdx.x < seg_blocks) {
    const int64_t i = int64_t(blockIdx.x) * WARPS + warp;
    if (i < a.nsegs) segment(a, i, lane);
    return;
  }

  const int64_t x = (int64_t(blockIdx.x) - seg_blocks) * THREADS +
                    threadIdx.x;
  Node v{0, 0, 0, 0, 0};
  if (x < a.n) v = layout(a, x);
  if (v.d > a.hub_arcs) v.d = 0;   // its segments' warps decode it
  const Global global{a.words, 0, a.nw - 1};
  // the words the warp's lists read: from its first lower field to the
  // word after its last upper bit (a field may end on that bit)
  int64_t lo = v.d > 0 ? v.low_base >> 6 : INT64_MAX;
  int64_t hi = v.d > 0 ? ((entry_end(a, v) - 1) >> 6) + 1 : -1;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min64(lo, __shfl_xor_sync(FULL, lo, o));
    hi = max64(hi, __shfl_xor_sync(FULL, hi, o));
  }
  hi = min64(hi, a.nw - 1);
  if (lo <= hi && hi - lo < STAGE) {
    // four loads in flight a lane before their stores
    for (int64_t i0 = lo + lane; i0 <= hi; i0 += 4 * 32) {
      uint64_t t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = i0 + k * 32;
        t[k] = i <= hi ? global.word(i) : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = i0 + k * 32;
        if (i <= hi) stage[warp][i - lo] = t[k];
      }
    }
    __syncwarp();
    warp_lists(a, Shared{stage[warp], lo, int32_t(hi - lo)}, table[warp], v,
               lane);
  } else {
    warp_lists(a, global, table[warp], v, lane);
  }
}

}  // namespace

// succ[m] of the EFGraph whose stream ``words`` holds nwords 64-bit words
// and two zero guard words after them, n nodes whose entries start at bits
// starts[n], with the CSR offsets off[n + 1] (their outdegrees), upper
// bound upper_bound (below 2^31) and log2 quantum log2_quantum.  The lists
// of more than hub_arcs arcs are decoded by the nsegs segments segs[nsegs][2]
// (node, (segment << 32) | its list's segments), which cover every such
// list.  Returns cudaGetLastError after the launch.
extern "C" int wg_ef_decode(const void* words, int64_t nwords,
                            const void* starts, const void* off, int64_t n,
                            int64_t upper_bound, int log2_quantum,
                            int64_t hub_arcs, const void* segs,
                            int64_t nsegs, void* succ, void* stream) {
  if (upper_bound < 0 || upper_bound >= (int64_t(1) << 31) ||
      log2_quantum < 0 || nwords < 0 || hub_arcs < 0 || nsegs < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (n <= 0) return int(cudaGetLastError());
  const int64_t blocks =
      (nsegs + WARPS - 1) / WARPS + (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  const Args a{static_cast<const uint64_t*>(words),
               nwords + 2,
               static_cast<const int64_t*>(starts),
               static_cast<const int64_t*>(off),
               static_cast<int32_t*>(succ),
               n,
               uint32_t(upper_bound),
               log2_quantum,
               hub_arcs,
               static_cast<const int64_t*>(segs),
               nsegs};
  ef_decode_kernel<<<unsigned(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
