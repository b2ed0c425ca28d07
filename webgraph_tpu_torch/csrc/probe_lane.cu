// probe_lane.cu: the decode kernel's lane state machine, whole and in parts.
//
// Replaces the Pallas probe kernels of the JAX package's experiments/:
//   pallas_probe6.py   build(steps): refill, shift pair, copy-head read, write
//   pallas_probe7.py   run: six bodies (ref writes, masked writes and reads)
//   pallas_probe8.py   run: five bodies (vector mod, two outputs, mixed carries)
//   pallas_probe9.py   build: probe6's body with each piece on or off
//   pallas_probe10.py  build: five forms of the masked column load
//   pallas_probe11.py  run: seven variable-shift forms
//   pallas_probe12.py  run: conditional refill and shift pair, four bodies
//   pallas_probe13.py  run: five variants of the conditional refill
//   pallas_probe14.py  run: the column staged through scratch, two avail kinds
//   pallas_probe15.py  run: four index dependences, one writing its scratch
//
// One (8, 128) tile of 1,024 lanes is one block of 1,024 threads.  Lane t's
// column of an (R, 8, 128) array is the words [r * 1024 + t], so neighbouring
// lanes touch neighbouring words.  What the TPU computed as a masked compare
// and sum over all R rows (`mload`, `mread`) is one indexed load here, and
// its masked select over all V rows (`mwrite`) one store; an index outside
// the rows loads 0 and stores nothing, as the masked forms did.
//
// The probes' while-loop conditions are `any(...)` over the tile: each step
// is a block-wide vote (__syncthreads_or), and a lane whose own condition
// has failed keeps stepping until every lane's has.
//
// Every body is a struct with its carries, its condition, its step and its
// epilogue; one kernel template runs them, and the variant id picks the
// struct.  Carries are uint32_t where the JAX code wraps (int32 overflow is
// undefined in C++) and int where it does not; `%` is the floor modulo of
// JAX, not C's.
//
// What bounds it on this card: one block on one SM, a dependent chain of a
// few tens of instructions a step, one vote a step, and loads that hit L1 /
// L2 (a column of 64 words is 256 KB a tile, the output column 2.6 MB).  The
// probes ask what a step of each form costs, not for throughput.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 1024;  // lanes of one (8, 128) tile

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void keep(int& v) { asm volatile("" : "+r"(v)); }

struct Ctx {
  const int32_t* col;  // (R, 8, 128), read only
  int32_t* out;        // (V, 8, 128), or (8, 128) for the tile-out bodies
  int32_t* diag;       // (2, 8, 128) where the body has one
  int32_t* scr;        // (R, 8, 128) scratch where the body stages its column
  int R, V, steps;
  const int32_t* src;  // col, or scr once staged
  int t;

  __device__ uint32_t mload(int rp) const {
    return (unsigned)rp < (unsigned)R ? uint32_t(src[rp * L + t]) : 0u;
  }
  __device__ uint32_t mread(int row) const {
    return (unsigned)row < (unsigned)V ? uint32_t(out[row * L + t]) : 0u;
  }
  __device__ void mwrite(int row, uint32_t v) const {
    if ((unsigned)row < (unsigned)V) out[row * L + t] = int32_t(v);
  }
  __device__ void put(int32_t* p, int row, uint32_t v) const {
    p[row * L + t] = int32_t(v);
  }
};

enum { OUT_COL, OUT_TILE };

struct Base {
  static constexpr bool kVote = true;      // tile-wide any() each step
  static constexpr int kOut = OUT_COL;     // zero-filled (V, 8, 128) output
  static constexpr bool kScratch = false;  // stage the column in scr first
};

// ---- pallas_probe6.py build / pallas_probe9.py build(refill, shift, read, write)
template <bool RF, bool SH, bool RD, bool WR>
struct P9 : Base {
  int rp = 0, wcur = 0, avail = 96;
  uint32_t b0 = 0, b1 = 0, acc = 0;
  __device__ bool go() const { return int32_t(acc) >= 0; }
  __device__ void step(const Ctx& c, int step) {
    if constexpr (RF) {
      const bool need = avail <= 64;
      const uint32_t w = c.mload(need ? rp : c.R + 1);
      if (need) {
        b1 |= w >> 16;
        avail += 32;
        rp += 1;
      }
    }
    if constexpr (SH) {
      const int k = int(b1 & 7u) + 1;
      b0 = (b0 << k) | (b1 >> (32 - k));
      b1 <<= k;
      avail -= k;
    }
    uint32_t val = b0 ^ acc;
    if constexpr (RD) {
      const int r = floor_mod(int32_t(acc + uint32_t(step)), max(wcur, 1));
      val = (c.mread(r) ^ val) & 0x7fffffffu;
    }
    if constexpr (WR) c.mwrite(floor_mod(wcur, c.V), val);
    acc += val & 7u;
    rp = floor_mod(rp, c.R);
    wcur += 1;
  }
  __device__ void finish(const Ctx& c) const {
    c.put(c.diag, 0, acc);
    c.put(c.diag, 1, uint32_t(wcur));
  }
};

// ---- pallas_probe7.py
struct P7RefWrite : Base {
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx& c, int) {
    c.put(c.out, 0, acc);
    acc += 1;
  }
  __device__ void finish(const Ctx&) const {}
};

template <bool FORI>
struct P7MaskedWrite : Base {
  static constexpr bool kVote = !FORI;
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx& c, int) {
    c.mwrite(floor_mod(int32_t(acc), c.V), acc);
    acc += 1;
  }
  __device__ void finish(const Ctx&) const {}
};

struct P7MaskedSumCol : Base {
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx& c, int) {
    acc += c.mload(floor_mod(int32_t(acc), c.R)) & 7u;
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, acc); }
};

struct P7MaskedReadOut : Base {
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx& c, int) {
    const int row = floor_mod(int32_t(acc), c.V);
    c.mwrite(row, c.mread(row) + acc);
    acc += 1;
  }
  __device__ void finish(const Ctx&) const {}
};

struct P7UintShift : Base {
  uint32_t b0 = 3, b1 = 5;
  __device__ bool go() const { return b0 < 0x80000000u; }
  __device__ void step(const Ctx&, int) {
    const uint32_t k = (b1 & 7u) + 1;
    b0 = (b0 << k) | (b1 >> (32 - k));
    b1 = (b1 << k) | b0;
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, b0); }
};

// ---- pallas_probe8.py
struct P8VecModVec : Base {
  uint32_t acc = 0;
  int w = 1;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx&, int step) {
    acc += uint32_t(floor_mod(int32_t(acc + uint32_t(step)), max(w, 1)));
    w += 1;
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, acc); }
};

struct P8ScalarBcast : Base {
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx&, int step) { acc += uint32_t(step); }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, acc); }
};

struct P8TwoOutputs : Base {
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx&, int) { acc += 1; }
  __device__ void finish(const Ctx& c) const {
    c.put(c.diag, 0, acc);
    c.put(c.diag, 1, acc);
    c.put(c.out, 0, acc);
  }
};

struct P8MixedCarry : Base {
  uint32_t b0 = 12345, acc = 0;
  int avail = 96;
  __device__ bool go() const { return int32_t(acc) < 1000000000; }
  __device__ void step(const Ctx&, int) {
    const int k = int(b0 & 7u) + 1;
    b0 <<= k;
    avail -= k;
    if (avail <= 64) {
      avail += 32;
      b0 |= 0x9e3779b9u;
    }
    acc += b0 & 7u;
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, acc); }
};

struct P8ShiftBy32Minus : Base {
  uint32_t b0 = 3, b1 = 0x12345678u;
  __device__ bool go() const { return b0 < 0x80000000u; }
  __device__ void step(const Ctx&, int) {
    const int k = int(b1 & 7u) + 1;  // 1..8: 32 - k is 24..31
    b0 = (b0 << k) | (b1 >> (32 - k));
    b1 <<= k;
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, b0); }
};

// ---- pallas_probe10.py build(variant): the load forms
enum { LD_SUM, LD_BARRIER, LD_BARRIER_K, LD_FORI, LD_MAX };

template <int F>
struct P10 : Base {
  int rp = 0, avail = 96;
  uint32_t b0 = 0, b1 = 0, acc = 0;
  __device__ bool go() const { return int32_t(acc) < (1 << 30); }
  __device__ void step(const Ctx& c, int) {
    const bool need = avail <= 64;
    const int idx = need ? rp : c.R + 1;
    uint32_t w;
    if constexpr (F == LD_FORI) {  // a loop over the rows, as on the TPU
      w = 0;
      for (int i = 0; i < c.R; ++i)
        w += idx == i ? uint32_t(c.src[i * L + c.t]) : 0u;
    } else if constexpr (F == LD_MAX) {  // max over rows of where(m, col, 0)
      w = uint32_t(max(int32_t(c.mload(idx)), 0));
    } else {
      w = c.mload(idx);
    }
    if constexpr (F == LD_BARRIER) keep(w);
    if (need) {
      b1 |= w >> 16;
      avail += 32;
      rp += 1;
    }
    int k = int(b1 & 7u) + 1;
    if constexpr (F == LD_BARRIER_K) keep(k);
    b0 = (b0 << k) | (b1 >> (32 - k));
    b1 <<= k;
    avail -= k;
    acc += b0;
    rp = floor_mod(rp, c.R);
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, acc); }
};

// ---- pallas_probe11.py run(body_fn): w = col[rp] every step
template <int V>
struct P11 : Base {
  static constexpr int kOut = OUT_TILE;
  int rp = 0;
  uint32_t b0 = 0, b1 = 0;
  __device__ bool go() const { return b0 < 0xffffffffu; }
  __device__ void step(const Ctx& c, int) {
    const uint32_t w = c.mload(rp);
    if constexpr (V == 1) {
      b0 = (b0 << ((w & 7u) + 1)) | w;
    } else if constexpr (V == 2) {
      b1 |= w;
      b0 = (b0 << ((b1 & 7u) + 1)) | 1u;
    } else if constexpr (V == 3) {
      b1 |= w;
      const uint32_t k = (b1 & 7u) + 1;
      b0 = b0 + k * k;
    } else if constexpr (V == 4) {
      b1 |= w;
      b0 = (b0 << 3) | (b1 >> 16);
    } else if constexpr (V == 5) {
      b1 |= w;
      // lax.shift_left on int32: the same bits as the unsigned shift
      b0 += b1 << (int(b1 & 7u) + 1);
    } else if constexpr (V == 6) {
      b1 |= w;
      const int k = int(b1 & 7u) + 1;
      uint32_t r = 0;
#pragma unroll
      for (int kk = 1; kk <= 8; ++kk) r = k == kk ? b0 << kk : r;
      b0 = r | 1u;
    } else if constexpr (V == 7) {
      const uint32_t k = (w & 7u) + 1;
      b1 += 1;
      b0 = (b1 << k) | b0;
    }
    rp = floor_mod(rp + 1, c.R);
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, b0); }
};

// ---- pallas_probe12.py / 13.py / 14.py: the conditional-refill stream
enum { S_P1, S_P2, S_P3, S_P4, S_Q1, S_Q2, S_Q3, S_Q4, S_Q5, S_Q6 };

template <int K, bool SCR>
struct Stream : Base {
  static constexpr int kOut = OUT_TILE;
  static constexpr bool kScratch = SCR;
  int rp = 0, avail = 96;
  uint32_t b0 = 0, b1 = 0;
  __device__ bool go() const { return avail > -(1 << 30); }
  __device__ void step(const Ctx& c, int step) {
    if constexpr (K == S_P1) {  // unconditional load, shift pair
      b1 |= c.mload(rp);
      const uint32_t k = (b1 & 7u) + 1;
      b0 = (b0 << k) | (b1 >> (32 - k));
      b1 <<= k;
      rp = floor_mod(rp + 1, c.R);
      return;
    }
    bool need = avail <= 64;
    if constexpr (K == S_Q5) need = step % 2 == 0 && avail > -(1 << 30);
    uint32_t w;
    if constexpr (K == S_Q1)
      w = c.mload(need ? rp : -1);
    else if constexpr (K == S_Q3)
      w = c.mload(floor_mod(rp, c.R));
    else
      w = c.mload(need ? rp : c.R + 1);
    if (need) {
      b1 |= w;
      avail += 32;
      rp = K == S_Q2 ? (rp + 1) & (c.R - 1) : rp + 1;
    }
    const int k = int(b1 & 7u) + 1;
    if constexpr (K == S_P3 || K == S_P4) {
      b0 = (b0 << k) | (b1 >> (32 - k));
      b1 <<= k;
    } else if constexpr (K == S_Q4) {
      b0 = b0 + (b1 << 3) + uint32_t(k);
    } else {
      b0 = b0 + (b1 << k);
    }
    if constexpr (K == S_Q6)
      avail = avail - 4 - step % 3;
    else
      avail -= k;
    if constexpr (K != S_Q2 && K != S_Q3) rp = floor_mod(rp, c.R);
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, b0); }
};

// ---- pallas_probe15.py run(variant): index dependences, column in scratch
template <int V>
struct P15 : Base {
  static constexpr int kOut = OUT_TILE;
  static constexpr bool kScratch = true;
  int rp = 0;
  uint32_t acc = 0;
  __device__ bool go() const { return int32_t(acc) > -(1 << 30); }
  __device__ void step(const Ctx& c, int) {
    uint32_t w;
    if constexpr (V == 2) {
      w = c.mload((acc & 1u) == 0 ? rp : -1);
      rp = floor_mod(rp + 1, c.R);
    } else {
      w = c.mload(rp);
      if constexpr (V == 4) c.put(c.scr, floor_mod(rp + 7, c.R), w + 1);
      if constexpr (V == 3)
        rp = floor_mod((w & 1u) == 0 ? rp + 1 : rp, c.R);
      else
        rp = floor_mod(rp + int(w & 1u) + 1, c.R);
    }
    acc += w;
  }
  __device__ void finish(const Ctx& c) const { c.put(c.out, 0, acc); }
};

template <class B>
__global__ void __launch_bounds__(L) lane_kernel(Ctx c) {
  c.t = threadIdx.x;
  if constexpr (B::kOut == OUT_COL)
    for (int r = 0; r < c.V; ++r) c.out[r * L + c.t] = 0;
  if constexpr (B::kScratch) {
    for (int r = 0; r < c.R; ++r) c.scr[r * L + c.t] = c.col[r * L + c.t];
    c.src = c.scr;
  } else {
    c.src = c.col;
  }
  B b;
  for (int step = 0; step < c.steps; ++step) {
    if constexpr (B::kVote) {
      if (!__syncthreads_or(b.go())) break;
    }
    b.step(c, step);
  }
  b.finish(c);
}

}  // namespace

// variant: the body's index in webgraph_tpu_torch/experiments/lanes.py
// BODIES (the order of the cases below).  col: (R, 8, 128); out: (V, 8, 128)
// or (8, 128); diag: (2, 8, 128) or null; scr: (R, 8, 128) or null.
extern "C" int wg_probe_lane(int variant, const void* col, void* out,
                             void* diag, void* scr, int R, int V, int steps,
                             void* stream) {
  if (R <= 0 || V <= 0 || steps < 0) return int(cudaErrorInvalidValue);
  Ctx c{static_cast<const int32_t*>(col), static_cast<int32_t*>(out),
        static_cast<int32_t*>(diag), static_cast<int32_t*>(scr), R, V, steps,
        nullptr, 0};
  const auto st = static_cast<cudaStream_t>(stream);
#define LANE(id, ...)                                \
  case id:                                           \
    lane_kernel<__VA_ARGS__><<<1, L, 0, st>>>(c); \
    break;
  switch (variant) {
    LANE(0, P9<true, true, true, true>)      // p9_all (and probe6)
    LANE(1, P9<false, true, true, true>)     // p9_no_refill
    LANE(2, P9<true, false, true, true>)     // p9_no_shift
    LANE(3, P9<true, true, false, true>)     // p9_no_read
    LANE(4, P9<true, true, true, false>)     // p9_no_write
    LANE(5, P9<true, true, false, false>)    // p9_refill_shift
    LANE(6, P9<false, false, true, true>)    // p9_read_write
    LANE(7, P7RefWrite)
    LANE(8, P7MaskedWrite<false>)
    LANE(9, P7MaskedWrite<true>)
    LANE(10, P7MaskedSumCol)
    LANE(11, P7MaskedReadOut)
    LANE(12, P7UintShift)
    LANE(13, P8VecModVec)
    LANE(14, P8ScalarBcast)
    LANE(15, P8TwoOutputs)
    LANE(16, P8MixedCarry)
    LANE(17, P8ShiftBy32Minus)
    LANE(18, P10<LD_SUM>)
    LANE(19, P10<LD_BARRIER>)
    LANE(20, P10<LD_BARRIER_K>)
    LANE(21, P10<LD_FORI>)
    LANE(22, P10<LD_MAX>)
    LANE(23, P11<1>)
    LANE(24, P11<2>)
    LANE(25, P11<3>)
    LANE(26, P11<4>)
    LANE(27, P11<5>)
    LANE(28, P11<6>)
    LANE(29, P11<7>)
    LANE(30, Stream<S_P1, false>)
    LANE(31, Stream<S_P2, false>)
    LANE(32, Stream<S_P3, false>)
    LANE(33, Stream<S_P4, false>)
    LANE(34, Stream<S_Q1, false>)
    LANE(35, Stream<S_Q2, false>)
    LANE(36, Stream<S_Q3, false>)
    LANE(37, Stream<S_Q4, false>)
    LANE(38, Stream<S_Q5, false>)
    LANE(39, Stream<S_P2, true>)     // p14 q8: scratch, data-dependent avail
    LANE(40, Stream<S_Q6, false>)    // p14 q6: input, step-dependent avail
    LANE(41, Stream<S_Q6, true>)     // p14 q9: scratch, step-dependent avail
    LANE(42, Stream<S_P2, false>)    // p14 q10: input, data-dependent avail
    LANE(43, P15<1>)
    LANE(44, P15<2>)
    LANE(45, P15<3>)
    LANE(46, P15<4>)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef LANE
  return int(cudaGetLastError());
}
