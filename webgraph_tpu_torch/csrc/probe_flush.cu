// probe_flush.cu: output-store strategies for the decode kernel's flush.
//
// Replaces the Pallas probe kernel of the JAX package's
// experiments/pallas_probe17.py (make(variant)).
//
// Every variant runs the same stage-register discipline: 16 int32 stage
// words a lane, two of them written a step (slot wt & 7 of bank (wt >> 3) & 1,
// value 3 wt, for wt = wcur and wcur + 1), then wcur += 2.  Then one flush
// strategy, from the group gb = max((wcur >> 3) - 1, 0) % V8 of the lane's
// output column out_buf (V8 groups of 8 words):
//
//   none     no flush (the floor: staging and loop cost)
//   rmw      every 4th step, a read-select-write sweep over all V8 groups
//            that leaves group gb equal to the stage bank gb & 1
//   mstore   every 4th step, a plain store of that bank into group gb
//   rmw3     when step & 11 == 11, one sweep that places 3 groups
//   window8  every 4th step, a read-select-write of an 8-group window at
//            lo = clamp(max over the tile of gb - 7, 0, V8 - 8): a tile-wide
//            reduction; a lane whose gb is outside the window writes nothing
//   tmajor   every 4th step, a plain store of the bank at slab
//            (step >> 2) % F8 of the time-major buffer tm_buf
//   read64   no flush; every step a sweep over all V8 groups that sums the
//            8 words of group (7 wcur) % V8 into acc (the copy-read cost)
//
// The output is acc + wcur + out_buf[0, 0] + tm_buf[0, 0].  The sweeps are
// the TPU's strategies written out as loads and stores, so that they can be
// timed beside the direct stores that Hopper offers (mstore, tmajor).
//
// One (8, 128) tile is one block of 1,024 threads; the stage words live in
// registers (every index into them is a compile-time constant).  out_buf
// (2 MB a tile) and tm_buf (2.6 MB) do not fit in shared memory and live in
// device memory, zero-filled by the caller; lane t's word j of group g is at
// (g * 8 + j) * 1024 + t, so a warp's accesses are coalesced.
//
// What bounds it on this card: one block on one SM; the sweeps are 512 loads
// (and stores) a lane at L2 latency and bandwidth, the direct stores 8.
// The stage words feed a final branch that the compiler cannot rule out
// (`ones`, an all-ones kernel argument), so no variant drops the staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 1024;
constexpr int WARPS = L / 32;

// variant ids: webgraph_tpu_torch/experiments/probe17.py VARIANTS
enum { NONE, RMW, MSTORE, RMW3, WINDOW8, TMAJOR, READ64 };

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

__device__ int block_max(int v, int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
  for (int i = 1; i < WARPS; ++i) m = max(m, red[i]);
  __syncthreads();  // red is reused at the next flush
  return m;
}

template <int V>
__global__ void __launch_bounds__(L)
    flush_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 int32_t* __restrict__ out_buf, int32_t* __restrict__ tm_buf,
                 int steps, int v8, int f8, uint32_t ones) {
  __shared__ int red[WARPS];
  const int t = threadIdx.x;
  int32_t* col = out_buf + t;  // word j of group g: col[(g * 8 + j) * L]
  int wcur = x[t] & 7;
  uint32_t acc = 0;
  uint32_t stw[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) stw[s] = 0;

  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int wt = wcur + u;
      const int slot = (((wt >> 3) & 1) << 3) | (wt & 7);
      const uint32_t val = uint32_t(wt) * 3u;
#pragma unroll
      for (int s = 0; s < 16; ++s) stw[s] = s == slot ? val : stw[s];
    }
    wcur += 2;
    const bool flush_now = (step & 3) == 3;
    const int gb = floor_mod(max((wcur >> 3) - 1, 0), v8);
    const bool hi_bank = (gb & 1) != 0;

    if constexpr (V == RMW) {
      if (flush_now) {
        for (int g = 0; g < v8; ++g) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            int32_t* p = col + (g * 8 + j) * L;
            const uint32_t v = hi_bank ? stw[8 + j] : stw[j];
            *p = g == gb ? int32_t(v) : *p;
          }
        }
      }
    } else if constexpr (V == MSTORE) {
      if (flush_now) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          col[(gb * 8 + j) * L] = int32_t(hi_bank ? stw[8 + j] : stw[j]);
      }
    } else if constexpr (V == RMW3) {
      if ((step & 11) == 11) {
        for (int g = 0; g < v8; ++g) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            int32_t* p = col + (g * 8 + j) * L;
            uint32_t cur = uint32_t(*p);
            cur = g == gb ? stw[j] : cur;
            cur = g == gb - 1 ? stw[8 + j] : cur;
            cur = g == gb - 2 ? stw[(j + 1) & 7] : cur;
            *p = int32_t(cur);
          }
        }
      }
    } else if constexpr (V == WINDOW8) {
      if (flush_now) {  // uniform across the block: every thread reduces
        const int hi = block_max(gb, red);
        const int lo = min(max(hi - 7, 0), v8 - 8);
        for (int w = 0; w < 8; ++w) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            int32_t* p = col + ((lo + w) * 8 + j) * L;
            const uint32_t v = hi_bank ? stw[8 + j] : stw[j];
            *p = gb - lo == w ? int32_t(v) : *p;
          }
        }
      }
    } else if constexpr (V == TMAJOR) {
      if (flush_now) {
        const int fi = floor_mod(step >> 2, f8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tm_buf[(fi * 8 + j) * L + t] =
              int32_t(hi_bank ? stw[8 + j] : stw[j]);
      }
    } else if constexpr (V == READ64) {
      const int gsel = floor_mod(wcur * 7, v8);
      uint32_t rd = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        for (int g = 0; g < v8; ++g)
          rd += g == gsel ? uint32_t(col[(g * 8 + j) * L]) : 0u;
      acc += rd;
    }
  }
  uint32_t res = acc + uint32_t(wcur) + uint32_t(out_buf[t]) +
                 uint32_t(tm_buf[t]);
  // never taken (ones is all ones), but the compiler cannot know it: the
  // stage words stay live, so `none` pays for the staging as the TPU did
  if (ones == 0) {
#pragma unroll
    for (int s = 0; s < 16; ++s) res ^= stw[s];
  }
  out[t] = int32_t(res);
}

}  // namespace

// variant: one of the ids above.  x, out: (8, 128); out_buf: (v8, 8, 8, 128)
// and tm_buf: (f8, 8, 8, 128), zero-filled by the caller; v8 >= 8.
extern "C" int wg_probe_flush(int variant, const void* x, void* out,
                              void* out_buf, void* tm_buf, int steps, int v8,
                              int f8, void* stream) {
  if (steps < 0 || v8 < 8 || f8 < 1) return int(cudaErrorInvalidValue);
  const auto* xi = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  auto* ob = static_cast<int32_t*>(out_buf);
  auto* tb = static_cast<int32_t*>(tm_buf);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case NONE: flush_kernel<NONE><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    case RMW: flush_kernel<RMW><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    case MSTORE: flush_kernel<MSTORE><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    case RMW3: flush_kernel<RMW3><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    case WINDOW8: flush_kernel<WINDOW8><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    case TMAJOR: flush_kernel<TMAJOR><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    case READ64: flush_kernel<READ64><<<1, L, 0, st>>>(xi, o, ob, tb, steps, v8, f8, ~0u); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
