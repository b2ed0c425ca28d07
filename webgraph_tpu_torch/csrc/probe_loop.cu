// probe_loop.cu: the loop-floor and per-lane gather probes.
//
// Replaces the Pallas probe kernels of the JAX package's experiments/:
//   pallas_probe.py    trivial, gather_sublane, gather_ref, gather_1d,
//                      vpu_loop, gather_32
//   pallas_probe2.py   loop_kernel (add, add10, mul, shift, gather_tile)
//   pallas_probe3.py   loop_kernel (add)
//   pallas_probe4.py   loop_kernel (acc + (x ^ acc), 1 / 10 / 50 per step)
//   pallas_probe16.py  make (nc int32 carries, optional masked-sum sweep)
//
// One lane is one int32 element of an (S, 128) array and one thread.  No
// loop here has a condition across lanes, so the grid is any number of
// blocks of THREADS threads.
//
// What bounds it on this card: the latency of one dependent step (each step
// needs the carry of the step before), and for the gathers the latency of
// one load: from device memory (through L1 / L2) for the (4096, 128) table,
// from shared memory for the 16 KB one-dimensional table.
//
// What the design does about it: nothing beyond keeping each step honest.
// Every carry goes through `& ones` every step, `ones` an all-ones kernel
// argument the compiler cannot see: without it ptxas folds a chain of adds
// into a closed form (acc + steps * x; an empty asm statement does not stop
// it, since it leaves nothing in the PTX).  The probes ask what a step costs,
// so every step runs, as it did on the TPU, at one logical op a carry more.
// For the same reason the accumulator starts at ~ones (0, which the compiler
// cannot prove: from a known 0 the mul body stays 0 and its loop is dropped),
// and probe16's carries all feed a final branch that is never taken but
// cannot be ruled out, so that no carry is dead code.
// Arithmetic is done in uint32_t, so that int32 overflow wraps as in JAX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// variant ids: webgraph_tpu_torch/experiments/common.py LOOP_*
enum {
  TRIVIAL = 0,
  GATHER_TBL = 1,   // acc += tbl[(x + acc) & wmask, col], tbl (W, 128)
  GATHER_1D = 2,    // acc += tbl[(x + acc) & wmask], tbl (W,) in shared memory
  VPU = 3,          // acc += ((x * acc + 12345) >> 3) & 7
  ADD = 4,          // acc += x
  XORADD = 5,       // acc = acc + (x ^ acc), param times a step
  MUL = 6,          // acc = acc + x * acc
  SHIFT = 7,        // acc = ((acc + x) >> 1) | (acc << 1)
  GATHER_TILE = 8,  // acc += x[acc & 7, col]
  CARRIES = 9,      // param carries, each + 1 a step; optional sweep
};

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

template <int V, int OPS>
__global__ void __launch_bounds__(THREADS)
    loop_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tbl,
                int32_t* __restrict__ out, int64_t n, int steps,
                uint32_t wmask, uint32_t ones) {
  extern __shared__ int32_t tbl_s[];
  const int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if constexpr (V == GATHER_1D) {
    for (uint32_t r = threadIdx.x; r <= wmask; r += THREADS) tbl_s[r] = tbl[r];
    __syncthreads();
  }
  if (i >= n) return;
  const int64_t col = i & 127;
  const uint32_t xv = uint32_t(x[i]);
  if constexpr (V == TRIVIAL) {
    out[i] = int32_t(xv * 2u);
    return;
  }
  uint32_t acc = ~ones;
  for (int s = 0; s < steps; ++s) {
    if constexpr (V == GATHER_TBL) {
      acc += uint32_t(tbl[int64_t((xv + acc) & wmask) * 128 + col]);
    } else if constexpr (V == GATHER_1D) {
      acc += uint32_t(tbl_s[(xv + acc) & wmask]);
    } else if constexpr (V == VPU) {
      acc += uint32_t(int32_t(xv * acc + 12345u) >> 3) & 7u;
    } else if constexpr (V == ADD) {
      acc += xv;
    } else if constexpr (V == XORADD) {
#pragma unroll
      for (int o = 0; o < OPS; ++o) acc = acc + (xv ^ acc);
    } else if constexpr (V == MUL) {
      acc = acc + xv * acc;
    } else if constexpr (V == SHIFT) {
      acc = uint32_t(int32_t(acc + xv) >> 1) | (acc << 1);
    } else if constexpr (V == GATHER_TILE) {
      acc += uint32_t(x[int64_t(acc & 7u) * 128 + col]);
    }
    acc &= ones;
  }
  out[i] = int32_t(acc);
}

// pallas_probe16.py make(nc, sweep_rows): carries c[k] = x + k; each step
// adds 1 to every carry; with a sweep, c[0] += buf[c[0] % sweep] & 1, buf a
// zero-filled scratch of sweep rows (shared memory, one column per thread).
template <int NC>
__global__ void __launch_bounds__(THREADS)
    carries_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   int64_t n, int steps, int sweep, uint32_t ones) {
  extern __shared__ int32_t buf[];
  for (int r = 0; r < sweep; ++r) buf[r * THREADS + threadIdx.x] = 0;
  const int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t xv = uint32_t(x[i]);
  uint32_t c[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) c[k] = xv + uint32_t(k);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = (c[k] + 1u) & ones;
    if (sweep) {
      const int row = floor_mod(int32_t(c[0]), sweep);
      c[0] += uint32_t(buf[row * THREADS + threadIdx.x]) & 1u;
    }
  }
  uint32_t res = c[0];
  if (ones == 0) {
#pragma unroll
    for (int k = 1; k < NC; ++k) res ^= c[k];
  }
  out[i] = int32_t(res);
}

template <int V, int OPS>
void run(dim3 grid, size_t smem, cudaStream_t st, const int32_t* x,
         const int32_t* tbl, int32_t* out, int64_t n, int steps,
         uint32_t wmask) {
  loop_kernel<V, OPS><<<grid, THREADS, smem, st>>>(x, tbl, out, n, steps,
                                                    wmask, 0xffffffffu);
}

template <int NC>
void run_carries(dim3 grid, cudaStream_t st, const int32_t* x, int32_t* out,
                 int64_t n, int steps, int sweep) {
  carries_kernel<NC><<<grid, THREADS, size_t(sweep) * THREADS * 4, st>>>(
      x, out, n, steps, sweep, 0xffffffffu);
}

}  // namespace

// variant: one of the ids above; param: ops per step (XORADD: 1, 10, 50) or
// carries (CARRIES: 4, 40, 64); sweep: CARRIES' sweep rows (0..48); x: n
// int32 lanes of an (S, 128) array; tbl: the gather table (GATHER_TBL:
// (W, 128), GATHER_1D: (W,)); wmask = W - 1, W a power of two.
extern "C" int wg_probe_loop(int variant, int param, int sweep, const void* x_,
                             const void* tbl_, void* out_, int64_t n,
                             int steps, int wmask, void* stream) {
  if (n <= 0 || steps < 0) return int(cudaErrorInvalidValue);
  const auto* x = static_cast<const int32_t*>(x_);
  const auto* tbl = static_cast<const int32_t*>(tbl_);
  auto* out = static_cast<int32_t*>(out_);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(unsigned((n + THREADS - 1) / THREADS));
  const uint32_t wm = uint32_t(wmask);
  switch (variant) {
    case TRIVIAL: run<TRIVIAL, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case GATHER_TBL: run<GATHER_TBL, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case GATHER_1D:
      if (wm >= 12288) return int(cudaErrorInvalidValue);
      run<GATHER_1D, 1>(grid, size_t(wm + 1) * 4, st, x, tbl, out, n, steps, wm);
      break;
    case VPU: run<VPU, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case ADD: run<ADD, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case XORADD:
      switch (param) {
        case 1: run<XORADD, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
        case 10: run<XORADD, 10>(grid, 0, st, x, tbl, out, n, steps, wm); break;
        case 50: run<XORADD, 50>(grid, 0, st, x, tbl, out, n, steps, wm); break;
        default: return int(cudaErrorInvalidValue);
      }
      break;
    case MUL: run<MUL, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case SHIFT: run<SHIFT, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case GATHER_TILE: run<GATHER_TILE, 1>(grid, 0, st, x, tbl, out, n, steps, wm); break;
    case CARRIES:
      if (sweep < 0 || sweep > 48) return int(cudaErrorInvalidValue);
      switch (param) {
        case 4: run_carries<4>(grid, st, x, out, n, steps, sweep); break;
        case 40: run_carries<40>(grid, st, x, out, n, steps, sweep); break;
        case 64: run_carries<64>(grid, st, x, out, n, steps, sweep); break;
        default: return int(cudaErrorInvalidValue);
      }
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
