// probe_prims.cu: the primitives the decode kernel is built from.
//
// Replaces the Pallas probe kernels of the JAX package's
// experiments/pallas_probe5.py: the six bodies launched by simple (t_clz,
// t_varshift, t_while, t_dyngather_u32, t_scratch_dyn, t_u32_cmp_mix) and
// t_dma_dynoffset.
//
// One (8, 128) tile of 1,024 lanes is one block of 1,024 threads, one lane a
// thread.  t_while's condition, max(acc) < 1000 over the tile, is a
// block-wide vote each step (__syncthreads_and): lanes that have passed 1000
// keep stepping until every lane of the tile has.
//
// t_dma_dynoffset copies, each step, the rows [off, off + 4) of a (T, 8, 128)
// array in device memory into shared memory, off = (7 i) % (T - 4) from the
// step index, and reads two of the four tiles.  On the TPU that is an async
// copy on a DMA semaphore; here it is one bulk copy by the Tensor Memory
// Accelerator (cp.async.bulk, 16 KB, every slab start 4096-byte aligned),
// completing on an mbarrier that every thread waits on.
//
// What bounds it on this card: one block on one SM, so launch latency and,
// in the copy probe, the round trip of one bulk copy per step.  The probes
// ask whether the primitives work and what a copy's round trip costs, not
// for throughput.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 1024;  // lanes of one (8, 128) tile
constexpr int SCRATCH_TILES = 16;
constexpr int DMA_ROWS = 4;
constexpr uint32_t DMA_BYTES = DMA_ROWS * L * 4;

// variant ids: webgraph_tpu_torch/experiments/probe5.py
enum {
  CLZ = 0,
  VARSHIFT = 1,
  WHILE_MAX = 2,
  DYNGATHER = 3,
  SCRATCH_DYN = 4,
  U32_CMP_MIX = 5,
  DMA = 6,
};

template <int V>
__global__ void __launch_bounds__(L)
    simple_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  int32_t* __restrict__ out) {
  const int t = threadIdx.x;
  const uint32_t av = uint32_t(a[t]);
  if constexpr (V == CLZ) {
    out[t] = __clz(int32_t(av));
  } else if constexpr (V == VARSHIFT) {
    const uint32_t s = uint32_t(b[t]);  // 0..14: both shifts stay below 32
    out[t] = int32_t((av << s) | (av >> (s + 1)));
  } else if constexpr (V == WHILE_MAX) {
    uint32_t acc = av, i = 0;
    while (__syncthreads_and(int32_t(acc) < 1000)) {
      acc += av;
      ++i;
    }
    out[t] = int32_t(acc + i);
  } else if constexpr (V == DYNGATHER) {
    // out[r, c] = a[idx[r, c], c]; rows outside the tile read 0
    const int r = b[t];
    out[t] = (unsigned)r < 8u ? a[r * 128 + (t & 127)] : 0;
  } else if constexpr (V == SCRATCH_DYN) {
    extern __shared__ int32_t scr[];  // SCRATCH_TILES tiles, 64 KB
    for (int i = 0; i < SCRATCH_TILES; ++i) scr[i * L + t] = int32_t(av + i);
    uint32_t acc = 0;
    for (int i = 0; i < SCRATCH_TILES; ++i) acc += uint32_t(scr[i * L + t]);
    out[t] = int32_t(acc);
  } else if constexpr (V == U32_CMP_MIX) {
    const uint32_t bv = uint32_t(b[t]);
    out[t] = av < bv ? int32_t(av >> 3) : -int32_t(bv & 7u);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__global__ void __launch_bounds__(L)
    dma_kernel(const int32_t* __restrict__ hbm, int32_t* __restrict__ out,
               int rows, int steps) {
  __shared__ __align__(128) int32_t scr[DMA_ROWS * L];
  __shared__ __align__(8) uint64_t bar;
  const int t = threadIdx.x;
  const uint32_t bar_a = smem_addr(&bar);
  const uint32_t scr_a = smem_addr(scr);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t acc = 0;
  for (int i = 0; i < steps; ++i) {
    if (t == 0) {
      const int64_t off = (int64_t(i) * 7) % (rows - DMA_ROWS);
      const int32_t* src = hbm + off * L;
      // the last step's reads of scr (generic proxy) come before this
      // step's bulk write into it (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar_a),
          "r"(DMA_BYTES)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(scr_a),
          "l"(src), "r"(DMA_BYTES), "r"(bar_a)
          : "memory");
    }
    mbar_wait(bar_a, uint32_t(i & 1));
    acc += uint32_t(scr[t]) + uint32_t(scr[3 * L + t]);
    __syncthreads();  // every lane has read scr before the next copy lands
  }
  out[t] = int32_t(acc);
}

template <int V>
int run_simple(const int32_t* a, const int32_t* b, int32_t* out,
               cudaStream_t st) {
  size_t smem = 0;
  if constexpr (V == SCRATCH_DYN) {
    smem = size_t(SCRATCH_TILES) * L * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        simple_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  simple_kernel<V><<<1, L, smem, st>>>(a, b, out);
  return 0;
}

}  // namespace

// variant: one of the ids above.  a, b, out: (8, 128) int32 tiles (b unused
// by CLZ, WHILE_MAX and SCRATCH_DYN); DMA: a is (rows, 8, 128) in device
// memory, rows > 4, and the loop runs `steps` copies (the probe: 8).
extern "C" int wg_probe_prims(int variant, const void* a_, const void* b_,
                              void* out_, int rows, int steps, void* stream) {
  const auto* a = static_cast<const int32_t*>(a_);
  const auto* b = static_cast<const int32_t*>(b_);
  auto* out = static_cast<int32_t*>(out_);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  switch (variant) {
    case CLZ: rc = run_simple<CLZ>(a, b, out, st); break;
    case VARSHIFT: rc = run_simple<VARSHIFT>(a, b, out, st); break;
    case WHILE_MAX: rc = run_simple<WHILE_MAX>(a, b, out, st); break;
    case DYNGATHER: rc = run_simple<DYNGATHER>(a, b, out, st); break;
    case SCRATCH_DYN: rc = run_simple<SCRATCH_DYN>(a, b, out, st); break;
    case U32_CMP_MIX: rc = run_simple<U32_CMP_MIX>(a, b, out, st); break;
    case DMA:
      if (rows <= DMA_ROWS || steps < 0) return int(cudaErrorInvalidValue);
      dma_kernel<<<1, L, 0, st>>>(a, out, rows, steps);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return int(cudaGetLastError());
}
