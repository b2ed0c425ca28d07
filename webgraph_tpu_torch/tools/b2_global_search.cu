// compact_runs in its earlier design, kept buildable for tools/b2_sweep.py
// to time beside the kernel the port launches (csrc/compact.cu).  Same
// function and C entry; the port never loads this file.
//
// One block per output tile of TILE arcs; consecutive threads take
// consecutive output positions.  A thread finds each position's run by a
// binary search in device memory over the runs that the tile spans (the
// planner's tile_run0 bracket), then makes one 4-byte read and one 4-byte
// write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void compact_runs_kernel(const int32_t* __restrict__ store,
                                    int32_t* __restrict__ csr, int64_t m,
                                    const int64_t* __restrict__ arc_start,
                                    const int64_t* __restrict__ src0,
                                    const uint8_t* __restrict__ valid,
                                    const int64_t* __restrict__ tile_run0,
                                    int64_t tile) {
  const int64_t b = blockIdx.x;
  const int64_t t0 = b * tile;
  const int64_t t1 = t0 + tile < m ? t0 + tile : m;
  const int64_t lo0 = tile_run0[b];
  const int64_t hi0 = tile_run0[b + 1];
  for (int64_t p = t0 + threadIdx.x; p < t1; p += THREADS) {
    // largest r in [lo0, hi0] with arc_start[r] <= p
    int64_t lo = lo0, hi = hi0;
    while (lo < hi) {
      int64_t mid = (lo + hi + 1) >> 1;
      if (arc_start[mid] <= p)
        lo = mid;
      else
        hi = mid - 1;
    }
    if (valid[lo]) csr[p] = store[src0[lo] + (p - arc_start[lo])];
  }
}

}  // namespace

extern "C" int wg_compact_runs(const void* store, int64_t store_n, void* csr,
                               int64_t m, const void* arc_start,
                               const void* src0, const void* valid,
                               const void* tile_run0, int64_t n_tiles,
                               int64_t tile, void* stream) {
  (void)store_n;
  if (m > 0 && n_tiles > 0) {
    compact_runs_kernel<<<dim3(unsigned(n_tiles)), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)store, (int32_t*)csr, m, (const int64_t*)arc_start,
        (const int64_t*)src0, (const uint8_t*)valid,
        (const int64_t*)tile_run0, tile);
  }
  return int(cudaGetLastError());
}
