// bv_decode_lanes: BVGraph decode, one thread per lane (a chunk of
// consecutive nodes).
//
// Replaces: the Pallas lane-per-chunk decode kernel of the JAX package
// (webgraph_tpu/ops/kdecode.py, _make_kernel, launched by _run_tile).
//
// What bounds it on this card: the per-node state machine is branchy integer
// work with data-dependent control flow, so the warps diverge and the kernel
// is bound by instruction throughput and by the latency of its scattered
// loads (three stream words per code read, one store word per copied
// successor), not by bandwidth: the stream is ~2 bits per arc and the store
// 4 bytes per arc.  Measured on an H100 (700 W): 57.7 ms for 355M arcs over
// 2^20 lanes, a few tens of GB/s of traffic.
//
// What the design does about it: nothing clever yet.  The TPU kernel swept
// every per-lane read as a masked compare-sum over VMEM because Mosaic could
// not lower gathers; here every read is an indexed load.  All lanes share one
// copy of the packed stream and read a code at any bit position directly
// (no per-lane columns, no refill buffer), the lane's store segment is sized
// exactly from the known outdegrees (no column cap, no hub split), and
// blocks and intervals are re-read lazily from saved bit cursors instead of
// being held in scratch (no BMAX/IMAX cap: E_BLK_OVF and E_INT_OVF are never
// set).  Cost-balanced chunking in the planner keeps the slowest lane short.
// One loop iteration is one state-machine step, exactly as the plain PyTorch
// twin (ops/kdecode.py, decode_lanes_plain) steps its lanes, so the two give
// the same store and the same diagnostics, STEPS included.
//
// A step either commits all its effects or, when it raises an error bit,
// none of them: the lane then stops with ERR set and WCUR/NODES describing
// the last committed step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// states (the values of the JAX kernel's ST_*)
constexpr int ST_DONE = 0, ST_OUTD = 1, ST_REF = 2, ST_BC = 3, ST_BLK = 4,
              ST_ICNT = 5, ST_ILEFT = 6, ST_ILEN = 7, ST_RESF = 8,
              ST_EMIT = 9;
// code kinds (CompressionFlags)
constexpr int K_DELTA = 1, K_GAMMA = 2, K_UNARY = 5, K_ZETA = 6;
// error bits (E_*)
constexpr uint32_t E_UNARY = 1, E_WIDTH = 2, E_COUNT = 16, E_WCUR = 32;
constexpr int DIAG_ROWS = 4;
constexpr int64_t INF = int64_t(1) << 62;
constexpr int MAXCYC = 8;

struct Stream {
  const uint32_t* w;
  int64_t nw;  // words readable; beyond reads as zero

  __device__ __forceinline__ uint64_t word(int64_t i) const {
    return i < nw ? uint64_t(w[i]) : 0ull;
  }
  // the 64 stream bits starting at bit pos, MSB first
  __device__ __forceinline__ uint64_t top64(int64_t pos) const {
    int64_t i = pos >> 5;
    int r = int(pos & 31);
    uint64_t v = (word(i) << 32) | word(i + 1);
    if (r) v = (v << r) | (word(i + 2) >> (32 - r));
    return v;
  }
  // nb (0..32) bits at bit pos
  __device__ __forceinline__ int64_t bits(int64_t pos, int nb) const {
    return nb > 0 ? int64_t(top64(pos) >> (64 - nb)) : 0;
  }
  // one instantaneous code at *pos; advances *pos, ORs error bits into *e
  __device__ int64_t read(int64_t* pos, int kind, int zk, uint32_t* e) const {
    int64_t p = *pos;
    uint64_t t = top64(p);
    if (t == 0) {
      *e |= E_UNARY;
      return 0;
    }
    int u = __clzll((long long)t);
    int64_t v = 0, adv = 0;
    if (kind == K_UNARY) {
      v = u;
      adv = u + 1;
    } else if (kind == K_GAMMA || kind == K_DELTA) {
      if (u > 31) {
        *e |= E_WIDTH;
        return 0;
      }
      int64_t g = ((int64_t(1) << u) | bits(p + u + 1, u)) - 1;
      adv = 2 * u + 1;
      if (kind == K_GAMMA) {
        v = g;
      } else {
        if (g > 31) {
          *e |= E_WIDTH;
          return 0;
        }
        int eb = int(g);
        v = ((int64_t(1) << eb) | bits(p + adv, eb)) - 1;
        adv += eb;
      }
    } else if (kind == K_ZETA) {
      int64_t l1 = int64_t(u) * zk + (zk - 1);
      if (l1 > 32) {
        *e |= E_WIDTH;
        return 0;
      }
      int64_t m = bits(p + u + 1, int(l1));
      int64_t left = int64_t(1) << (u * zk);
      if (m < left) {
        v = m + left - 1;
        adv = u + 1 + l1;
      } else {
        v = (m << 1) + bits(p + u + 1 + l1, 1) - 1;
        adv = u + 2 + l1;
      }
    }
    *pos = p + adv;
    return v;
  }
};

__device__ __forceinline__ int64_t nat2int(int64_t v) {
  return (v >> 1) ^ -(v & 1);
}

__device__ __forceinline__ int64_t pmod(int64_t a, int64_t b) {
  int64_t r = a % b;
  return r < 0 ? r + b : r;
}

struct Spec {
  int W, minint, zk, k_outd, k_ref, k_bc, k_blk, k_res;
};

__global__ void bv_decode_lanes_kernel(const uint32_t* __restrict__ words,
                                       int64_t nwords,
                                       const int64_t* __restrict__ meta,
                                       int64_t nmeta, int64_t lanes,
                                       int32_t* store, int32_t* diag,
                                       Spec sp) {
  int64_t lane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const Stream S{words, nwords};
  const int64_t* mt = meta + lane * nmeta;
  const int CYC = sp.W + 1;
  const int64_t n_nodes = mt[0];
  int64_t pos = mt[1];
  int64_t x = mt[2];
  int64_t wcur = mt[3];
  const int64_t base = mt[4];
  const int64_t seg_len = mt[5];
  int64_t win_d[MAXCYC], win_row[MAXCYC];
  for (int s = 0; s < CYC; ++s) {
    win_d[s] = mt[6 + s];
    win_row[s] = mt[6 + CYC + s];
  }

  int st = n_nodes > 0 ? ST_OUTD : ST_DONE;
  uint32_t err = 0;
  int64_t steps = 0, node = 0, nrow = wcur;
  int64_t d = 0, ref = 0, ref_len = 0, ref_row = 0, cop = 0, extra = 0;
  int64_t bc = 0, blk_i = 0, blk_tot = 0, blk_cop = 0, blk0 = 0, cblk = 0;
  int64_t icnt = 0, i_idx = 0, iprev = 0, ileft = 0, ipos0 = 0, ipos = 0;
  int64_t e_rem = 0, c_rem = 0, c_idx = 0, krem = 0, bj = 0;
  int64_t iv = 0, ilen_rem = 0, i_next = 0, r_rem = 0, r_val = 0;

  // helpers that run only after a step's checks passed
  auto node_done = [&]() {
    int s = int(pmod(x, CYC));
    win_d[s] = d;
    win_row[s] = nrow;
    nrow = wcur;
    ++node;
    ++x;
    st = node >= n_nodes ? ST_DONE : ST_OUTD;
  };
  auto init_emit = [&](bool from_resf) {
    e_rem = d;
    if (!from_resf) r_rem = 0;
    if (ref > 0 && cop > 0) {
      c_rem = cop;
      c_idx = 0;
      bj = 0;
      krem = bc > 0 ? blk0 : INF;
    } else {
      c_rem = 0;
    }
    ilen_rem = 0;
    i_next = 0;
    ipos = ipos0;
    iprev = 0;
    st = ST_EMIT;
  };
  // cop/extra are final; extra >= 0 was checked
  auto setup = [&]() {
    icnt = 0;
    if (extra == 0)
      init_emit(false);
    else
      st = sp.minint ? ST_ICNT : ST_RESF;
  };

  while (st != ST_DONE) {
    ++steps;
    uint32_t e = 0;
    switch (st) {
      case ST_OUTD: {
        int64_t p = pos;
        int64_t v = S.read(&p, sp.k_outd, sp.zk, &e);
        if (e) break;
        pos = p;
        d = v;
        if (d == 0) {
          node_done();
        } else if (sp.W > 0) {
          st = ST_REF;
        } else {
          ref = 0;
          bc = 0;
          cop = 0;
          extra = d;
          setup();
        }
        break;
      }
      case ST_REF: {
        int64_t p = pos;
        int64_t v = S.read(&p, sp.k_ref, sp.zk, &e);
        if (e) break;
        pos = p;
        ref = v;
        if (ref > 0) {
          int s = int(pmod(x - ref, CYC));
          ref_len = win_d[s];
          ref_row = win_row[s];
          st = ST_BC;
        } else {
          bc = 0;
          cop = 0;
          extra = d;
          setup();
        }
        break;
      }
      case ST_BC: {
        int64_t p = pos;
        int64_t v = S.read(&p, sp.k_bc, sp.zk, &e);
        if (e) break;
        if (v == 0) {
          if (d - ref_len < 0) {
            e |= E_COUNT;
            break;
          }
          pos = p;
          bc = 0;
          cop = ref_len;
          extra = d - cop;
          setup();
        } else {
          pos = p;
          bc = v;
          blk_i = 0;
          blk_tot = 0;
          blk_cop = 0;
          st = ST_BLK;
        }
        break;
      }
      case ST_BLK: {
        int64_t p = pos;
        int64_t v = S.read(&p, sp.k_blk, sp.zk, &e);
        if (e) break;
        int64_t bval = blk_i == 0 ? v : v + 1;
        int64_t tot = blk_tot + bval;
        int64_t copc = blk_cop + ((blk_i & 1) == 0 ? bval : 0);
        int64_t bi = blk_i + 1;
        int64_t cop_n = 0;
        if (bi == bc) {
          cop_n = copc + ((bc & 1) == 0 ? ref_len - tot : 0);
          if (tot > ref_len || d - cop_n < 0) {
            e |= E_COUNT;
            break;
          }
        }
        pos = p;
        if (blk_i == 0) {
          blk0 = bval;
          cblk = p;
        }
        blk_tot = tot;
        blk_cop = copc;
        blk_i = bi;
        if (bi == bc) {
          cop = cop_n;
          extra = d - cop;
          setup();
        }
        break;
      }
      case ST_ICNT: {
        int64_t p = pos;
        int64_t v = S.read(&p, K_GAMMA, sp.zk, &e);
        if (e) break;
        pos = p;
        icnt = v;
        i_idx = 0;
        iprev = 0;
        ipos0 = p;
        st = icnt > 0 ? ST_ILEFT : ST_RESF;
        break;
      }
      case ST_ILEFT: {
        int64_t p = pos;
        int64_t v = S.read(&p, K_GAMMA, sp.zk, &e);
        if (e) break;
        pos = p;
        ileft = i_idx == 0 ? nat2int(v) + x : v + iprev + 1;
        st = ST_ILEN;
        break;
      }
      case ST_ILEN: {
        int64_t p = pos;
        int64_t v = S.read(&p, K_GAMMA, sp.zk, &e);
        if (e) break;
        int64_t ln = v + sp.minint;
        if (extra - ln < 0) {
          e |= E_COUNT;
          break;
        }
        pos = p;
        iprev = ileft + ln;
        extra -= ln;
        ++i_idx;
        if (i_idx == icnt) {
          if (extra > 0)
            st = ST_RESF;
          else
            init_emit(false);
        } else {
          st = ST_ILEFT;
        }
        break;
      }
      case ST_RESF: {
        int64_t p = pos;
        int64_t v = S.read(&p, sp.k_res, sp.zk, &e);
        if (e) break;
        pos = p;
        r_val = nat2int(v) + x;
        r_rem = extra;
        init_emit(true);
        break;
      }
      case ST_EMIT: {
        if (c_rem > 0 && krem == 0) {
          // copy stream: skip run + next keep run, re-read from the blocks
          int64_t p = cblk;
          int64_t v1 = S.read(&p, sp.k_blk, sp.zk, &e);
          bool more = bj + 2 < bc;
          int64_t v2 = 0;
          if (more) v2 = S.read(&p, sp.k_blk, sp.zk, &e);
          if (e) break;
          c_idx += v1 + 1;
          krem = more ? v2 + 1 : INF;
          bj += 2;
          cblk = p;
        } else if (ilen_rem == 0 && i_next < icnt) {
          // interval stream: next (left, length), re-read from the stream
          int64_t p = ipos;
          int64_t v1 = S.read(&p, K_GAMMA, sp.zk, &e);
          int64_t v2 = S.read(&p, K_GAMMA, sp.zk, &e);
          if (e) break;
          int64_t left = i_next == 0 ? nat2int(v1) + x : v1 + iprev + 1;
          iv = left;
          ilen_rem = v2 + sp.minint;
          iprev = left + ilen_rem;
          ++i_next;
          ipos = p;
        } else {
          int64_t cval = INF;
          if (c_rem > 0) {
            int64_t r = ref_row + c_idx;
            if (r < 0 || r >= nrow) {
              e |= E_COUNT;
              break;
            }
            cval = store[base + r];
          }
          int64_t ival = ilen_rem > 0 ? iv : INF;
          int64_t rv = r_rem > 0 ? r_val : INF;
          int win;
          int64_t val;
          if (cval <= ival && cval <= rv) {
            win = 0;
            val = cval;
          } else if (ival <= rv) {
            win = 1;
            val = ival;
          } else {
            win = 2;
            val = rv;
          }
          if (val == INF) {
            e |= E_COUNT;
            break;
          }
          if (wcur >= seg_len) {
            e |= E_WCUR;
            break;
          }
          int64_t p = pos, gap = 0;
          if (win == 2 && r_rem > 1) gap = S.read(&p, sp.k_res, sp.zk, &e);
          if (e) break;
          bool done = e_rem == 1;
          if (done && (c_rem - (win == 0) != 0 || ilen_rem - (win == 1) != 0 ||
                       i_next != icnt || r_rem - (win == 2) != 0)) {
            e |= E_COUNT;
            break;
          }
          store[base + wcur] = int32_t(val);
          ++wcur;
          --e_rem;
          if (win == 0) {
            --c_rem;
            ++c_idx;
            --krem;
          } else if (win == 1) {
            ++iv;
            --ilen_rem;
          } else {
            --r_rem;
            if (r_rem > 0) {
              r_val += gap + 1;
              pos = p;
            }
          }
          if (done) node_done();
        }
        break;
      }
    }
    if (e) {
      err |= e;
      break;
    }
  }
  int32_t* dg = diag + lane * DIAG_ROWS;
  dg[0] = int32_t(err);
  dg[1] = int32_t(wcur);
  dg[2] = int32_t(node);
  dg[3] = int32_t(steps);
}

}  // namespace

extern "C" int wg_bv_decode_lanes(const void* words, int64_t nwords,
                                  const void* meta, int64_t nmeta,
                                  int64_t lanes, void* store, void* diag,
                                  int W, int minint, int zk, int k_outd,
                                  int k_ref, int k_bc, int k_blk, int k_res,
                                  void* stream) {
  if (lanes > 0) {
    Spec sp{W, minint, zk, k_outd, k_ref, k_bc, k_blk, k_res};
    const int threads = 128;
    const int64_t blocks = (lanes + threads - 1) / threads;
    bv_decode_lanes_kernel<<<dim3(unsigned(blocks)), threads, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int64_t*)meta, nmeta, lanes,
        (int32_t*)store, (int32_t*)diag, sp);
  }
  return int(cudaGetLastError());
}
