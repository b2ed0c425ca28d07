// bv_decode_lanes: BVGraph decode, one thread per lane (a chunk of
// consecutive nodes).
//
// Replaces: the Pallas lane-per-chunk decode kernel of the JAX package
// (webgraph_tpu/ops/kdecode.py, _make_kernel, launched by _run_tile).
//
// What bounds it on this card: instruction issue across diverging lanes.
// The bytes it must move (the ~2.2-bit-per-arc stream, the lane table, the
// halo rows read and 4 bytes a successor written) take 0.57 ms at
// 3.35 TB/s for the uk-2002-scale slice (355M arcs, 2^20 lanes); each lane
// is a sequential decoder, a chain of dependent integer steps, and a warp's
// 32 lanes are at different places of their streams.  The first design (one
// 9-way state-machine arm a step, three scattered stream words loaded per
// code, 64-bit state, the window in local memory) took 58 ms.  This one
// takes ~14 ms on an H100 80GB HBM3 at 700 W (PERF.md, kernel table), ~4% of
// its bound: issue, not bytes, still bounds it.
//
// What the design does about it:
//  * Each code is decoded from a 64-bit bit buffer in registers with one
//    clz and shifts; a word is loaded only when fewer than 32 bits are left,
//    and the next word is always already in flight.  Copy blocks and
//    intervals, re-read while emitting, have readers of their own.
//  * One loop iteration is one step of the state machine, and every lane
//    reads its step's code (a header code or a residual gap) at one place in
//    the loop, so the lanes of a warp decode together whatever step each is
//    at; only the small per-state bookkeeping diverges.  (A node-at-a-time
//    form with straight-line headers and tight emit loops measured no faster:
//    its lanes diverge across whole header and emit blocks.)
//  * The sources of the next four copied successors are loaded ahead.
//  * The emit state is 32-bit (counts saturate where no node can reach
//    them); the window lives in shared memory: no stack frame, no spills.
//  * Threads take the lanes costliest first (LanePlan.order): the long lanes
//    start in the first wave, and a warp's lanes cost about the same, where
//    in plan order a warp waits for its costliest lane (a hub among short
//    ones).  This alone took the kernel from ~19 to ~14 ms.
//
// The lane's results are those of the JAX kernel's state machine, stepped
// one step per code read or arc written, as the plain PyTorch twin
// (ops/kdecode.py, decode_lanes_plain) steps its lanes: the same store, and
// the same diagnostics, STEPS (the number of such steps) included.  A step
// that raises an error bit commits nothing: the lane stops with ERR set and
// WCUR/NODES describing the last committed step.  The wrapper guarantees
// what makes the 32-bit fields exact: node ids below 2^31, segments and
// window entries below 2^30.

// WG_HOST_BUILD compiles the kernel body as plain C++ with a header that
// defines the CUDA qualifiers away (tests/test_torch_kdecode_host.py), so
// the CPU tests run this very code against the plain twin.
#ifndef WG_HOST_BUILD
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

// code kinds (CompressionFlags)
constexpr int K_DELTA = 1, K_GAMMA = 2, K_UNARY = 5, K_ZETA = 6;
// error bits (E_*)
constexpr uint32_t E_UNARY = 1, E_WIDTH = 2, E_COUNT = 16, E_WCUR = 32;
constexpr int DIAG_ROWS = 4;
constexpr int64_t INF = int64_t(1) << 62;
constexpr int MAXCYC = 8;
constexpr int32_t CAP = 0x7fffffff;

__device__ __forceinline__ int32_t sat(int64_t v) {  // v >= 0
  return v < CAP ? int32_t(v) : CAP;
}
// Threads a block; tools/b1_sweep.py builds other values.  On the H100, 128
// measured best (64 the same, 256 1.5% slower); bounding the registers to
// 64 (8 blocks an SM) spilled and took 2.3x as long.
#ifndef WG_B1_THREADS
#define WG_B1_THREADS 128
#endif
#ifndef WG_B1_SPLIT
#define WG_B1_SPLIT 0
#endif
constexpr int THREADS = WG_B1_THREADS;

__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int64_t nw,
                                            int64_t i) {
  return i < nw ? __ldg(w + i) : 0u;
}

// One instantaneous code at absolute bit position *pos, reading three
// stream words per part: the reader's path when its buffer holds no set bit
// (a unary run of 32 bits or more), and the definition of every result.
__device__ __forceinline__ int64_t read_at(const uint32_t* w, int64_t nw,
                                           int64_t* pos, int kind, int zk,
                                           uint32_t* e) {
  auto top64 = [&](int64_t p) {
    int64_t i = p >> 5;
    int r = int(p & 31);
    uint64_t v = (uint64_t(word_at(w, nw, i)) << 32) | word_at(w, nw, i + 1);
    if (r) v = (v << r) | (word_at(w, nw, i + 2) >> (32 - r));
    return v;
  };
  auto bits = [&](int64_t p, int nb) {
    return nb > 0 ? int64_t(top64(p) >> (64 - nb)) : int64_t(0);
  };
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

// The stream from bit position pos() on: its next n bits (32..64 after a
// fill) MSB-first at the top of buf, zeros below; nxt is word wi, loaded
// ahead of its use.
struct Reader {
  const uint32_t* w;
  int64_t nw;
  uint64_t buf;
  int n;
  int64_t wi;
  uint32_t nxt;

  __device__ __forceinline__ void seek(int64_t pos) {
    wi = pos >> 5;
    int r = int(pos & 31);
    buf = ((uint64_t(word_at(w, nw, wi)) << 32) | word_at(w, nw, wi + 1))
          << r;
    n = 64 - r;
    wi += 2;
    nxt = word_at(w, nw, wi);
  }
  __device__ __forceinline__ int64_t pos() const { return wi * 32 - n; }
  __device__ __forceinline__ void fill() {
    if (n <= 32) {
      buf |= uint64_t(nxt) << (32 - n);
      n += 32;
      nxt = word_at(w, nw, ++wi);
    }
  }
  // the next nb (0..32 <= n) bits
  __device__ __forceinline__ uint32_t take(int nb) {
    uint32_t v = uint32_t((buf >> 32) >> (32 - nb));
    buf <<= nb;
    n -= nb;
    return v;
  }
  // one code of `kind`; false (error bits in *e) on a bad code
  __device__ __forceinline__ bool read(int kind, int zk, int64_t* out,
                                       uint32_t* e) {
    fill();
    if (buf == 0) {
      int64_t p = pos();
      uint32_t ee = 0;
      int64_t v = read_at(w, nw, &p, kind, zk, &ee);
      if (ee) {
        *e |= ee;
        return false;
      }
      seek(p);
      *out = v;
      return true;
    }
    int u = __clzll((long long)buf);  // u < n
    if (kind == K_UNARY) {
      buf = (buf << u) << 1;
      n -= u + 1;
      *out = u;
      return true;
    }
    if (kind == K_ZETA) {
      int l1 = u * zk + (zk - 1);
      if (l1 > 32) {
        *e |= E_WIDTH;
        return false;
      }
      buf <<= u + 1;  // u <= 32
      n -= u + 1;
      fill();
      uint64_t m = take(l1);
      uint64_t left = uint64_t(1) << (u * zk);
      if (m < left) {
        *out = int64_t(m + left - 1);
      } else {
        fill();
        *out = int64_t((m << 1) + take(1)) - 1;
      }
      return true;
    }
    // gamma, delta
    if (u > 31) {
      *e |= E_WIDTH;
      return false;
    }
    buf <<= u + 1;
    n -= u + 1;
    fill();
    uint32_t g = ((1u << u) | take(u)) - 1u;
    if (kind == K_GAMMA) {
      *out = g;
      return true;
    }
    if (g > 31) {
      *e |= E_WIDTH;
      return false;
    }
    fill();
    *out = int64_t(((1u << g) | take(int(g))) - 1u);
    return true;
  }
};

__device__ __forceinline__ int64_t nat2int(int64_t v) {
  return (v >> 1) ^ -(v & 1);
}

struct Spec {
  int W, minint, zk, k_outd, k_ref, k_bc, k_blk, k_res;
};

// the states of a lane (the values of the JAX kernel's ST_*)
constexpr int ST_DONE = 0, ST_OUTD = 1, ST_REF = 2, ST_BC = 3, ST_BLK = 4,
              ST_ICNT = 5, ST_ILEFT = 6, ST_ILEN = 7, ST_RESF = 8,
              ST_EMIT = 9;

// WG_B1_SPLIT builds the kernel with the preset lanes of split lists
// (LanePlan.split) as bv_decode_lanes_split_kernel (bv_decode_split.cu);
// without it the preprocessed kernel is the one without that code, which a
// plan with no preset lane launches.
#if WG_B1_SPLIT
#define WG_B1_KERNEL bv_decode_lanes_split_kernel
#else
#define WG_B1_KERNEL bv_decode_lanes_kernel
#endif
__global__ void __launch_bounds__(THREADS)
    WG_B1_KERNEL(const uint32_t* __restrict__ words, int64_t nwords,
                           const int64_t* __restrict__ meta, int64_t nmeta,
                           int64_t lanes, int32_t* store, int32_t* diag,
                           const int32_t* __restrict__ order, Spec sp) {
  // the (W+1)-slot window of each thread: outdegree and first row of the
  // lists of its chunk's last W+1 nodes, keyed by global node id
  __shared__ int32_t s_wd[MAXCYC][THREADS];
  __shared__ int32_t s_wr[MAXCYC][THREADS];
  const int tid = threadIdx.x;
  const int64_t t = int64_t(blockIdx.x) * THREADS + tid;
  if (t >= lanes) return;
  const int64_t lane = order ? order[t] : t;
  const int64_t* mt = meta + lane * nmeta;
  const int CYC = sp.W + 1;
  const int32_t n_nodes = int32_t(mt[0]);
  int32_t x = int32_t(mt[2]);
  int32_t wcur = int32_t(mt[3]);
  int32_t* const seg = store + mt[4];
  const int32_t seg_len = int32_t(mt[5]);
  for (int s = 0; s < CYC; ++s) {
    s_wd[s][tid] = int32_t(mt[6 + s]);
    s_wr[s][tid] = int32_t(mt[6 + CYC + s]);
  }
  const int zk = sp.zk;
  // the code kind each header state reads, 3 bits a state
  const uint32_t kinds =
      (uint32_t(sp.k_outd) << 3 * ST_OUTD) | (uint32_t(sp.k_ref) << 3 * ST_REF) |
      (uint32_t(sp.k_bc) << 3 * ST_BC) | (uint32_t(sp.k_blk) << 3 * ST_BLK) |
      (uint32_t(K_GAMMA) << 3 * ST_ICNT) | (uint32_t(K_GAMMA) << 3 * ST_ILEFT) |
      (uint32_t(K_GAMMA) << 3 * ST_ILEN) | (uint32_t(sp.k_res) << 3 * ST_RESF);
  Reader R{words, nwords, 0, 0, 0, 0};   // headers and residuals
  Reader BR{words, nwords, 0, 0, 0, 0};  // copy blocks, re-read to emit
  Reader IR{words, nwords, 0, 0, 0, 0};  // intervals, re-read to emit
  R.seek(mt[1]);

  uint32_t err = 0, steps = 0;
  int32_t node = 0, nrow = wcur, ref_row = 0;
  int xs = x % CYC;  // x's window slot
  int st = n_nodes > 0 ? ST_OUTD : ST_DONE;
  int64_t d = 0, ref = 0, ref_len = 0, cop = 0, extra = 0, bc = 0;
  int64_t blk_i = 0, blk_tot = 0, blk_cop = 0, blk0 = 0, cblk = 0;
  int64_t icnt = 0, i_idx = 0, ipos0 = 0, bj = 0;
  // the emit state, 32-bit: counts saturate at CAP, which no count of a
  // node reaches before its segment overflows (E_WCUR), so every test on
  // them comes out as on the exact count; values stay 64-bit
  int32_t e_rem = 0, c_rem = 0, c_idx = 0, krem = 0, ilen_rem = 0;
  int32_t i_next = 0, icnt32 = 0, r_rem = 0;
  int64_t iv = 0, iprev = 0, r_val = 0;
  // the sources of the next four copied arcs (rows ref_row + c_idx ...),
  // loaded ahead; a row at or past nrow is never used (E_COUNT first)
  int32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#if WG_B1_SPLIT
  // a split list (meta's preset fields count, value): a preset lane
  // (count > 0) starts in the emit state with a run of `count` residuals
  // from the checkpoint `value`, its codes ending at bit pre_end (its start
  // bit plus window slot 0's outdegree), reading one code more (the next
  // run's head) where slot 0's row says the list goes on; the list's head
  // lane (count < 0) reads the header, copies and intervals, checks its
  // first residual code ends at bit `value`, leaves the -count residual
  // rows to the preset lanes (jump) and writes the rest after them
  int64_t skip = 0, skip_bit = 0, jump = 0, pre_end = -1;
  bool pre_more = false;
  {
    const int64_t pc = mt[6 + 2 * CYC], pv = mt[7 + 2 * CYC];
    if (pc > 0 && n_nodes > 0) {
      st = ST_EMIT;
      d = pc;
      e_rem = r_rem = sat(pc);
      r_val = pv;
      pre_end = mt[1] + mt[6];
      pre_more = mt[6 + CYC] != 0;
    } else if (pc < 0) {
      skip = -pc;
      skip_bit = pv;
    }
  }
#endif
  auto src = [&](int64_t r) { return r < nrow ? seg[r] : 0; };
  auto refill_copies = [&]() {
    const int64_t r = int64_t(ref_row) + c_idx;
    c0 = src(r);
    c1 = src(r + 1);
    c2 = src(r + 2);
    c3 = src(r + 3);
  };

  while (st != ST_DONE) {
    ++steps;
    int kind = 0;
    int win = 0;
    int64_t val = 0;
    if (st == ST_EMIT) {
      if (c_rem > 0 && krem == 0) {
        // copy stream: the next skip block and keep block
        int64_t v1, v2 = 0;
        const bool more = bj + 2 < bc;
        if (!BR.read(sp.k_blk, zk, &v1, &err)) break;
        if (more && !BR.read(sp.k_blk, zk, &v2, &err)) break;
        c_idx = sat(c_idx + v1 + 1);
        krem = more ? int32_t(v2 + 1) : CAP;
        bj += 2;
        refill_copies();
        continue;
      }
      if (ilen_rem == 0 && i_next < icnt32) {
        // interval stream: the next (left, length)
        int64_t v1, v2;
        if (!IR.read(K_GAMMA, zk, &v1, &err)) break;
        if (!IR.read(K_GAMMA, zk, &v2, &err)) break;
        const int64_t left = i_next == 0 ? nat2int(v1) + x : v1 + iprev + 1;
        iv = left;
        iprev = left + v2 + sp.minint;
        ilen_rem = sat(v2 + sp.minint);
        ++i_next;
        continue;
      }
      // one successor: the least head of the three streams
      int64_t cval = INF;
      if (c_rem > 0) {
        const int64_t r = int64_t(ref_row) + c_idx;
        if (r < 0 || r >= nrow) {
          err |= E_COUNT;
          break;
        }
        cval = c0;
      }
      const int64_t ival = ilen_rem > 0 ? iv : INF;
      const int64_t rv = r_rem > 0 ? r_val : INF;
      if (cval <= ival && cval <= rv) {
        val = cval;
      } else if (ival <= rv) {
        win = 1;
        val = ival;
      } else {
        win = 2;
        val = rv;
      }
      if (val == INF) {
        err |= E_COUNT;
        break;
      }
      if (wcur >= seg_len) {
        err |= E_WCUR;
        break;
      }
#if WG_B1_SPLIT
      if (win == 2 && (r_rem > 1 || pre_more)) kind = sp.k_res;
#else
      if (win == 2 && r_rem > 1) kind = sp.k_res;
#endif
    } else {
      kind = (kinds >> (3 * st)) & 7;
    }
    // the step's one code from the main stream, read by every lane at once
    int64_t v = 0;
    if (kind && !R.read(kind, zk, &v, &err)) break;

    bool setup = false, init = false, from_resf = false, node_fin = false;
    switch (st) {
      case ST_OUTD:
        d = v;
        if (d == 0) {
          node_fin = true;
        } else if (sp.W > 0) {
          st = ST_REF;
        } else {
          ref = bc = cop = 0;
          extra = d;
          setup = true;
        }
        break;
      case ST_REF:
        ref = v;
        if (ref > 0) {
          int s = xs - int(ref < CYC ? ref : ref % CYC);
          if (s < 0) s += CYC;
          ref_len = s_wd[s][tid];
          ref_row = s_wr[s][tid];
          st = ST_BC;
        } else {
          bc = cop = 0;
          extra = d;
          setup = true;
        }
        break;
      case ST_BC:
        if (v == 0) {
          if (d - ref_len < 0) {
            err |= E_COUNT;
            goto out;
          }
          bc = 0;
          cop = ref_len;
          extra = d - cop;
          setup = true;
        } else {
          bc = v;
          blk_i = blk_tot = blk_cop = 0;
          st = ST_BLK;
        }
        break;
      case ST_BLK: {
        const int64_t bval = blk_i == 0 ? v : v + 1;
        const int64_t tot = blk_tot + bval;
        const int64_t copc = blk_cop + ((blk_i & 1) == 0 ? bval : 0);
        const int64_t bi = blk_i + 1;
        int64_t cop_n = 0;
        if (bi == bc) {
          cop_n = copc + ((bc & 1) == 0 ? ref_len - tot : 0);
          if (tot > ref_len || d - cop_n < 0) {
            err |= E_COUNT;
            goto out;
          }
        }
        if (blk_i == 0) {
          blk0 = bval;
          cblk = R.pos();
        }
        blk_tot = tot;
        blk_cop = copc;
        blk_i = bi;
        if (bi == bc) {
          cop = cop_n;
          extra = d - cop;
          setup = true;
        }
        break;
      }
      case ST_ICNT:
        icnt = v;
        i_idx = 0;
        ipos0 = R.pos();
        st = icnt > 0 ? ST_ILEFT : ST_RESF;
        break;
      case ST_ILEFT:
        st = ST_ILEN;
        break;
      case ST_ILEN: {
        const int64_t ln = v + sp.minint;
        if (extra - ln < 0) {
          err |= E_COUNT;
          goto out;
        }
        extra -= ln;
        if (++i_idx == icnt) {
          if (extra > 0)
            st = ST_RESF;
          else
            init = true;
        } else {
          st = ST_ILEFT;
        }
        break;
      }
      case ST_RESF:
#if WG_B1_SPLIT
        if (skip) {
          if (extra != skip || R.pos() != skip_bit) {
            err |= E_COUNT;
            goto out;
          }
          if (skip > seg_len - wcur) {
            err |= E_WCUR;
            goto out;
          }
          wcur += int32_t(skip);
          jump = skip;
          skip = 0;
          if (d == jump)
            node_fin = true;
          else
            init = true;
          break;
        }
#endif
        r_val = nat2int(v) + x;
        r_rem = sat(extra);
        init = from_resf = true;
        break;
      default: {  // ST_EMIT, one successor
        const bool done = e_rem == 1;
#if WG_B1_SPLIT
        if (done && pre_end >= 0 && R.pos() != pre_end) {
          err |= E_COUNT;
          goto out;
        }
#endif
        if (done && (c_rem - (win == 0) != 0 || ilen_rem - (win == 1) != 0 ||
                     i_next != icnt32 || r_rem - (win == 2) != 0)) {
          err |= E_COUNT;
          goto out;
        }
        seg[wcur++] = int32_t(val);
        --e_rem;
        if (win == 0) {
          --c_rem;
          ++c_idx;
          --krem;
          c0 = c1;
          c1 = c2;
          c2 = c3;
          c3 = src(int64_t(ref_row) + c_idx + 3);
        } else if (win == 1) {
          ++iv;
          --ilen_rem;
        } else if (--r_rem > 0) {
          r_val += v + 1;
        }
        node_fin = done;
      }
    }
    if (setup) {
      icnt = 0;
      if (extra == 0)
        init = true;
      else
        st = sp.minint ? ST_ICNT : ST_RESF;
    }
    if (init) {
#if WG_B1_SPLIT
      if (skip) {  // a split list's head reached no residuals
        err |= E_COUNT;
        goto out;
      }
#endif
      e_rem = sat(d);
#if WG_B1_SPLIT
      e_rem = sat(d - jump);
#endif
      if (!from_resf) r_rem = 0;
      c_rem = ref > 0 && cop > 0 ? int32_t(cop) : 0;  // cop <= ref_len < 2^30
      icnt32 = sat(icnt);
      if (c_rem > 0) {
        c_idx = 0;
        bj = 0;
        krem = bc > 0 ? int32_t(blk0) : CAP;  // blk0 <= ref_len
        if (bc > 0) BR.seek(cblk);
        refill_copies();
      }
      ilen_rem = i_next = iprev = 0;
      if (icnt > 0) IR.seek(ipos0);
      st = ST_EMIT;
    }
    if (node_fin) {
      s_wd[xs][tid] = int32_t(d);
      s_wr[xs][tid] = nrow;
      nrow = wcur;
      ++node;
      ++x;
      if (++xs == CYC) xs = 0;
      st = node >= n_nodes ? ST_DONE : ST_OUTD;
    }
  }
out:
  int32_t* dg = diag + lane * DIAG_ROWS;
  dg[0] = int32_t(err);
  dg[1] = wcur;
  dg[2] = node;
  dg[3] = int32_t(steps);
}

#if !WG_B1_SPLIT
// The rows of a split list that has copies or intervals hold two ascending
// runs after B1: its residuals (the preset lanes') and then the rest (the
// head lane's copies and intervals, merged).  split_merge puts each value
// at its place in the list through tmp, one thread a row: a value's place
// is its index in its run plus the count of the other run's values before
// it, found by binary search; on a tie the head lane's value goes first, as
// B1's merge inside one lane puts copies and intervals before residuals.
// Phase 0 writes tmp, phase 1 copies tmp back into the store.  A run that
// is not ascending (a flagged list's) still gives every value a place in
// the list's rows.  tile[t / 256] is the list of row t / 256 * 256 (from
// the plan), where a row's search for its list starts.
__device__ __forceinline__ int64_t count_below(const int32_t* a, int64_t n,
                                               int64_t v, bool or_equal) {
  int64_t lo = 0;
  while (n > 0) {
    const int64_t h = n >> 1;
    const int64_t y = a[lo + h];
    if (or_equal ? y <= v : y < v) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

__global__ void split_merge_kernel(int32_t* store, int32_t* tmp,
                                   const int64_t* __restrict__ row0,
                                   const int64_t* __restrict__ res,
                                   const int64_t* __restrict__ base,
                                   const int32_t* __restrict__ tile,
                                   int64_t total, int phase) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    int64_t l = tile[t >> 8];  // then the last list with base[l] <= t
    while (base[l + 1] <= t) ++l;
    const int64_t k = t - base[l], r = res[l], d = base[l + 1] - base[l];
    int32_t* const row = store + row0[l];
    if (phase == 0) {
      const int64_t v = row[k];
      const int64_t at = k < r ? k + count_below(row + r, d - r, v, true)
                               : k - r + count_below(row, r, v, false);
      tmp[base[l] + at] = int32_t(v);
    } else {
      row[k] = tmp[t];
    }
  }
}
#endif  // !WG_B1_SPLIT

}  // namespace

#ifndef WG_HOST_BUILD
#if WG_B1_SPLIT
extern "C" int wg_bv_decode_lanes_split(
#else
extern "C" int wg_bv_decode_lanes(
#endif
    const void* words, int64_t nwords, const void* meta, int64_t nmeta,
    int64_t lanes, void* store, void* diag, const void* order, int W,
    int minint, int zk, int k_outd, int k_ref, int k_bc, int k_blk,
    int k_res, void* stream) {
  if (lanes > 0) {
    Spec sp{W, minint, zk, k_outd, k_ref, k_bc, k_blk, k_res};
    const int64_t blocks = (lanes + THREADS - 1) / THREADS;
    WG_B1_KERNEL<<<dim3(unsigned(blocks)), THREADS, 0,
                   (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int64_t*)meta, nmeta, lanes,
        (int32_t*)store, (int32_t*)diag, (const int32_t*)order, sp);
  }
  return int(cudaGetLastError());
}

#if !WG_B1_SPLIT
extern "C" int wg_split_merge(void* store, void* tmp, const void* row0,
                              const void* res, const void* base,
                              const void* tile, int64_t total,
                              void* stream) {
  if (total > 0) {
    int64_t blocks = (total + 255) / 256;
    if (blocks > (1 << 16)) blocks = 1 << 16;
    for (int phase = 0; phase < 2; ++phase)
      split_merge_kernel<<<dim3(unsigned(blocks)), 256, 0,
                           (cudaStream_t)stream>>>(
          (int32_t*)store, (int32_t*)tmp, (const int64_t*)row0,
          (const int64_t*)res, (const int64_t*)base, (const int32_t*)tile,
          total, phase);
  }
  return int(cudaGetLastError());
}
#endif  // !WG_B1_SPLIT
#endif  // WG_HOST_BUILD
