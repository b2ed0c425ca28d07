// Host library of the PyTorch / CUDA port: BVGraph bit-stream machinery.
//
// The port's own copy of the parts of the JAX package's host library
// (webgraph_tpu/native/wgnative.cpp) that the port, its smoke run and its
// tests call: offsets-index decode, outdegree scan, the full sequential
// decoder (the oracle the device CSR is held against), the range decoder
// behind the host fill of flagged lanes and the sliced scan, the
// header-only reference scan of cold plans, the parallel encoder and the
// streaming encoder of sequential sources.  MSB-first bit discipline; the
// encoder is byte-identical to the JAX package's (tests/test_torch_native.py).
// The port's own addition: the threaded decode of list-label streams
// (tests/test_torch_list_labels.py holds it against a per-arc reader).
//
// Built with g++ on first use by webgraph_tpu_torch/ops/_build.py
// (build_native); bound with ctypes in webgraph_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t len;       // bytes
    size_t pos;       // bit position

    // NOTE: callers must pad `data` with >= 16 readable zero bytes past
    // `len` (the ctypes binding does) so unaligned 64-bit loads are safe.
    explicit BitReader(const uint8_t* d, size_t l) : data(d), len(l), pos(0) {}

    inline uint64_t load64(size_t byte) const {
        uint64_t w;
        std::memcpy(&w, data + byte, 8);
        return __builtin_bswap64(w);
    }

    inline uint64_t read_bits(int n) {
        if (n == 0) return 0;
        size_t byte = pos >> 3;
        int o = pos & 7;
        unsigned __int128 acc =
            ((unsigned __int128)load64(byte) << 64) | load64(byte + 8);
        pos += n;
        return (uint64_t)(acc >> (128 - o - n))
               & ((n == 64) ? ~(uint64_t)0 : (((uint64_t)1 << n) - 1));
    }

    inline int64_t read_unary() {
        int64_t count = 0;
        size_t byte = pos >> 3;
        int o = pos & 7;
        uint64_t w = load64(byte) << o;
        if (w) {
            int z = __builtin_clzll(w);
            pos += z + 1;
            return z;
        }
        count = 64 - o;
        pos += count;
        for (;;) {
            if ((pos >> 3) >= len + 16) return count;  // corrupt stream guard
            w = load64(pos >> 3) << (pos & 7);
            if (w) {
                int z = __builtin_clzll(w);
                pos += z + 1;
                return count + z;
            }
            int adv = 64 - (int)(pos & 7);
            count += adv;
            pos += adv;
        }
    }

    inline int64_t read_gamma() {
        int64_t u = read_unary();
        if (u == 0) return 0;
        return (int64_t)(((uint64_t)1 << u) | read_bits((int)u)) - 1;
    }

    inline int64_t read_delta() {
        int64_t b = read_gamma();
        if (b == 0) return 0;
        return (int64_t)(((uint64_t)1 << b) | read_bits((int)b)) - 1;
    }

    inline int64_t read_zeta(int k) {
        int64_t h = read_unary();
        int64_t left = (int64_t)1 << (h * k);
        int64_t m = (int64_t)read_bits((int)(h * k + k - 1));
        if (m < left) return m + left - 1;
        return (m << 1) + (int64_t)read_bits(1) - 1;
    }

    inline int64_t read_minimal_binary(int64_t b) {
        int s = 63 - __builtin_clzll((uint64_t)b);
        int64_t mshort = ((int64_t)1 << (s + 1)) - b;
        int64_t v = (int64_t)read_bits(s);
        if (v < mshort) return v;
        return (v << 1) + (int64_t)read_bits(1) - mshort;
    }

    inline int64_t read_golomb(int64_t b) {
        if (b == 0) return 0;
        int64_t q = read_unary();
        return q * b + read_minimal_binary(b);
    }

    inline int64_t read_nibble() {
        int64_t acc = 0;
        for (;;) {
            uint64_t nib = read_bits(4);
            acc = (acc << 3) | (int64_t)(nib & 7);
            if (nib & 8) return acc;
        }
    }
};

inline int64_t nat2int(int64_t z) { return (int64_t)((uint64_t)z >> 1) ^ -(z & 1); }

// 3-way merge of three sorted, mutually disjoint runs (copied / interval /
// residual successors) — replaces the per-node std::sort on the hot path.
inline void merge3(std::vector<int64_t>& out, const std::vector<int64_t>& a,
                   const std::vector<int64_t>& b,
                   const std::vector<int64_t>& c) {
    size_t i = 0, j = 0, k = 0;
    const size_t na = a.size(), nb = b.size(), nc = c.size();
    out.resize(na + nb + nc);
    int64_t* o = out.data();
    while (i < na || j < nb || k < nc) {
        int64_t va = i < na ? a[i] : INT64_MAX;
        int64_t vb = j < nb ? b[j] : INT64_MAX;
        int64_t vc = k < nc ? c[k] : INT64_MAX;
        if (va <= vb && va <= vc) { *o++ = va; i++; }
        else if (vb <= vc) { *o++ = vb; j++; }
        else { *o++ = vc; k++; }
    }
}

constexpr int K_DELTA = 1, K_GAMMA = 2, K_GOLOMB = 3, K_UNARY = 5,
              K_ZETA = 6, K_NIBBLE = 7;

inline int64_t read_coded(BitReader& r, int coding, int zeta_k) {
    switch (coding) {
        case K_GAMMA: return r.read_gamma();
        case K_DELTA: return r.read_delta();
        case K_UNARY: return r.read_unary();
        case K_ZETA: return r.read_zeta(zeta_k);
        case K_GOLOMB: return r.read_golomb(zeta_k);
        case K_NIBBLE: return r.read_nibble();
        default: return -1;
    }
}

// ---------------------------------------------------------------------------
// Encoder: MSB-first bit writer + BVGraph differential compressor.
//
// Mirrors the golden-validated Python encoder (codecs/bvgraph.py _Encoder,
// itself a re-implementation of CompressionThread.call + diffComp,
// BVGraph.java:1977-2328): greedy reference selection over the window with a
// counting pass per candidate, strict improvement, first minimum wins.  A
// range encoder starts with a fresh window, mirroring the reference's
// per-thread splitNodeIterators semantics (BVGraph.java:2406-2415); range
// streams are concatenated bit-exactly (copyTo, BVGraph.java:2432-2483).
// ---------------------------------------------------------------------------

namespace {

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t buf = 0;  // MSB-first accumulator, fill bits valid
    int fill = 0;

    inline int64_t written_bits() const { return (int64_t)out.size() * 8 + fill; }

    inline void write_bits(uint64_t value, int n) {
        // n <= 57 so buf never overflows before flushing
        buf = (buf << n) | value;
        fill += n;
        while (fill >= 8) {
            fill -= 8;
            out.push_back((uint8_t)(buf >> fill));
        }
        buf &= ((uint64_t)1 << fill) - 1;
    }

    inline void write_bits_long(uint64_t value, int n) {
        if (n > 32) {
            write_bits(value >> 32, n - 32);
            write_bits(value & 0xffffffffu, 32);
        } else if (n > 0) {
            write_bits(value, n);
        }
    }

    inline void write_unary(int64_t x) {
        while (x >= 32) {
            write_bits(0, 32);
            x -= 32;
        }
        write_bits(1, (int)x + 1);
    }

    void flush() {
        if (fill) {
            out.push_back((uint8_t)(buf << (8 - fill)));
            buf = 0;
            fill = 0;
        }
    }
};

inline int msb64(uint64_t x) { return 63 - __builtin_clzll(x); }

inline int64_t len_unary(int64_t x) { return x + 1; }

inline int64_t len_gamma(int64_t x) {
    int b = msb64((uint64_t)x + 1);
    return 2 * b + 1;
}

inline int64_t len_delta(int64_t x) {
    int b = msb64((uint64_t)x + 1);
    return len_gamma(b) + b;
}

inline int64_t len_zeta(int64_t x, int k) {
    uint64_t z = (uint64_t)x + 1;
    int h = msb64(z) / k;
    uint64_t left = (uint64_t)1 << (h * k);
    return (h + 1) + ((z - left < left) ? h * k + k - 1 : h * k + k);
}

inline int64_t len_minimal_binary(int64_t x, int64_t b) {
    int s = msb64((uint64_t)b);
    int64_t m = ((int64_t)1 << (s + 1)) - b;
    return (x < m) ? s : s + 1;
}

inline int64_t len_golomb(int64_t x, int64_t b) {
    if (b == 0) return 0;
    return x / b + 1 + len_minimal_binary(x % b, b);
}

inline int64_t len_nibble(int64_t x) {
    if (x == 0) return 4;
    return 4 * ((int64_t)(msb64((uint64_t)x) / 3) + 1);
}

inline int64_t len_coded(int64_t x, int coding, int zeta_k) {
    switch (coding) {
        case K_GAMMA: return len_gamma(x);
        case K_DELTA: return len_delta(x);
        case K_UNARY: return len_unary(x);
        case K_ZETA: return len_zeta(x, zeta_k);
        case K_GOLOMB: return len_golomb(x, zeta_k);
        case K_NIBBLE: return len_nibble(x);
        default: return 1 << 30;
    }
}

inline void write_gamma(BitWriter& w, int64_t x) {
    uint64_t z = (uint64_t)x + 1;
    int b = msb64(z);
    w.write_unary(b);
    w.write_bits_long(z - ((uint64_t)1 << b), b);
}

inline void write_delta(BitWriter& w, int64_t x) {
    uint64_t z = (uint64_t)x + 1;
    int b = msb64(z);
    write_gamma(w, b);
    w.write_bits_long(z - ((uint64_t)1 << b), b);
}

inline void write_zeta(BitWriter& w, int64_t x, int k) {
    uint64_t z = (uint64_t)x + 1;
    int h = msb64(z) / k;
    uint64_t left = (uint64_t)1 << (h * k);
    w.write_unary(h);
    if (z - left < left)
        w.write_bits_long(z - left, h * k + k - 1);
    else
        w.write_bits_long(z, h * k + k);
}

inline void write_minimal_binary(BitWriter& w, int64_t x, int64_t b) {
    int s = msb64((uint64_t)b);
    int64_t m = ((int64_t)1 << (s + 1)) - b;
    if (x < m)
        w.write_bits_long((uint64_t)x, s);
    else
        w.write_bits_long((uint64_t)(x + m), s + 1);
}

inline void write_golomb(BitWriter& w, int64_t x, int64_t b) {
    if (b == 0) return;
    w.write_unary(x / b);
    write_minimal_binary(w, x % b, b);
}

inline void write_nibble(BitWriter& w, int64_t x) {
    if (x == 0) {
        w.write_bits(8, 4);
        return;
    }
    int h = msb64((uint64_t)x) / 3;
    while (h >= 0) {
        uint64_t g = ((uint64_t)x >> (h * 3)) & 7;
        w.write_bits(h == 0 ? (g | 8) : g, 4);
        h--;
    }
}

inline void write_coded(BitWriter& w, int64_t x, int coding, int zeta_k) {
    switch (coding) {
        case K_GAMMA: write_gamma(w, x); break;
        case K_DELTA: write_delta(w, x); break;
        case K_UNARY: w.write_unary(x); break;
        case K_ZETA: write_zeta(w, x, zeta_k); break;
        case K_GOLOMB: write_golomb(w, x, zeta_k); break;
        case K_NIBBLE: write_nibble(w, x); break;
    }
}

inline int64_t int2nat(int64_t x) { return (x << 1) ^ (x >> 63); }

// Stats layout (mirrors _Encoder fields; Python assembles .properties):
//  [0] copied_arcs [1] intervalised_arcs [2] residual_arcs
//  [3] tot_ref [4] tot_dist [5] bits_for_outdegrees [6] bits_for_references
//  [7] bits_for_blocks [8] bits_for_intervals [9] bits_for_residuals
//  [10..73] successor gap bins  [74..137] residual gap bins
constexpr int STAT_WORDS = 10 + 64 + 64;

struct EncSettings {
    int window_size, max_ref_count, min_interval_length, zeta_k;
    int c_out, c_ref, c_bcnt, c_blk, c_res;
};

struct Encoder {
    EncSettings s;
    // the window OWNS copies of the last window_size+1 lists, so callers
    // may stream slices through encode_node without keeping prior slices
    // alive (the basis of the wg_enc_* streaming API for > 2^31 graphs)
    std::vector<std::vector<int64_t>> window;
    std::vector<int64_t> window_len;
    std::vector<int> ref_count;
    std::vector<int64_t> blocks, extras;
    int64_t* st;  // stats

    Encoder(const EncSettings& es, int64_t* stats) : s(es), st(stats) {
        int cyclic = s.window_size + 1;
        window.assign((size_t)cyclic, {});
        window_len.assign((size_t)cyclic, 0);
        ref_count.assign((size_t)cyclic, 0);
    }

    void update_bins(int64_t curr_node, const int64_t* vals, int64_t len,
                     int64_t* bins) {
        for (int64_t i = 0; i + 1 < len; i++)
            bins[msb64((uint64_t)(vals[i + 1] - vals[i]))]++;
        int64_t z = int2nat(vals[0] - curr_node);
        if (z > 0) bins[msb64((uint64_t)z)]++;
        // z == 0: msb is -1, not binned (matches _Encoder._update_bins)
    }

    // Differential compression of curr vs ref candidate.  for_real=false is
    // the counting pass (returns the would-be size in bits).
    int64_t diff_comp(BitWriter* obs, int64_t curr_node, int64_t ref,
                      const int64_t* ref_list, int64_t ref_len,
                      const int64_t* curr_list, int64_t curr_len,
                      bool for_real) {
        int64_t bits = 0;
        if (ref == 0) ref_len = 0;

        blocks.clear();
        extras.clear();
        int64_t j = 0, k = 0, curr_block_len = 0;
        bool copying = true;
        int64_t copied_here = 0;
        while (j < curr_len && k < ref_len) {
            if (copying) {
                if (curr_list[j] > ref_list[k]) {
                    blocks.push_back(curr_block_len);
                    copying = false;
                    curr_block_len = 0;
                } else if (curr_list[j] < ref_list[k]) {
                    extras.push_back(curr_list[j++]);
                } else {
                    j++; k++; curr_block_len++;
                    copied_here++;
                }
            } else {
                if (curr_list[j] < ref_list[k]) {
                    extras.push_back(curr_list[j++]);
                } else if (curr_list[j] > ref_list[k]) {
                    k++; curr_block_len++;
                } else {
                    blocks.push_back(curr_block_len);
                    copying = true;
                    curr_block_len = 0;
                }
            }
        }
        if (copying && k < ref_len) blocks.push_back(curr_block_len);
        while (j < curr_len) extras.push_back(curr_list[j++]);
        if (for_real) st[0] += copied_here;

        if (s.window_size > 0) {
            int64_t t = len_coded(ref, s.c_ref, s.zeta_k);
            if (for_real) { write_coded(*obs, ref, s.c_ref, s.zeta_k); st[6] += t; }
            bits += t;
        }
        if (ref != 0) {
            int64_t t = len_coded((int64_t)blocks.size(), s.c_bcnt, s.zeta_k);
            if (for_real) {
                write_coded(*obs, (int64_t)blocks.size(), s.c_bcnt, s.zeta_k);
                st[7] += t;
            }
            bits += t;
            for (size_t i = 0; i < blocks.size(); i++) {
                int64_t b = i == 0 ? blocks[i] : blocks[i] - 1;
                int64_t tb = len_coded(b, s.c_blk, s.zeta_k);
                if (for_real) { write_coded(*obs, b, s.c_blk, s.zeta_k); st[7] += tb; }
                bits += tb;
            }
        }

        if (!extras.empty()) {
            // intervalization (BVGraph.java:1595-1618) + residual gaps
            int64_t first_res = -1, prev_res = -1;
            bool have_res = false;
            int64_t res_count = 0;
            auto emit_residual = [&](int64_t v) {
                int64_t t;
                if (!have_res) {
                    t = len_coded(int2nat(v - curr_node), s.c_res, s.zeta_k);
                    if (for_real)
                        write_coded(*obs, int2nat(v - curr_node), s.c_res, s.zeta_k);
                    first_res = v;
                    have_res = true;
                } else {
                    t = len_coded(v - prev_res - 1, s.c_res, s.zeta_k);
                    if (for_real) {
                        write_coded(*obs, v - prev_res - 1, s.c_res, s.zeta_k);
                        st[74 + msb64((uint64_t)(v - prev_res))]++;
                    }
                }
                prev_res = v;
                res_count++;
                if (for_real) st[9] += t;
                bits += t;
            };

            if (s.min_interval_length != 0) {
                const int64_t minint = s.min_interval_length;
                const int64_t vl = (int64_t)extras.size();
                const int64_t* vals = extras.data();
                // first scan: count intervals (the gamma count precedes them)
                int64_t n_intervals = 0;
                for (int64_t i = 0; i < vl;) {
                    int64_t jr = 0;
                    if (i < vl - 1 && vals[i] + 1 == vals[i + 1]) {
                        jr = 2;
                        while (i + jr - 1 < vl - 1 &&
                               vals[i + jr - 1] + 1 == vals[i + jr])
                            jr++;
                        if (jr >= minint) {
                            n_intervals++;
                            i += jr;
                            continue;
                        }
                    }
                    i++;
                }
                int64_t t = len_gamma(n_intervals);
                if (for_real) { write_gamma(*obs, n_intervals); st[8] += t; }
                bits += t;
                // second scan: intervals first (in order), then residuals
                int64_t prev = 0, idx = 0;
                for (int64_t i = 0; i < vl;) {
                    int64_t jr = 0;
                    if (i < vl - 1 && vals[i] + 1 == vals[i + 1]) {
                        jr = 2;
                        while (i + jr - 1 < vl - 1 &&
                               vals[i + jr - 1] + 1 == vals[i + jr])
                            jr++;
                        if (jr >= minint) {
                            int64_t left = vals[i];
                            int64_t code = idx == 0 ? int2nat(left - curr_node)
                                                    : left - prev - 1;
                            int64_t tl = len_gamma(code) +
                                         len_gamma(jr - minint);
                            if (for_real) {
                                write_gamma(*obs, code);
                                write_gamma(*obs, jr - minint);
                                st[8] += tl;
                                st[1] += jr;
                            }
                            bits += tl;
                            prev = left + jr;
                            idx++;
                            i += jr;
                            continue;
                        }
                    }
                    i++;
                }
                for (int64_t i = 0; i < vl;) {
                    int64_t jr = 0;
                    if (i < vl - 1 && vals[i] + 1 == vals[i + 1]) {
                        jr = 2;
                        while (i + jr - 1 < vl - 1 &&
                               vals[i + jr - 1] + 1 == vals[i + jr])
                            jr++;
                        if (jr >= minint) { i += jr; continue; }
                    }
                    emit_residual(vals[i]);
                    i++;
                }
            } else {
                for (int64_t v : extras) emit_residual(v);
            }
            if (for_real && res_count > 0) {
                st[2] += res_count;
                int64_t z = int2nat(first_res - curr_node);
                if (z > 0) st[74 + msb64((uint64_t)z)]++;
            }
        }
        return bits;
    }

    // Encode node x with successor list curr_list; returns bits written.
    int64_t encode_node(BitWriter& obs, int64_t x, const int64_t* curr_list,
                        int64_t outd) {
        int64_t start = obs.written_bits();
        const int cyclic = s.window_size + 1;
        const int curr_index = (int)(x % cyclic);
        int64_t t = len_coded(outd, s.c_out, s.zeta_k);
        write_coded(obs, outd, s.c_out, s.zeta_k);
        st[5] += t;
        window[curr_index].assign(curr_list, curr_list + outd);
        window_len[curr_index] = outd;
        if (outd == 0) return obs.written_bits() - start;
        curr_list = window[curr_index].data();
        update_bins(x, curr_list, outd, st + 10);

        int64_t best_comp = -1;
        int best_cand = -1;
        int64_t best_ref = -1;
        ref_count[curr_index] = -1;
        for (int ref = 0; ref < cyclic; ref++) {
            int cand = (int)(((x - ref) % cyclic + cyclic) % cyclic);
            if (ref_count[cand] < s.max_ref_count && window_len[cand] != 0) {
                int64_t size = diff_comp(nullptr, x, ref, window[cand].data(),
                                         window_len[cand], curr_list, outd,
                                         false);
                if (best_comp < 0 || size < best_comp) {
                    best_comp = size;
                    best_cand = cand;
                    best_ref = ref;
                }
            }
        }
        ref_count[curr_index] = ref_count[best_cand] + 1;
        diff_comp(&obs, x, best_ref, window[best_cand].data(),
                  window_len[best_cand], curr_list, outd, true);
        st[3] += ref_count[curr_index];
        st[4] += best_ref;
        return obs.written_bits() - start;
    }
};

}  // namespace

}  // namespace

extern "C" {

// Decode an (n+1)-entry gap stream (gamma or delta) into absolute offsets.
// Returns 0 on success.
int wg_decode_offset_stream(const uint8_t* data, int64_t len_bytes,
                            int64_t n_plus_1, int coding, int64_t* out) {
    BitReader r(data, (size_t)len_bytes);
    int64_t acc = 0;
    for (int64_t i = 0; i < n_plus_1; i++) {
        acc += (coding == K_DELTA) ? r.read_delta() : r.read_gamma();
        out[i] = acc;
    }
    return 0;
}

// Decode all outdegrees given per-node bit offsets.
int wg_decode_outdegrees(const uint8_t* data, int64_t len_bytes,
                         const int64_t* offsets, int64_t n, int coding,
                         int64_t* out) {
    BitReader r(data, (size_t)len_bytes);
    for (int64_t x = 0; x < n; x++) {
        r.pos = (size_t)offsets[x];
        out[x] = (coding == K_DELTA) ? r.read_delta() : r.read_gamma();
    }
    return 0;
}

int64_t wg_bv_decode_all_refs(const uint8_t* data, int64_t len_bytes,
                              int64_t n, int window_size,
                              int min_interval_length, int zeta_k,
                              const int* codings, int64_t* csr_off,
                              int64_t* succ, int64_t succ_capacity,
                              int32_t* refs_out);

// Full sequential BVGraph decode into CSR arrays.
// codings: [outdegree, reference, block_count, block, residual]
// csr_off must hold n+1 entries (filled); succ must hold >= m entries where
// m = sum of outdegrees (caller obtains it via wg_decode_outdegrees).
// Returns the number of arcs written, or -1 on error.
int64_t wg_bv_decode_all(const uint8_t* data, int64_t len_bytes, int64_t n,
                         int window_size, int min_interval_length, int zeta_k,
                         const int* codings, int64_t* csr_off, int64_t* succ,
                         int64_t succ_capacity) {
    return wg_bv_decode_all_refs(data, len_bytes, n, window_size,
                                 min_interval_length, zeta_k, codings,
                                 csr_off, succ, succ_capacity, nullptr);
}

// As wg_bv_decode_all, but optionally records each node's reference value
// (0 when none) into refs_out — the planner uses this to pack only the
// actually-referenced halo lists per chunk.
int64_t wg_bv_decode_all_refs(const uint8_t* data, int64_t len_bytes,
                              int64_t n, int window_size,
                              int min_interval_length, int zeta_k,
                              const int* codings, int64_t* csr_off,
                              int64_t* succ, int64_t succ_capacity,
                              int32_t* refs_out) {
    const int c_out = codings[0], c_ref = codings[1], c_bcnt = codings[2],
              c_blk = codings[3], c_res = codings[4];
    BitReader r(data, (size_t)len_bytes);
    const int cyclic = window_size + 1;
    std::vector<std::vector<int64_t>> window((size_t)cyclic);
    std::vector<int64_t> blocks, buf, ivals, resid;
    int64_t wp = 0;
    csr_off[0] = 0;
    for (int64_t x = 0; x < n; x++) {
        int64_t d = read_coded(r, c_out, zeta_k);
        std::vector<int64_t>& mine = window[(size_t)(x % cyclic)];
        mine.clear();
        if (d < 0) return -1;
        if (refs_out) refs_out[x] = 0;
        if (d > 0) {
            int64_t ref = -1;
            if (window_size > 0) ref = read_coded(r, c_ref, zeta_k);
            if (refs_out && ref > 0) refs_out[x] = (int32_t)ref;
            int64_t copied = 0;
            blocks.clear();
            if (ref > 0) {
                const std::vector<int64_t>& rl =
                    window[(size_t)(((x - ref) % cyclic + cyclic) % cyclic)];
                int64_t bcnt = read_coded(r, c_bcnt, zeta_k);
                int64_t total = 0;
                for (int64_t i = 0; i < bcnt; i++) {
                    int64_t b = read_coded(r, c_blk, zeta_k) + (i ? 1 : 0);
                    blocks.push_back(b);
                    total += b;
                    if (i % 2 == 0) copied += b;
                }
                if (bcnt % 2 == 0) copied += (int64_t)rl.size() - total;
                // apply mask
                buf.clear();
                size_t p = 0;
                bool keep = true;
                for (size_t bi = 0; bi < blocks.size(); bi++) {
                    size_t cnt = (size_t)blocks[bi];
                    if (keep)
                        for (size_t j = 0; j < cnt && p + j < rl.size(); j++)
                            buf.push_back(rl[p + j]);
                    p += cnt;
                    keep = !keep;
                }
                if (blocks.size() % 2 == 0)
                    for (size_t j = p; j < rl.size(); j++) buf.push_back(rl[j]);
            } else {
                buf.clear();
            }
            int64_t extra = d - copied;
            ivals.clear();
            resid.clear();
            if (extra > 0) {
                if (min_interval_length != 0) {
                    int64_t icnt = r.read_gamma();
                    int64_t prev = 0;
                    for (int64_t i = 0; i < icnt; i++) {
                        int64_t left;
                        if (i == 0)
                            left = prev = nat2int(r.read_gamma()) + x;
                        else
                            left = prev = r.read_gamma() + prev + 1;
                        int64_t ln = r.read_gamma() + min_interval_length;
                        for (int64_t j = 0; j < ln; j++) ivals.push_back(left + j);
                        prev += ln;
                        extra -= ln;
                    }
                }
                if (extra > 0) {
                    int64_t prev = x + nat2int(read_coded(r, c_res, zeta_k));
                    resid.push_back(prev);
                    for (int64_t i = 1; i < extra; i++) {
                        prev += read_coded(r, c_res, zeta_k) + 1;
                        resid.push_back(prev);
                    }
                }
            }
            merge3(mine, buf, ivals, resid);
            if ((int64_t)mine.size() != d) return -2;
            if (wp + d > succ_capacity) return -3;
            std::memcpy(succ + wp, mine.data(), (size_t)d * sizeof(int64_t));
            wp += d;
        }
        csr_off[x + 1] = wp;
    }
    return wp;
}

// Sequential BVGraph decode of a node RANGE [x0, x1), starting the scan at
// a halo node p <= x0 whose bit offset is `start_bit` (the caller computes
// p = max(x0 - window_size*max_ref_count, 0) from the offsets index; chains
// from [x0,x1) cannot escape that halo, BVGraph.java:455/:2258).
// init_win_outd[j] (j=1..window_size) gives outdegree(p - j) (0 if < 0) so
// halo parses can size implicit tail copies.  Output CSR covers [x0, x1).
// Returns arcs written or < 0 on error.
int64_t wg_bv_decode_range(const uint8_t* data, int64_t len_bytes,
                           int64_t p, int64_t x0, int64_t x1,
                           int64_t start_bit,
                           const int64_t* init_win_outd,
                           int window_size, int min_interval_length,
                           int zeta_k, const int* codings,
                           int64_t* csr_off, int64_t* succ,
                           int64_t succ_capacity,
                           int64_t tail_n, int64_t* tail_bits) {
    const int c_out = codings[0], c_ref = codings[1], c_bcnt = codings[2],
              c_blk = codings[3], c_res = codings[4];
    BitReader r(data, (size_t)len_bytes);
    r.pos = (size_t)start_bit;
    const int cyclic = window_size + 1;
    std::vector<std::vector<int64_t>> window((size_t)cyclic);
    std::vector<int64_t> win_len((size_t)cyclic, 0);
    for (int j = 1; j <= window_size; j++) {
        int64_t y = p - j;
        if (y >= 0)
            win_len[(size_t)(((y % cyclic) + cyclic) % cyclic)] =
                init_win_outd[j];
    }
    std::vector<int64_t> blocks, buf, ivals, resid;
    int64_t wp = 0;
    csr_off[0] = 0;
    for (int64_t x = p; x < x1; x++) {
        // record bit positions of the trailing nodes (the next slice's
        // halo start offsets for sequential big-graph scans)
        if (tail_n > 0 && x >= x1 - tail_n)
            tail_bits[x - (x1 - tail_n)] = (int64_t)r.pos;
        int64_t d = read_coded(r, c_out, zeta_k);
        size_t slot = (size_t)(((x % cyclic) + cyclic) % cyclic);
        std::vector<int64_t>& mine = window[slot];
        mine.clear();
        if (d < 0) return -1;
        if (d > 0) {
            int64_t ref = -1;
            if (window_size > 0) ref = read_coded(r, c_ref, zeta_k);
            int64_t copied = 0;
            blocks.clear();
            size_t rslot =
                (size_t)((((x - (ref > 0 ? ref : 0)) % cyclic) + cyclic)
                         % cyclic);
            const std::vector<int64_t>& rl = window[rslot];
            int64_t rl_len = (ref > 0) ? win_len[rslot] : 0;
            if (ref > 0) {
                int64_t bcnt = read_coded(r, c_bcnt, zeta_k);
                int64_t total = 0;
                for (int64_t i = 0; i < bcnt; i++) {
                    int64_t b = read_coded(r, c_blk, zeta_k) + (i ? 1 : 0);
                    blocks.push_back(b);
                    total += b;
                    if (i % 2 == 0) copied += b;
                }
                if (bcnt % 2 == 0) copied += rl_len - total;
                buf.clear();
                size_t pp = 0;
                bool keep = true;
                for (size_t bi = 0; bi < blocks.size(); bi++) {
                    size_t cnt = (size_t)blocks[bi];
                    if (keep)
                        for (size_t j2 = 0; j2 < cnt && pp + j2 < rl.size();
                             j2++)
                            buf.push_back(rl[pp + j2]);
                    pp += cnt;
                    keep = !keep;
                }
                if (blocks.size() % 2 == 0)
                    for (size_t j2 = pp; j2 < rl.size(); j2++)
                        buf.push_back(rl[j2]);
            } else {
                buf.clear();
            }
            int64_t extra = d - copied;
            ivals.clear();
            resid.clear();
            if (extra > 0) {
                if (min_interval_length != 0) {
                    int64_t icnt = r.read_gamma();
                    int64_t prev = 0;
                    for (int64_t i = 0; i < icnt; i++) {
                        int64_t left;
                        if (i == 0)
                            left = prev = nat2int(r.read_gamma()) + x;
                        else
                            left = prev = r.read_gamma() + prev + 1;
                        int64_t ln = r.read_gamma() + min_interval_length;
                        for (int64_t j2 = 0; j2 < ln; j2++)
                            ivals.push_back(left + j2);
                        prev += ln;
                        extra -= ln;
                    }
                }
                if (extra > 0) {
                    int64_t prev = x + nat2int(read_coded(r, c_res, zeta_k));
                    resid.push_back(prev);
                    for (int64_t i = 1; i < extra; i++) {
                        prev += read_coded(r, c_res, zeta_k) + 1;
                        resid.push_back(prev);
                    }
                }
            }
            merge3(mine, buf, ivals, resid);
            // halo nodes (x < x0) may have short lists when their own
            // reference predates the halo; such lists are never reached by
            // chains from [x0, x1) (chain bound), so only enforce the
            // count invariant inside the target range
            if (x >= x0 && (int64_t)mine.size() != d) return -2;
            if (x >= x0) {
                if (wp + d > succ_capacity) return -3;
                std::memcpy(succ + wp, mine.data(),
                            (size_t)d * sizeof(int64_t));
                wp += d;
            }
        }
        win_len[slot] = d;
        if (x >= x0) csr_off[x - x0 + 1] = wp;
    }
    return wp;
}

// Parallel BVGraph encode from CSR arrays.
//
// Splits [0, n) into `threads` arc-balanced ranges; each range is encoded
// with a fresh window (the reference's per-thread semantics,
// BVGraph.java:2406-2415) and the per-range bit streams are concatenated
// bit-exactly (copyTo, BVGraph.java:2432-2483).  threads=1 reproduces the
// single-stream encoder byte for byte (golden-tested vs cnr-2000).
//
// codings: [outdegree, reference, block_count, block, residual, offset]
// Outputs are malloc'd; free with wg_buffer_free.  stats has 138 entries
// (see STAT_WORDS layout).  Returns total graph bits, or -1 on error.
int64_t wg_bv_encode(const int64_t* csr_off, const int64_t* succ, int64_t n,
                     int threads, int window_size, int max_ref_count,
                     int min_interval_length, int zeta_k, const int* codings,
                     uint8_t** graph_out, int64_t* graph_bits,
                     uint8_t** offsets_out, int64_t* offsets_bits,
                     int64_t* stats, int64_t node_base) {
    EncSettings es{window_size, max_ref_count, min_interval_length, zeta_k,
                   codings[0], codings[1], codings[2], codings[3], codings[4]};
    const int c_off = codings[5];
    if (threads < 1) threads = 1;
    if (threads > n) threads = (int)(n > 0 ? n : 1);

    // arc-balanced range boundaries
    std::vector<int64_t> bounds((size_t)threads + 1);
    bounds[0] = 0;
    bounds[(size_t)threads] = n;
    const int64_t m = n > 0 ? csr_off[n] : 0;
    {
        int64_t x = 0;
        for (int t = 1; t < threads; t++) {
            int64_t target = m * t / threads;
            while (x < n && csr_off[x] < target) x++;
            bounds[(size_t)t] = x;
        }
    }

    std::vector<BitWriter> gws((size_t)threads), ows((size_t)threads);
    std::vector<std::vector<int64_t>> all_stats(
        (size_t)threads, std::vector<int64_t>(STAT_WORDS, 0));

    auto encode_range = [&](int t) {
        Encoder enc(es, all_stats[(size_t)t].data());
        BitWriter& gw = gws[(size_t)t];
        BitWriter& ow = ows[(size_t)t];
        for (int64_t x = bounds[(size_t)t]; x < bounds[(size_t)t + 1]; x++) {
            // node_base: global id of local node 0 (per-host encode shards
            // mirror the reference's per-thread ranges with global ids)
            int64_t bits = enc.encode_node(gw, node_base + x,
                                           succ + csr_off[x],
                                           csr_off[x + 1] - csr_off[x]);
            // offsets gap = this node's entry length (gamma/delta coded)
            write_coded(ow, bits, c_off, zeta_k);
        }
    };

    if (threads == 1) {
        encode_range(0);
    } else {
        std::vector<std::thread> pool;
        pool.reserve((size_t)threads);
        for (int t = 0; t < threads; t++)
            pool.emplace_back(encode_range, t);
        for (auto& th : pool) th.join();
    }

    // aggregate stats
    for (int t = 0; t < threads; t++)
        for (int i = 0; i < STAT_WORDS; i++) stats[i] += all_stats[(size_t)t][i];

    // bit-exact concatenation of the graph streams
    auto concat = [&](std::vector<BitWriter>& ws, bool lead_zero) {
        BitWriter out;
        // leading offsets entry: a zero in the offsets coding (the Python
        // path's settings.write_offset; BVGraph.java:2228 leading 0)
        if (lead_zero) write_coded(out, 0, c_off, zeta_k);
        for (auto& w : ws) {
            int64_t bits = w.written_bits();
            const uint8_t* p = w.out.data();
            int64_t full = bits / 8;
            int64_t i = 0;
            for (; i + 4 <= full; i += 4) {
                uint32_t w32 = ((uint32_t)p[i] << 24) | ((uint32_t)p[i + 1] << 16)
                             | ((uint32_t)p[i + 2] << 8) | (uint32_t)p[i + 3];
                out.write_bits(w32, 32);
            }
            for (; i < full; i++) out.write_bits(p[i], 8);
            int rem = (int)(bits % 8);
            if (rem) {
                // remaining bits live in the accumulator (w.fill == rem)
                out.write_bits(w.buf, rem);
            }
            w.out.clear();
            w.out.shrink_to_fit();
        }
        return out;
    };

    BitWriter g = concat(gws, false);
    BitWriter o = concat(ows, true);
    int64_t gb = g.written_bits(), ob = o.written_bits();
    g.flush();
    o.flush();
    *graph_bits = gb;
    *offsets_bits = ob;
    *graph_out = (uint8_t*)std::malloc(g.out.size() ? g.out.size() : 1);
    std::memcpy(*graph_out, g.out.data(), g.out.size());
    *offsets_out = (uint8_t*)std::malloc(o.out.size() ? o.out.size() : 1);
    std::memcpy(*offsets_out, o.out.data(), o.out.size());
    return gb;
}

void wg_buffer_free(uint8_t* p) { std::free(p); }

// ------------------------------------------------------------------------
// Streaming encoder: push CSR slices of unbounded total size (the
// webgraph-"big" regime, > 2^31 nodes/arcs) through a single window-carrying
// encoder.  Mirrors BVGraph.store over an ImmutableSequentialGraph
// (BVGraph.java:2373 with one thread; window state carries across slices
// because Encoder owns copies of the last window_size+1 lists).

namespace {
struct StreamEnc {
    EncSettings es;
    int c_off;
    std::vector<int64_t> stats;
    Encoder enc;
    BitWriter gw, ow;
    int64_t x = 0;

    StreamEnc(const EncSettings& e, int coff)
        : es(e), c_off(coff), stats(STAT_WORDS, 0), enc(e, stats.data()) {
        // leading offsets entry (a zero in the offsets coding)
        write_coded(ow, 0, c_off, es.zeta_k);
    }
};

uint8_t* copy_bits(BitWriter& w, int64_t* bits) {
    int64_t b = w.written_bits();
    w.flush();
    *bits = b;
    uint8_t* p = (uint8_t*)std::malloc(w.out.size() ? w.out.size() : 1);
    std::memcpy(p, w.out.data(), w.out.size());
    return p;
}
}  // namespace

void* wg_enc_new(int window_size, int max_ref_count, int min_interval_length,
                 int zeta_k, const int* codings) {
    EncSettings es{window_size, max_ref_count, min_interval_length, zeta_k,
                   codings[0], codings[1], codings[2], codings[3],
                   codings[4]};
    return new StreamEnc(es, codings[5]);
}

// Encode k more nodes whose slice-local CSR is csr_off[0..k] over succ.
// Returns total graph bits so far, or -1 on error.
int64_t wg_enc_push(void* h, const int64_t* csr_off, const int64_t* succ,
                    int64_t k) {
    StreamEnc* se = (StreamEnc*)h;
    for (int64_t i = 0; i < k; i++) {
        int64_t bits = se->enc.encode_node(se->gw, se->x,
                                           succ + csr_off[i],
                                           csr_off[i + 1] - csr_off[i]);
        write_coded(se->ow, bits, se->c_off, se->es.zeta_k);
        se->x++;
    }
    return se->gw.written_bits();
}

// Finish: copy out graph/offsets streams + stats.  Returns nodes encoded.
int64_t wg_enc_finish(void* h, uint8_t** graph_out, int64_t* graph_bits,
                      uint8_t** offsets_out, int64_t* offsets_bits,
                      int64_t* stats) {
    StreamEnc* se = (StreamEnc*)h;
    *graph_out = copy_bits(se->gw, graph_bits);
    *offsets_out = copy_bits(se->ow, offsets_bits);
    for (int i = 0; i < STAT_WORDS; i++) stats[i] = se->stats[(size_t)i];
    return se->x;
}

void wg_enc_free(void* h) { delete (StreamEnc*)h; }

// ------------------------------------------------------------------------
// Batched range decode: nr independent ranges in ONE call (the per-call
// ctypes + buffer-allocation overhead of wg_bv_decode_range dominates when
// filling thousands of small hub ranges).  Range i decodes nodes
// [x0[i], x1[i]) starting at halo p[i] / bit start_bit[i] with
// init_win[i*window_size + j] = outdegree(p[i]-1-j); exactly arcs[i]
// successors are written at succ + dst[i].  Ranges are split across
// `threads` std::threads.  Returns 0, or the first range's error (< 0).
int64_t wg_bv_fill_ranges(const uint8_t* data, int64_t len_bytes,
                          int64_t nr, const int64_t* p, const int64_t* x0,
                          const int64_t* x1, const int64_t* start_bit,
                          const int64_t* init_win,
                          int window_size, int min_interval_length,
                          int zeta_k, const int* codings,
                          const int64_t* dst, const int64_t* arcs,
                          int64_t* succ, int threads) {
    if (threads < 1) threads = 1;
    std::vector<int64_t> errs((size_t)threads, 0);
    auto work = [&](int t) {
        std::vector<int64_t> csr;
        std::vector<int64_t> win((size_t)window_size + 1, 0);
        for (int64_t i = t; i < nr; i += threads) {
            csr.resize((size_t)(x1[i] - x0[i] + 1));
            for (int j = 0; j < window_size; j++)
                win[(size_t)j + 1] = init_win[i * window_size + j];
            int64_t rc = wg_bv_decode_range(
                data, len_bytes, p[i], x0[i], x1[i], start_bit[i],
                win.data(), window_size, min_interval_length, zeta_k,
                codings, csr.data(), succ + dst[i], arcs[i], 0, nullptr);
            if (rc != arcs[i]) {
                errs[(size_t)t] = rc < 0 ? rc : -4;
                return;
            }
        }
    };
    if (threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; t++) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    for (int t = 0; t < threads; t++)
        if (errs[(size_t)t] < 0) return errs[(size_t)t];
    return 0;
}

// Hub-entry header parse + residual checkpoints — the plan-time index pass
// behind device-side hub decode (nodes too large for a kernel lane's VMEM
// column).  For each node x (its entry start bit supplied from the offsets
// index): parses outdegree / reference / copy blocks / intervals, then
// walks the residual gap codes recording a checkpoint (bit position AFTER
// the value's code, the value itself, and the segment length) every
// arc_quantum residuals or whenever the segment's bit span would exceed
// bit_quantum — so every segment fits a kernel stream column.  The same
// role as EFGraph's skip pointers (EFGraph.java:89) applied to BVGraph
// residual runs.
//
// Outputs (flat, caller-sized; returns -3 when any capacity is exceeded so
// the caller can grow and retry):
//   ref_out[n], kept_cnt[n], int_cnt[n], res_cnt[n], cp_cnt[n]
//   kept_pairs: (start,len) ranges into the REF list, copy order
//   int_pairs:  (left,len) interval extents
//   cps:        (bit_pos, value, count) residual segments
int64_t wg_bv_hub_parse(const uint8_t* data, int64_t len_bytes,
                        const int64_t* nodes, int64_t n_in,
                        const int64_t* start_bits, const int64_t* outd_all,
                        int64_t arc_quantum, int64_t bit_quantum,
                        int window_size, int min_interval_length,
                        int zeta_k, const int* codings,
                        int64_t* ref_out, int64_t* kept_cnt,
                        int64_t* int_cnt, int64_t* res_cnt, int64_t* cp_cnt,
                        int64_t* kept_pairs, int64_t kept_cap,
                        int64_t* int_pairs, int64_t int_cap,
                        int64_t* cps, int64_t cp_cap) {
    const int c_out = codings[0], c_ref = codings[1], c_bcnt = codings[2],
              c_blk = codings[3], c_res = codings[4];
    int64_t kp = 0, ip = 0, cp = 0;
    for (int64_t i = 0; i < n_in; i++) {
        BitReader r(data, (size_t)len_bytes);
        r.pos = (size_t)start_bits[i];
        const int64_t x = nodes[i];
        const int64_t d = read_coded(r, c_out, zeta_k);
        if (d != outd_all[x]) return -1;
        int64_t ref = 0, copied = 0;
        kept_cnt[i] = int_cnt[i] = res_cnt[i] = cp_cnt[i] = 0;
        if (d == 0) { ref_out[i] = 0; continue; }
        if (window_size > 0) ref = read_coded(r, c_ref, zeta_k);
        ref_out[i] = ref;
        if (ref > 0) {
            const int64_t rl_len = outd_all[x - ref];
            const int64_t bcnt = read_coded(r, c_bcnt, zeta_k);
            int64_t pos = 0;
            bool keep = true;
            for (int64_t b = 0; b < bcnt; b++) {
                int64_t c = read_coded(r, c_blk, zeta_k) + (b ? 1 : 0);
                if (keep && c > 0) {
                    int64_t ln = std::min(c, rl_len - pos);
                    if (ln > 0) {
                        if (kp + 2 > kept_cap) return -3;
                        kept_pairs[kp++] = pos;
                        kept_pairs[kp++] = ln;
                        kept_cnt[i]++;
                        copied += ln;
                    }
                }
                pos += c;
                keep = !keep;
            }
            if (bcnt % 2 == 0 && pos < rl_len) {
                if (kp + 2 > kept_cap) return -3;
                kept_pairs[kp++] = pos;
                kept_pairs[kp++] = rl_len - pos;
                kept_cnt[i]++;
                copied += rl_len - pos;
            }
        }
        int64_t extra = d - copied;
        if (extra < 0) return -2;
        if (extra > 0 && min_interval_length != 0) {
            const int64_t icnt = r.read_gamma();
            int64_t prev = 0;
            for (int64_t t = 0; t < icnt; t++) {
                int64_t left;
                if (t == 0)
                    left = prev = nat2int(r.read_gamma()) + x;
                else
                    left = prev = r.read_gamma() + prev + 1;
                const int64_t ln = r.read_gamma() + min_interval_length;
                if (ip + 2 > int_cap) return -3;
                int_pairs[ip++] = left;
                int_pairs[ip++] = ln;
                int_cnt[i]++;
                prev += ln;
                extra -= ln;
            }
        }
        if (extra > 0) {
            res_cnt[i] = extra;
            int64_t prev = x + nat2int(read_coded(r, c_res, zeta_k));
            // open the first segment
            if (cp + 3 > cp_cap) return -3;
            int64_t seg = cp;
            cps[cp] = (int64_t)r.pos;
            cps[cp + 1] = prev;
            cps[cp + 2] = 1;
            cp += 3;
            cp_cnt[i]++;
            int64_t seg_bit0 = (int64_t)r.pos;
            for (int64_t k = 1; k < extra; k++) {
                const size_t before = r.pos;
                prev += read_coded(r, c_res, zeta_k) + 1;
                const bool cut = cps[seg + 2] >= arc_quantum
                    || ((int64_t)r.pos - seg_bit0) > bit_quantum;
                if (cut) {
                    if (cp + 3 > cp_cap) return -3;
                    seg = cp;
                    cps[cp] = (int64_t)r.pos;
                    cps[cp + 1] = prev;
                    cps[cp + 2] = 1;
                    cp += 3;
                    cp_cnt[i]++;
                    seg_bit0 = (int64_t)r.pos;
                } else {
                    cps[seg + 2]++;
                }
                (void)before;
            }
        }
    }
    return 0;
}

// Header-only reference scan: per node, position at offsets[x], read the
// outdegree code and (window_size > 0, d > 0) the reference code; nothing
// else is decoded — skipping to the next node is free via the offsets
// index.  This is the cold-plan replacement for a full oracle decode
// (refs_out of wg_bv_decode_all_refs): the kernel planner needs only the
// per-node reference values to prune halo lists, and those live in the
// entry header (format spec BVGraph.java:123-233; loadInternal needs only
// .graph/.offsets, :1479-1574).  Threaded over contiguous node ranges
// (each node's header parse is independent given its bit offset).
int64_t wg_bv_scan_refs(const uint8_t* data, int64_t len_bytes,
                        const int64_t* offsets, int64_t n,
                        int window_size, int zeta_k, const int* codings,
                        int32_t* refs_out, int threads) {
    const int c_out = codings[0], c_ref = codings[1];
    if (threads < 1) threads = 1;
    std::vector<int64_t> errs((size_t)threads, 0);
    auto work = [&](int t) {
        const int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
        BitReader r(data, (size_t)len_bytes);
        for (int64_t x = lo; x < hi; x++) {
            r.pos = (size_t)offsets[x];
            const int64_t d = read_coded(r, c_out, zeta_k);
            if (d < 0) { errs[(size_t)t] = -1; return; }
            int64_t ref = 0;
            if (d > 0 && window_size > 0) ref = read_coded(r, c_ref, zeta_k);
            if (ref < 0 || ref > window_size) { errs[(size_t)t] = -2; return; }
            refs_out[x] = (int32_t)ref;
        }
    };
    if (threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; t++) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    for (int t = 0; t < threads; t++)
        if (errs[(size_t)t] < 0) return errs[(size_t)t];
    return 0;
}

// ------------------------------------------------------------------------
// Greedy reference selection over a precomputed candidate-cost matrix —
// the only sequential step of the vectorized encoder (ops/vencode.py).
// Exactly BVGraph.java:2256-2270 / Encoder::encode_node semantics: iterate
// ref = 0..window, candidate eligible when its window slot holds a nonempty
// list AND its reference chain is shorter than max_ref_count; strict <
// improvement, first minimum wins.  Window resets at each chunk bound
// (per-thread semantics, BVGraph.java:2406).  costs[x*(W+1)+r] is the
// diff_comp bit count (< 0 marks r unavailable).  Writes refs[x] in [0, W]
// and (when rc_out != null) the per-node reference-chain depth (the
// encoder's ref_count; feeds the avgref stat).  Returns 0.
int64_t wg_select_refs(const int64_t* costs, const int64_t* outd, int64_t n,
                       int window_size, int max_ref_count,
                       const int64_t* chunk_bounds, int64_t n_chunks,
                       int32_t* refs, int32_t* rc_out) {
    const int cyclic = window_size + 1;
    std::vector<int> rc((size_t)cyclic, 0);
    std::vector<int64_t> wlen((size_t)cyclic, 0);
    for (int64_t c = 0; c < n_chunks; c++) {
        std::fill(wlen.begin(), wlen.end(), 0);
        for (int64_t x = chunk_bounds[c]; x < chunk_bounds[c + 1]; x++) {
            const int slot = (int)(x % cyclic);
            wlen[(size_t)slot] = outd[x];
            refs[x] = 0;
            if (outd[x] == 0) {
                if (rc_out) rc_out[x] = 0;
                continue;
            }
            rc[(size_t)slot] = -1;
            int64_t best = -1;
            int best_slot = slot;
            int best_r = 0;
            for (int r = 0; r < cyclic; r++) {
                const int cand = (int)(((x - r) % cyclic + cyclic) % cyclic);
                const int64_t cost = costs[x * cyclic + r];
                if (rc[(size_t)cand] < max_ref_count &&
                    wlen[(size_t)cand] != 0 && cost >= 0) {
                    if (best < 0 || cost < best) {
                        best = cost;
                        best_slot = cand;
                        best_r = r;
                    }
                }
            }
            rc[(size_t)slot] = rc[(size_t)best_slot] + 1;
            refs[x] = (int32_t)best_r;
            if (rc_out) rc_out[x] = (int32_t)rc[(size_t)slot];
        }
    }
    return 0;
}

// Fast arc-pair text parse (the scalar hot loop of scattered-arc ingestion,
// the role ScatteredArcsASCIIGraph.java:600-700's char-level scanner plays).
// Parses lines of the form "<int64> <int64>[ \t]*" from `buf`; blank lines
// and lines starting with '#' are skipped.  At most `cap` pairs are parsed
// and, unless `eof`, a trailing incomplete line (no '\n') is left
// unconsumed; *consumed reports the bytes processed so the caller can carry
// the remainder into the next chunk.  Returns the number of pairs parsed,
// or -(byte offset + 1) of the first malformed line.
int64_t wg_parse_arcs(const uint8_t* buf, int64_t len, int eof,
                      int64_t* src, int64_t* tgt, int64_t cap,
                      int64_t* consumed) {
    int64_t p = 0, count = 0;
    while (p < len && count < cap) {
        // find the end of this line
        const uint8_t* nl = (const uint8_t*)std::memchr(buf + p, '\n',
                                                        (size_t)(len - p));
        int64_t q = nl ? (int64_t)(nl - buf) : len;
        if (!nl && !eof) break;  // incomplete trailing line: leave it
        int64_t i = p;
        while (i < q && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r'))
            i++;
        if (i == q || buf[i] == '#') { p = q + 1; continue; }
        int64_t vals[2];
        for (int k = 0; k < 2; k++) {
            bool neg = false;
            if (buf[i] == '-' || buf[i] == '+') { neg = buf[i] == '-'; i++; }
            if (i >= q || buf[i] < '0' || buf[i] > '9') return -(p + 1);
            uint64_t v = 0;
            while (i < q && buf[i] >= '0' && buf[i] <= '9')
                v = v * 10 + (uint64_t)(buf[i++] - '0');
            vals[k] = neg ? -(int64_t)v : (int64_t)v;
            while (i < q && (buf[i] == ' ' || buf[i] == '\t'
                             || buf[i] == '\r'))
                i++;
            if (k == 0 && i >= q) return -(p + 1);  // only one field
        }
        if (i != q) return -(p + 1);  // trailing garbage after two fields
        src[count] = vals[0];
        tgt[count] = vals[1];
        count++;
        p = q + 1;
    }
    *consumed = p > len ? len : p;
    return count;
}

// List-label decode (FixedWidthIntListLabel / FixedWidthLongListLabel
// streams, BitStreamArcLabelledImmutableGraph.java:66-120): node x's labels
// start at bit lo[x], one per arc of [csr_off[x], csr_off[x + 1]), each the
// gamma code of its length c, then c entries of w bits.  The nodes are cut
// into nr ranges [x0[r], x1[r]) (equal shares of the arcs, one per thread).
//
// Pass 1 reads the lengths into counts[], skipping the entries, and checks
// that every node ends exactly at lo[x + 1]; range_entries[r] gets the
// range's entry total.  On a failure err[0..2] = (node, end bit, kind: 1
// the node ends elsewhere -- read to its last arc, as a sequential reader
// would -- or 2 a code runs past the nbits bits of the stream) of the
// first failing node of the first failing range, and the return is -1.
int64_t wg_list_label_counts(const uint8_t* data, int64_t len_bytes,
                             const int64_t* lo, const int64_t* csr_off,
                             int64_t nr, const int64_t* x0, const int64_t* x1,
                             int w, int64_t* counts, int64_t* range_entries,
                             int64_t* err) {
    const int64_t nbits = len_bytes * 8;
    std::vector<int64_t> bad((size_t)nr * 3, -1);
    auto work = [&](int64_t r) {
        BitReader rd(data, (size_t)len_bytes);
        int64_t tot = 0;
        for (int64_t x = x0[r]; x < x1[r]; x++) {
            if (lo[x] < 0 || lo[x] > nbits) {
                int64_t* b = &bad[(size_t)r * 3];
                b[0] = x; b[1] = lo[x]; b[2] = 2;
                return;
            }
            rd.pos = (size_t)lo[x];
            for (int64_t j = csr_off[x]; j < csr_off[x + 1]; j++) {
                int64_t u = rd.read_unary();
                int64_t c = 0;
                if (u > 62 || (int64_t)rd.pos + u > nbits) {
                    c = -1;
                } else if (u) {
                    c = (int64_t)(((uint64_t)1 << u)
                                  | rd.read_bits((int)u)) - 1;
                }
                if (c < 0 || (w && c > (nbits - (int64_t)rd.pos) / w)) {
                    int64_t* b = &bad[(size_t)r * 3];
                    b[0] = x; b[1] = (int64_t)rd.pos; b[2] = 2;
                    return;
                }
                counts[j] = c;
                tot += c;
                rd.pos += (size_t)(c * w);
            }
            if ((int64_t)rd.pos != lo[x + 1]) {
                int64_t* b = &bad[(size_t)r * 3];
                b[0] = x; b[1] = (int64_t)rd.pos; b[2] = 1;
                return;
            }
        }
        range_entries[r] = tot;
    };
    std::vector<std::thread> pool;
    for (int64_t r = 1; r < nr; r++) pool.emplace_back(work, r);
    if (nr > 0) work(0);
    for (auto& th : pool) th.join();
    for (int64_t r = 0; r < nr; r++)
        if (bad[(size_t)r * 3 + 2] > 0) {
            for (int k = 0; k < 3; k++) err[k] = bad[(size_t)r * 3 + k];
            return -1;
        }
    return 0;
}

// Pass 2: the entries of range r written from entries + range_start[r],
// each arc's w-bit fields after the gamma code of counts[j] (pass 1 has
// checked the stream).
int64_t wg_list_label_entries(const uint8_t* data, int64_t len_bytes,
                              const int64_t* lo, const int64_t* csr_off,
                              int64_t nr, const int64_t* x0, const int64_t* x1,
                              int w, const int64_t* counts,
                              const int64_t* range_start, int64_t* entries) {
    auto work = [&](int64_t r) {
        BitReader rd(data, (size_t)len_bytes);
        int64_t* out = entries + range_start[r];
        for (int64_t x = x0[r]; x < x1[r]; x++) {
            rd.pos = (size_t)lo[x];
            for (int64_t j = csr_off[x]; j < csr_off[x + 1]; j++) {
                const int64_t c = counts[j];
                const int lg = 63 - __builtin_clzll((uint64_t)c + 1);
                rd.pos += (size_t)(2 * lg + 1);   // the gamma code of c
                for (int64_t k = 0; k < c; k++)
                    *out++ = (int64_t)rd.read_bits(w);
            }
        }
    };
    std::vector<std::thread> pool;
    for (int64_t r = 1; r < nr; r++) pool.emplace_back(work, r);
    if (nr > 0) work(0);
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
