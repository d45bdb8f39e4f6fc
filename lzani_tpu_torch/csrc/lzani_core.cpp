// ============================================================================
// lzani_core.cpp — host-side exact LZ-similarity engine: the port's own copy
// of lzani_tpu/core/native/lzani_core.cpp (held equal to it by
// tests/test_torch_native_copy.py).
//
// Roles:
//   (a) CPU production backend (threaded all-vs-all driver), and
//   (b) the bit-exact oracle that the device kernels are validated
//       against.
//
// This is an original implementation. Semantics follow the published
// behaviour of refresh-bio/LZ-ANI (the reference source tree);
// each stage cites the reference location whose observable behaviour it
// reproduces:
//   * buffers/codes .......... parser.cpp:16-50, defs.h:24-30
//   * k-mer streams .......... parser.cpp:53-103
//   * anchor hash table ...... parser.cpp:146-189 (murmur-mix, parser.h:98-107)
//   * seed bucket table ...... parser.cpp:106-143
//   * greedy parse ........... parser.cpp:482-716
//   * stats / regions ........ parser.cpp:734-837
//   * all2all scheduling ..... lz_matcher.cpp:172-277
//
// Build: g++ -O3 -std=c++20 -shared -fPIC -o liblzani_core.so lzani_core.cpp
// ============================================================================

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace lza {

// Symbol codes. N in the reference buffer (4) never equals N in the query
// buffer (5), so padding never matches (defs.h:24-30).
constexpr uint8_t SYM_N_REF = 4;
constexpr uint8_t SYM_N_SEQ = 5;

struct Cfg {
    int32_t mal;  // min anchor length (11)
    int32_t msl;  // min seed length (7)
    int32_t mrd;  // max dist in reference (40)
    int32_t mqd;  // max dist in query (40)
    int32_t reg;  // min region length (35)
    int32_t aw;   // approx window (15)
    int32_t am;   // approx mismatches (7)
    int32_t ar;   // approx run len (3)
};

enum Kind : int32_t { F_LIT = 0, F_CLOSE = 1, F_DISTANT = 2 };

struct Factor {
    int32_t dpos;
    int32_t kind;
    int32_t rpos;
    int32_t len;
};

struct Region {
    int32_t ref_lo, ref_hi, q_lo, q_hi;  // half-open, -1 = unset
    int32_t n_match, n_mismatch;
};

// MurmurHash3 64-bit finalizer (same constants as parser.h:98-107).
static inline uint64_t mix64(uint64_t v) {
    v ^= v >> 33;
    v *= 0xff51afd7ed558ccdULL;
    v ^= v >> 33;
    v *= 0xc4ceb9fe1a85ec53ULL;
    v ^= v >> 33;
    return v;
}

// P(random k-mer match) = 4^-len; table entries are exact powers of two
// (parser.h:134-172).
static inline double prob_len(int len) {
    if (len < 30) return std::ldexp(1.0, -2 * len);
    return std::pow(4.0, -(double)len);
}

// Binary exponentiation over doubles — multiplication order must match the
// reference bit-for-bit (parser.h:174-188).
static inline double fpow(double base, uint32_t e) {
    double r = 1.0;
    while (e) {
        if (e & 1) r *= base;
        base *= base;
        e /= 2;
    }
    return r;
}

// --------------------------------------------------------------------------
// K-mer stream: entry p holds the base-4 value of the k-mer starting at p,
// or -1 when any symbol in the window is an N code (parser.cpp:53-103).
// The output has exactly seq.size() entries (store_all padding).
// --------------------------------------------------------------------------
static void kmer_stream(std::vector<int64_t>& out, const uint8_t* seq,
                        int64_t n, int k) {
    out.assign((size_t)n, -1);
    if (n < k) return;
    uint64_t mask = (~0ULL) >> (64 - 2 * k);
    uint64_t val = 0;
    int run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t c = seq[i];
        if (c >= SYM_N_REF) {
            run = 0;
            val = 0;
        } else {
            val = ((val << 2) | c) & mask;
            ++run;
        }
        if (i >= k - 1 && run >= k) out[(size_t)(i - k + 1)] = (int64_t)val;
    }
}

// --------------------------------------------------------------------------
// Per-reference index: composite buffer + anchor hash table + seed buckets.
// --------------------------------------------------------------------------
struct RefIndex {
    Cfg cfg;
    // Semantic composite length (fwd | N^mrd | N^mrd | rc | N^mrd). The
    // vector additionally carries a deterministic N_REF guard band: the
    // reference's tail emission (parser.cpp:713) and gap alignment can
    // read past the composite end (verified UB in the original binary —
    // its output depends on heap garbage there). N codes never match
    // query symbols, which makes this engine deterministic and aligned
    // with the device engines' padded buffers.
    int64_t n_sem = 0;
    std::vector<uint8_t> buf;
    std::vector<int64_t> anchors;   // mal-mer stream over buf
    std::vector<int64_t> seeds;     // msl-mer stream over buf
    std::vector<int32_t> ahash;     // open addressing, linear probe, -1 empty
    uint64_t amask = 0;
    std::vector<int32_t> bucket_pos;    // seed positions grouped by seed value
    std::vector<int32_t> bucket_lo;     // 4^msl bucket offsets
    std::vector<int32_t> bucket_n;      // 4^msl bucket sizes

    void build(const uint8_t* seq, int64_t n, const Cfg& c,
               bool tables = true) {
        cfg = c;
        const int64_t mrd = c.mrd;
        buf.clear();
        buf.reserve((size_t)(2 * n + 3 * mrd));
        // forward strand: query-N(5) -> ref-N(4)
        for (int64_t i = 0; i < n; ++i) {
            uint8_t s = seq[i];
            buf.push_back(s == SYM_N_SEQ ? SYM_N_REF : s);
        }
        buf.insert(buf.end(), (size_t)(2 * mrd), SYM_N_REF);
        // reverse complement
        for (int64_t i = n - 1; i >= 0; --i) {
            uint8_t s = seq[i];
            buf.push_back(s < SYM_N_REF ? (uint8_t)(3 - s) : SYM_N_REF);
        }
        buf.insert(buf.end(), (size_t)mrd, SYM_N_REF);
        n_sem = (int64_t)buf.size();
        // guard band for the reference's beyond-the-end reads
        buf.insert(buf.end(), (size_t)(c.mqd + c.msl + 64), SYM_N_REF);

        if (!tables) return;  // buffers-only mode (pseudo-factor expansion)
        kmer_stream(anchors, buf.data(), n_sem, c.mal);
        kmer_stream(seeds, buf.data(), n_sem, c.msl);
        build_anchor_table();
        build_seed_buckets();
    }

    // Table sized 2 * 2^floor(log2(10 * n_kmers)); inserts walk positions in
    // ascending order so that equal-length probes resolve to the smallest
    // position (parser.cpp:146-189).
    void build_anchor_table() {
        uint32_t x = (uint32_t)(anchors.size() / 0.1);
        while (x & (x - 1)) x &= x - 1;
        uint32_t size = 2 * x;
        amask = size - 1;
        ahash.assign(size, -1);
        for (size_t p = 0; p < anchors.size(); ++p) {
            if (anchors[p] < 0) continue;
            uint64_t h = mix64((uint64_t)anchors[p]) & amask;
            while (ahash[h] != -1) h = (h + 1) & amask;
            ahash[h] = (int32_t)p;
        }
    }

    // Counting sort of all msl-mer positions; buckets end up ascending
    // (parser.cpp:106-143).
    void build_seed_buckets() {
        size_t nb = (size_t)1 << (2 * cfg.msl);
        bucket_lo.assign(nb, 0);
        bucket_n.assign(nb, 0);
        for (int64_t s : seeds)
            if (s >= 0) ++bucket_n[(size_t)s];
        int32_t acc = 0;
        for (size_t b = 0; b < nb; ++b) {
            bucket_lo[b] = acc;
            acc += bucket_n[b];
        }
        bucket_pos.assign((size_t)acc, 0);
        std::vector<int32_t> cur(bucket_lo.begin(), bucket_lo.end());
        for (size_t p = 0; p < seeds.size(); ++p)
            if (seeds[p] >= 0) bucket_pos[(size_t)cur[(size_t)seeds[p]]++] = (int32_t)p;
    }
};

// --------------------------------------------------------------------------
// Per-pair parser workspace (reusable across queries against one reference).
// --------------------------------------------------------------------------
// Optional per-parse event counters (device-engine design instrumentation).
struct EventLogSink {
    std::vector<int32_t> rec;  // 8 int32 per event
};

struct EventStats {
    int64_t match_events = 0;  // main-loop iterations emitting a factor
    int64_t lit_synced = 0;    // literal steps with an active prediction
    int64_t lit_desync = 0;    // literal steps while desynced (anchor-only)
    int64_t ext_symbols = 0;   // symbols covered by approx extensions
    int64_t match_symbols = 0; // symbols covered by emitted matches
};

struct Parser {
    const RefIndex* ri = nullptr;
    Cfg cfg;
    std::vector<uint8_t> qbuf;  // query codes + mrd query-Ns (parser.cpp:37-50)
    std::vector<int64_t> q_anchors, q_seeds;
    std::vector<Factor> fac;
    std::vector<int32_t> win;
    std::vector<std::pair<int32_t, bool>> lhs, rhs;
    EventStats* ev = nullptr;
    EventLogSink* evlog = nullptr;

    void set_reference(const RefIndex& idx) {
        ri = &idx;
        cfg = idx.cfg;
    }

    void set_query(const uint8_t* q, int64_t n, bool streams = true) {
        qbuf.clear();
        qbuf.reserve((size_t)(n + cfg.mrd));
        for (int64_t i = 0; i < n; ++i) {
            uint8_t s = q[i];
            qbuf.push_back(s == SYM_N_REF ? SYM_N_SEQ : s);
        }
        qbuf.insert(qbuf.end(), (size_t)cfg.mrd, SYM_N_SEQ);
        if (!streams) return;
        kmer_stream(q_seeds, qbuf.data(), (int64_t)qbuf.size(), cfg.msl);
        kmer_stream(q_anchors, qbuf.data(), (int64_t)qbuf.size(), cfg.mal);
    }

    // Replay a device-produced pseudo-factor stream into the real factor
    // list. Pseudo kinds (device kernel contract, ops/pallas_engine.py):
    //   0/1/2 = real LIT/CLOSE/DISTANT factors, passed through
    //   3 = aligned range, forward  (emit_aligned_range backward=false)
    //   4 = aligned range, backward (first match run opens a region)
    //   5 = gap left part  {dpos, 5, r_left, len}  — must be followed by
    //   6 = gap right part {dpos, 6, r_right, len} (same dpos/len)
    // Returns false on a malformed stream.
    bool expand_pseudo(const int32_t* pf, int64_t npf) {
        fac.clear();
        for (int64_t k = 0; k < npf; ++k) {
            const int32_t* f = pf + 4 * k;
            int32_t dpos = f[0], kind = f[1], rpos = f[2], len = f[3];
            switch (kind) {
                case F_LIT:
                case F_CLOSE:
                case F_DISTANT:
                    fac.push_back({dpos, kind, rpos, len});
                    break;
                case 3:
                case 4:
                    emit_aligned_range(dpos, rpos, len, kind == 4);
                    break;
                case 5: {
                    if (k + 1 >= npf) return false;
                    const int32_t* g = pf + 4 * (k + 1);
                    if (g[1] != 6 || g[0] != dpos || g[3] != len) return false;
                    emit_gap_two_sided(dpos, rpos, g[2], len);
                    ++k;
                    break;
                }
                default:
                    return false;
            }
        }
        return true;
    }

    // Longest common extension between reference and query starting at the
    // given positions (parser.cpp:192-207).
    int match_len(int rpos, int dpos, int from = 0) const {
        int cap = (int)std::min(ri->n_sem - rpos,
                                (int64_t)qbuf.size() - dpos);
        const uint8_t* a = ri->buf.data() + rpos;
        const uint8_t* b = qbuf.data() + dpos;
        int r = from;
        while (r < cap && a[r] == b[r]) ++r;
        return r;
    }

    // Emit match/literal runs for an aligned range (parser.cpp:210-248).
    // When `backward`, the first match run opens a new region (match_distant).
    void emit_aligned_range(int dpos, int rpos, int len, bool backward) {
        int32_t first_flag = backward ? F_DISTANT : F_CLOSE;
        int32_t flag = first_flag;
        int run = 0;
        bool matching = false;
        for (int j = 0; j < len; ++j) {
            bool eq = ri->buf[(size_t)(rpos + j)] == qbuf[(size_t)(dpos + j)];
            if (eq) {
                if (matching) {
                    ++run;
                } else {
                    if (run) fac.push_back({dpos + j - run, F_LIT, 0, run});
                    run = 1;
                    matching = true;
                }
            } else {
                if (matching) {
                    fac.push_back({dpos + j - run, flag, rpos + j - run, run});
                    run = 1;
                    matching = false;
                    flag = F_CLOSE;
                } else {
                    ++run;
                }
            }
        }
        if (matching)
            fac.push_back({dpos + len - run, flag, rpos + len - run, run});
        else if (run)
            fac.push_back({dpos + len - run, F_LIT, 0, run});
    }

    // Optimal left/right split of the literal gap before a close match
    // (parser.cpp:251-374). The gap may align left (continuing the previous
    // match) or right (ending at the new match's reference end).
    void emit_gap_two_sided(int dpos, int r_left, int r_right, int len) {
        lhs.clear();
        rhs.clear();

        int to_scan = (r_right < r_left) ? len : std::min(r_right - r_left, len);

        int nm = 0;
        lhs.emplace_back(0, false);
        for (int j = 0; j < to_scan; ++j) {
            bool eq = ri->buf[(size_t)(r_left + j)] == qbuf[(size_t)(dpos + j)];
            lhs.emplace_back(nm += (int)eq, eq);
        }
        nm = 0;
        rhs.emplace_back(0, false);
        for (int j = 1; j <= std::min(to_scan, r_right); ++j) {
            bool eq = ri->buf[(size_t)(r_right - j)] == qbuf[(size_t)(dpos + len - j)];
            rhs.emplace_back(nm += (int)eq, eq);
        }
        rhs.resize((size_t)to_scan + 1, {0, false});

        int best_nm = 0, split = 0;
        for (int j = 0; j <= to_scan; ++j) {
            int tot = lhs[(size_t)j].first + rhs[(size_t)(to_scan - j)].first;
            if (tot >= best_nm) {  // >= : rightmost split wins ties
                best_nm = tot;
                split = j;
            }
        }

        // left part, aligned to r_left
        if (split > 0) {
            bool eq = lhs[1].second;
            int dp = dpos;
            fac.push_back({dp++, eq ? F_CLOSE : F_LIT, eq ? r_left : 0, 1});
            for (int j = 2; j <= split; ++j, ++dp) {
                eq = lhs[(size_t)j].second;
                int32_t kind = eq ? F_CLOSE : F_LIT;
                if (kind == fac.back().kind)
                    ++fac.back().len;
                else
                    fac.push_back({dp, kind, eq ? r_left + j - 1 : 0, 1});
            }
        }

        // middle: part of the gap with no reference room — literals
        if (to_scan < len) {
            if (split > 0 && fac.back().kind == F_LIT)
                fac.back().len += len - to_scan;
            else
                fac.push_back({dpos + split, F_LIT, 0, len - to_scan});
        }

        // right part, aligned so the gap ends at r_right
        if (split < to_scan) {
            int shift = len - to_scan;
            int from_right = to_scan - split;
            bool eq = rhs[(size_t)from_right].second;
            int dp = dpos + split + shift;
            if (!eq && (split > 0 || shift > 0) && fac.back().kind == F_LIT) {
                ++fac.back().len;  // note: dp deliberately NOT advanced (:355-358)
            } else {
                fac.push_back({dp++, eq ? F_CLOSE : F_LIT,
                               eq ? r_right - from_right : 0, 1});
            }
            for (int j = from_right - 1; j > 0; --j, ++dp) {
                eq = rhs[(size_t)j].second;
                int32_t kind = eq ? F_CLOSE : F_LIT;
                if (kind == fac.back().kind)
                    ++fac.back().len;
                else
                    fac.push_back({dp, kind, eq ? r_right - j : 0, 1});
            }
        }
    }

    // Replay a device-produced event log into the real factor list.
    //
    // The device kernel makes the data-dependent *decisions* (which match to
    // take, extension lengths); the factor emission below is the same code
    // the full parser uses, driven by the log instead of index searches.
    // Event record (8 int32): {i_ev, best_pos, best_len, bwd, ext, 0, 0, 0}.
    // The replay recomputes bwd/ext with the reference window-scan and
    // returns false on any mismatch — a free consistency check on the
    // kernel's extension arithmetic.
    bool replay_events(const int32_t* ev, int64_t nev) {
        fac.clear();
        const int dsz = (int)qbuf.size();
        int pred = -dsz;
        int lit_run = 0;
        int reg_lo = -1, reg_hi = 0;
        int i = 0;
        for (int64_t k = 0; k < nev; ++k) {
            const int32_t* e = ev + 8 * k;
            int i_ev = e[0], best_pos = e[1], best_len = e[2];
            int bwd_log = e[3], ext_log = e[4];
            if (i_ev < i || i_ev + cfg.msl >= dsz) return false;
            while (i < i_ev) {
                ++i;
                ++pred;
                ++lit_run;
                if (lit_run > cfg.mqd) pred = -dsz;
            }
            int32_t flag = F_DISTANT;
            if (pred >= 0 && std::abs(best_pos - pred) <= cfg.mrd) {
                if (bwd_log != 0) return false;
                emit_gap_two_sided(i - lit_run, pred - lit_run,
                                   best_pos + best_len, lit_run);
                fac.push_back({i, F_CLOSE, best_pos, best_len});
            } else {
                if (lit_run)
                    fac.push_back({i - lit_run, F_LIT, 0, lit_run});
                if (reg_lo >= 0 && reg_hi - reg_lo < cfg.reg) {
                    while (!fac.empty() && fac.back().dpos >= reg_lo)
                        fac.pop_back();
                    int run_len = i - reg_lo;
                    while (!fac.empty() && fac.back().kind == F_LIT) {
                        run_len += fac.back().len;
                        fac.pop_back();
                    }
                    fac.push_back({i - run_len, F_LIT, 0, run_len});
                    reg_lo = -1;
                }
                if (!fac.empty() && fac.back().kind == F_LIT) {
                    int bwd = extend_bwd(i, best_pos, fac.back().len);
                    if (bwd != bwd_log) return false;
                    if (bwd) {
                        fac.back().len -= bwd;
                        if (fac.back().len == 0) fac.pop_back();
                        emit_aligned_range(i - bwd, best_pos - bwd, bwd, true);
                        flag = F_CLOSE;
                        reg_lo = i - bwd;
                    }
                } else if (bwd_log != 0) {
                    return false;
                }
                fac.push_back({i, flag, best_pos, best_len});
                if (flag == F_DISTANT) reg_lo = i;
                if (reg_lo < 0)
                    for (int j = (int)fac.size() - 1; j >= 0; --j)
                        if (fac[(size_t)j].kind == F_DISTANT) {
                            reg_lo = fac[(size_t)j].dpos;
                            break;
                        }
            }
            i += best_len;
            pred = best_pos + best_len;
            lit_run = 0;
            int ext = extend_fwd(i, pred);
            if (ext != ext_log) return false;
            emit_aligned_range(i, pred, ext, false);
            i += ext;
            pred += ext;
            reg_hi = i;
        }
        while (i + cfg.msl < dsz) {
            ++i;
            ++pred;
            ++lit_run;
            if (lit_run > cfg.mqd) pred = -dsz;
        }
        if (pred < 0)
            fac.push_back({i - lit_run, F_LIT, 0, lit_run + (dsz - i)});
        else
            emit_aligned_range(i - lit_run, pred - lit_run - cfg.msl,
                               lit_run + (dsz - i), false);
        return true;
    }

    // Sliding-window approximate extension: advance while the mismatch count
    // within the last `aw` symbols stays <= `am`; the result is the largest
    // prefix ending with a run of >= `ar` matches (parser.cpp:377-441).
    int extend_fwd(int dpos, int rpos) {
        int dn = (int)qbuf.size(), rn = (int)ri->n_sem;
        win.assign((size_t)cfg.aw, 0);
        int bad = 0, run = cfg.ar, last = 0;
        for (int e = 0; dpos + e < dn && rpos + e < rn; ++e) {
            int miss = qbuf[(size_t)(dpos + e)] != ri->buf[(size_t)(rpos + e)];
            bad -= win[(size_t)(e % cfg.aw)];
            win[(size_t)(e % cfg.aw)] = miss;
            bad += miss;
            if (!miss) {
                if (++run >= cfg.ar) last = e + 1;
            } else {
                run = 0;
            }
            if (bad > cfg.am) break;
        }
        return last;
    }

    int extend_bwd(int dpos, int rpos, int max_len) {
        win.assign((size_t)cfg.aw, 0);
        int bad = 0, run = cfg.ar, last = 0;
        for (int e = 0; dpos - e > 0 && rpos - e > 0 && e < max_len; ++e) {
            int miss =
                qbuf[(size_t)(dpos - e - 1)] != ri->buf[(size_t)(rpos - e - 1)];
            bad -= win[(size_t)(e % cfg.aw)];
            win[(size_t)(e % cfg.aw)] = miss;
            bad += miss;
            if (!miss) {
                if (++run >= cfg.ar) last = e + 1;
            } else {
                run = 0;
            }
            if (bad > cfg.am) break;
        }
        return last;
    }

    // The greedy LZ parse automaton (parser.cpp:482-716).
    void parse() {
        fac.clear();
        const int dsz = (int)qbuf.size();
        int pred = -dsz;       // predicted ref continuation; <0 = unsynced
        int lit_run = 0;       // pending (unemitted) literal run
        int reg_lo = -1;       // current region start in query coords
        int reg_hi = 0;

        int i = 0;
        for (; i + cfg.msl < dsz;) {
            int best_pos = 0, best_len = 0;

            if (pred < 0) {
                // unsynced: global anchor search over the whole probe cluster
                if (q_anchors[(size_t)i] >= 0) {
                    uint64_t h = mix64((uint64_t)q_anchors[(size_t)i]) & ri->amask;
                    for (; ri->ahash[h] != -1; h = (h + 1) & ri->amask) {
                        int ml = match_len(ri->ahash[h], i);
                        if (ml < cfg.mal) continue;
                        if (ml > best_len) {
                            best_len = ml;
                            best_pos = ri->ahash[h];
                        }
                    }
                }
            } else {
                // synced: seed search restricted near the prediction...
                int64_t seed = q_seeds[(size_t)i];
                if (seed >= 0) {
                    const int32_t* bkt = ri->bucket_pos.data() + ri->bucket_lo[(size_t)seed];
                    int bn = ri->bucket_n[(size_t)seed];
                    int j = (int)(std::lower_bound(bkt, bkt + bn, pred - lit_run) - bkt);
                    for (; j < bn && bkt[j] < pred + cfg.mrd; ++j) {
                        int pos = bkt[j];
                        int ml = match_len(pos, i, cfg.msl);
                        if (ml >= best_len) {
                            if (ml == best_len) {
                                if (std::abs(pos - pred) < std::abs(best_pos - pred))
                                    best_pos = pos;
                            } else {
                                best_len = ml;
                                best_pos = pos;
                            }
                        }
                    }
                }

                // ...plus a global anchor candidate
                int a_len = 0, a_pos = 0;
                if (q_anchors[(size_t)i] >= 0) {
                    uint64_t h = mix64((uint64_t)q_anchors[(size_t)i]) & ri->amask;
                    for (; ri->ahash[h] != -1; h = (h + 1) & ri->amask) {
                        int ml = match_len(ri->ahash[h], i);
                        if (ml < cfg.mal) continue;
                        if (ml > a_len) {
                            a_len = ml;
                            a_pos = ri->ahash[h];
                        }
                    }
                }

                if (a_pos) {  // note: an anchor AT position 0 is ignored (:604)
                    if (!best_pos) {
                        best_pos = a_pos;
                        best_len = a_len;
                    } else {
                        // keep the candidate less likely to match by chance
                        // (parser.cpp:612-622)
                        double pa = fpow(1.0 - prob_len(a_len),
                                         (uint32_t)(int)(2 * (ri->n_sem + 1 - a_len)));
                        double pc = fpow(1.0 - prob_len(best_len),
                                         (uint32_t)(lit_run + cfg.mrd + 1 - best_len));
                        if (pa > pc) {
                            best_pos = a_pos;
                            best_len = a_len;
                        }
                    }
                }
            }

            if (best_len >= cfg.msl) {
                int32_t flag = F_DISTANT;
                const int ev_i = i;
                int ev_bwd = 0;

                if (pred >= 0 && std::abs(best_pos - pred) <= cfg.mrd) {
                    // close match: retro-align the pending literal gap
                    emit_gap_two_sided(i - lit_run, pred - lit_run,
                                       best_pos + best_len, lit_run);
                    fac.push_back({i, F_CLOSE, best_pos, best_len});
                } else {
                    if (lit_run)
                        fac.push_back({i - lit_run, F_LIT, 0, lit_run});

                    // kill the previous region if too short (parser.cpp:643-657;
                    // eval_region reduces to a length test, :446-449)
                    if (reg_lo >= 0 && reg_hi - reg_lo < cfg.reg) {
                        while (!fac.empty() && fac.back().dpos >= reg_lo)
                            fac.pop_back();
                        int run_len = i - reg_lo;
                        while (!fac.empty() && fac.back().kind == F_LIT) {
                            run_len += fac.back().len;
                            fac.pop_back();
                        }
                        fac.push_back({i - run_len, F_LIT, 0, run_len});
                        reg_lo = -1;
                    }

                    // approximate backward extension into the literal run
                    if (!fac.empty() && fac.back().kind == F_LIT) {
                        int bwd = extend_bwd(i, best_pos, fac.back().len);
                        ev_bwd = bwd;
                        if (bwd) {
                            fac.back().len -= bwd;
                            if (fac.back().len == 0) fac.pop_back();
                            emit_aligned_range(i - bwd, best_pos - bwd, bwd, true);
                            flag = F_CLOSE;
                            reg_lo = i - bwd;
                        }
                    }

                    fac.push_back({i, flag, best_pos, best_len});
                    if (flag == F_DISTANT) reg_lo = i;

                    if (reg_lo < 0)
                        for (int j = (int)fac.size() - 1; j >= 0; --j)
                            if (fac[(size_t)j].kind == F_DISTANT) {
                                reg_lo = fac[(size_t)j].dpos;
                                break;
                            }
                }

                i += best_len;
                pred = best_pos + best_len;
                lit_run = 0;

                int ext = extend_fwd(i, pred);
                emit_aligned_range(i, pred, ext, false);
                if (evlog) {
                    int32_t r[8] = {ev_i, best_pos, best_len, ev_bwd, ext,
                                    0, 0, 0};
                    evlog->rec.insert(evlog->rec.end(), r, r + 8);
                }
                if (ev) {
                    ++ev->match_events;
                    ev->match_symbols += best_len;
                    ev->ext_symbols += ext;
                }
                i += ext;
                pred += ext;
                reg_hi = i;
            } else {
                if (ev) (pred < 0 ? ev->lit_desync : ev->lit_synced)++;
                ++i;
                ++pred;
                ++lit_run;
            }

            if (lit_run > cfg.mqd) pred = -dsz;  // desync (:706-707)
        }

        // tail (:710-713)
        if (pred < 0)
            fac.push_back({i - lit_run, F_LIT, 0, lit_run + (dsz - i)});
        else
            emit_aligned_range(i - lit_run, pred - lit_run - cfg.msl,
                               lit_run + (dsz - i), false);
    }

    // Component stats: matches chain across close matches; literals count
    // only between matches inside a component; components shorter than
    // `reg` are dropped (parser.cpp:734-783).
    void stats(int32_t out[3]) const {
        int32_t tot_m = 0, tot_l = 0, n_comp = 0;
        int cur_m = 0, cur_l = 0, pend = 0;
        auto close_comp = [&]() {
            if (cur_m && cur_m + cur_l >= cfg.reg) {
                tot_m += cur_m;
                tot_l += cur_l;
                ++n_comp;
            }
        };
        for (const Factor& f : fac) {
            if (f.kind == F_DISTANT) {
                close_comp();
                cur_m = f.len;
                cur_l = 0;
                pend = 0;
            } else if (f.kind == F_CLOSE) {
                cur_m += f.len;
                cur_l += pend;
                pend = 0;
            } else {
                pend += f.len;
            }
        }
        close_comp();
        out[0] = tot_m;
        out[1] = tot_l;
        out[2] = n_comp;
    }

    // Local-alignment regions for the --out-alignment path
    // (parser.cpp:786-837).
    void regions(std::vector<Region>& out) const {
        out.clear();
        Region cur{-1, -1, -1, -1, 0, 0};
        int pend = 0;
        auto flush = [&]() {
            if (cur.q_hi - cur.q_lo >= cfg.reg) out.push_back(cur);
        };
        auto grow = [&](const Factor& f) {
            if (cur.ref_lo < 0 || f.rpos < cur.ref_lo) cur.ref_lo = f.rpos;
            if (cur.ref_hi < 0 || f.rpos + f.len > cur.ref_hi) cur.ref_hi = f.rpos + f.len;
            if (cur.q_lo < 0 || f.dpos < cur.q_lo) cur.q_lo = f.dpos;
            if (cur.q_hi < 0 || f.dpos + f.len > cur.q_hi) cur.q_hi = f.dpos + f.len;
            cur.n_match += f.len;
        };
        for (const Factor& f : fac) {
            if (f.kind == F_DISTANT) {
                flush();
                cur = {-1, -1, -1, -1, 0, 0};
                grow(f);
                pend = 0;
            } else if (f.kind == F_CLOSE) {
                cur.ref_hi += pend;
                cur.q_hi += pend;
                cur.n_mismatch += pend;
                pend = 0;
                grow(f);
            } else {
                pend += f.len;
            }
        }
        flush();
        std::stable_sort(out.begin(), out.end(), [](const Region& a, const Region& b) {
            int la = a.q_hi - a.q_lo, lb = b.q_hi - b.q_lo;
            if (la != lb) return la > lb;
            return a.q_lo < b.q_lo;
        });
    }
};

// --------------------------------------------------------------------------
// Three-in-byte packed storage codec (radix 216; byte = c0*36 + c1*6 + c2).
// Host-arena parity with the reference reservoir (seq_reservoir.h:30-186,
// packing seq_reservoir.cpp:22-58): the Python store keeps sequences packed
// at 1/3 B per symbol and the all2all driver unpacks per reference row /
// per query exactly like the reference's seq_view.unpack (parser.cpp:37-50).
// --------------------------------------------------------------------------
struct Pack3LUT {
    uint8_t t[256][3];
    Pack3LUT() {
        for (int b = 0; b < 256; ++b) {
            t[b][0] = (uint8_t)((b / 36) % 6);
            t[b][1] = (uint8_t)((b / 6) % 6);
            t[b][2] = (uint8_t)(b % 6);
        }
    }
};
static const Pack3LUT PACK3;

static void unpack3_into(const uint8_t* packed, int64_t n_sym,
                         std::vector<uint8_t>& out) {
    out.resize((size_t)n_sym);
    int64_t full = n_sym / 3;
    uint8_t* o = out.data();
    for (int64_t b = 0; b < full; ++b) {
        const uint8_t* c = PACK3.t[packed[b]];
        o[0] = c[0];
        o[1] = c[1];
        o[2] = c[2];
        o += 3;
    }
    for (int64_t i = 3 * full; i < n_sym; ++i)
        *o++ = PACK3.t[packed[i / 3]][i % 3];
}

// --------------------------------------------------------------------------
// FASTA ingest: raw FASTA bytes -> the store's packed codes in one pass
// (the reservoir's loader, seq_reservoir.cpp:90-212, with the codec above).
// A file is fed in chunks of any size; the parser's state (at a line's
// start, in a header, in a sequence line) carries over between them.
//   * ACGTacgt -> 0..3, '\r' and '\n' dropped, every other byte -> 5
//   * '>' opens a header only at the start of a line
//   * multisample: one record per header, named by the header with its
//     trailing '\r's stripped and cut at the first space; a record whose
//     stripped header is empty is dropped with its body; content before
//     the first header is dropped
//   * per file: one record for the whole file (named by the caller);
//     lines before the first header are sequence, and each header line
//     appends `sep_len` symbols of code 5 once the record is non-empty
// Packed bytes are c0*36 + c1*6 + c2, trailing slots padded with 0.
// Finished records wait in one arena until the caller takes them; the
// open record's bytes follow them in the same arena.
// --------------------------------------------------------------------------
constexpr uint8_t ING_SKIP = 0xff;
constexpr uint16_t ING_BAD = 0x100;   // a skipped byte in a table's sum

// code of each byte; and each position's share of a packed byte, the
// first two positions' in one table indexed by both bytes, ING_BAD for
// '\r' and '\n'
struct IngestLUT {
    uint8_t code[256];
    uint16_t third[256];
    uint16_t pair[65536];
    IngestLUT() {
        std::memset(code, SYM_N_SEQ, sizeof code);
        const char* acgt = "ACGT";
        for (int c = 0; c < 4; ++c) {
            code[(uint8_t)acgt[c]] = (uint8_t)c;
            code[(uint8_t)(acgt[c] | 0x20)] = (uint8_t)c;
        }
        code[(uint8_t)'\r'] = code[(uint8_t)'\n'] = ING_SKIP;
        auto share = [&](int b, int w) -> uint16_t {
            return code[b] == ING_SKIP ? ING_BAD : (uint16_t)(code[b] * w);
        };
        for (int b = 0; b < 256; ++b) third[b] = share(b, 1);
        for (int x = 0; x < 65536; ++x)   // bytes x & 255, then x >> 8
            pair[x] = (uint16_t)(share(x & 255, 36) + share(x >> 8, 6));
    }
};
static const IngestLUT ING_LUT;

struct Ingest {
    enum State : uint8_t { LINE_START, HEADER, SEQ };

    bool per_file;
    int64_t sep_len;
    State state = LINE_START;
    bool open;                    // a record takes the sequence lines
    std::string header;           // the open record's header so far
    uint32_t acc = 0;             // codes not yet in a byte, radix 6
    int k = 0;                    // how many (0..2)
    int64_t n_sym = 0;            // the open record's symbols
    std::vector<uint8_t> arena;   // finished records, then the open one
    size_t used = 0;              // arena bytes written
    size_t rec_start = 0;         // the open record's first byte
    std::vector<int64_t> off{0}, slen, name_off{0};
    std::string names;

    Ingest(bool pf, int64_t sep) : per_file(pf), sep_len(sep), open(pf) {}

    uint8_t* room(size_t n) {
        if (used + n > arena.size())
            arena.resize(std::max(used + n, 2 * arena.size()));
        return arena.data() + used;
    }

    inline void push(uint8_t c, uint8_t*& o) {
        acc = acc * 6 + c;
        if (++k == 3) {
            *o++ = (uint8_t)acc;
            acc = 0;
            k = 0;
        }
    }

    // code and pack the bytes [p, e) of the open record, dropping '\r' and
    // '\n': whole triples through the tables while no byte is dropped,
    // byte by byte around a dropped one
    void code(const uint8_t* p, const uint8_t* e) {
        uint8_t* o0 = room((size_t)(e - p) / 3 + 1);
        uint8_t* o = o0;
        const IngestLUT& t = ING_LUT;
        const uint8_t* s = p;
        int64_t dropped = 0;
        while (p < e) {
            if (k == 0) {
                while (e - p >= 6) {
                    uint32_t v = t.pair[p[0] | p[1] << 8] + t.third[p[2]];
                    uint32_t w = t.pair[p[3] | p[4] << 8] + t.third[p[5]];
                    if ((v | w) & (3 * ING_BAD)) break;
                    o[0] = (uint8_t)v;
                    o[1] = (uint8_t)w;
                    o += 2;
                    p += 6;
                }
                while (e - p >= 3) {
                    uint32_t v = t.pair[p[0] | p[1] << 8] + t.third[p[2]];
                    if (v & (3 * ING_BAD)) break;
                    *o++ = (uint8_t)v;
                    p += 3;
                }
                if (p == e) break;
            }
            uint8_t c = t.code[*p++];
            if (c == ING_SKIP)
                ++dropped;
            else
                push(c, o);
        }
        n_sym += (int64_t)(e - s) - dropped;
        used += (size_t)(o - o0);
    }

    void separator() {
        uint8_t* o0 = room((size_t)sep_len / 3 + 1);
        uint8_t* o = o0;
        for (int64_t i = 0; i < sep_len; ++i) push(SYM_N_SEQ, o);
        n_sym += sep_len;
        used += (size_t)(o - o0);
    }

    // close the open record: keep it (named) or drop it
    void finish() {
        if (k) {
            *room(1) = (uint8_t)(acc * (k == 1 ? 36 : 6));
            ++used;
        }
        size_t hl = header.size();
        while (hl && header[hl - 1] == '\r') --hl;
        if (!per_file && hl == 0) {
            used = rec_start;
        } else {
            size_t cut = per_file ? 0 : std::min(hl, header.find(' '));
            names.append(header, 0, cut);
            name_off.push_back((int64_t)names.size());
            off.push_back((int64_t)used);
            slen.push_back(n_sym);
        }
        header.clear();
        acc = 0;
        k = 0;
        n_sym = 0;
        rec_start = used;
    }

    void feed(const uint8_t* p, const uint8_t* end) {
        while (p < end) {
            if (state == HEADER) {
                const uint8_t* nl =
                    (const uint8_t*)std::memchr(p, '\n', (size_t)(end - p));
                const uint8_t* stop = nl ? nl : end;
                if (!per_file)
                    header.append((const char*)p, (size_t)(stop - p));
                if (!nl) return;
                p = nl + 1;
                state = LINE_START;
                continue;
            }
            if (state == LINE_START && *p == '>') {
                if (per_file) {
                    if (n_sym) separator();
                } else {
                    if (open) finish();
                    open = true;
                }
                state = HEADER;
                ++p;
                continue;
            }
            // sequence lines, up to the next '>' that starts a line
            const uint8_t* q = p + 1;
            while ((q = (const uint8_t*)std::memchr(q, '>', (size_t)(end - q))) &&
                   q[-1] != '\n')
                ++q;
            const uint8_t* stop = q ? q : end;
            if (open) code(p, stop);
            state = stop[-1] == '\n' ? LINE_START : SEQ;
            p = stop;
        }
    }

    // hand the finished records over; the open record moves to the front
    void take(uint8_t* packed, int64_t* packed_off, int64_t* slens,
              char* name_out, int64_t* name_offs) {
        size_t nrec = slen.size();
        std::memcpy(packed, arena.data(), rec_start);
        std::memcpy(packed_off, off.data(), (nrec + 1) * sizeof(int64_t));
        std::memcpy(slens, slen.data(), nrec * sizeof(int64_t));
        std::memcpy(name_out, names.data(), names.size());
        std::memcpy(name_offs, name_off.data(), (nrec + 1) * sizeof(int64_t));
        std::memmove(arena.data(), arena.data() + rec_start, used - rec_start);
        used -= rec_start;
        rec_start = 0;
        off.assign(1, 0);
        slen.clear();
        names.clear();
        name_off.assign(1, 0);
    }
};

}  // namespace lza

// ============================================================================
// C API
// ============================================================================

extern "C" {

typedef struct {
    int32_t mal, msl, mrd, mqd, reg, aw, am, ar;
} lza_cfg;

static lza::Cfg to_cfg(const lza_cfg* c) {
    return lza::Cfg{c->mal, c->msl, c->mrd, c->mqd, c->reg, c->aw, c->am, c->ar};
}

int64_t lza_claim_head(int64_t* ctr);  // defined with lza_claim_tail below

// Parse one (reference, query) pair. Fills stats[3] = {sym_in_matches,
// sym_in_literals, components}. If `regions` is non-null, writes up to `cap`
// regions as 6 int32s each {ref_lo, ref_hi, q_lo, q_hi, n_match, n_mismatch}
// and returns the total region count; otherwise returns 0.
int64_t lza_parse_pair(const uint8_t* ref, int64_t ref_len, const uint8_t* q,
                       int64_t q_len, const lza_cfg* cfg, int32_t* stats,
                       int32_t* regions, int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg));
    lza::Parser p;
    p.set_reference(idx);
    p.set_query(q, q_len);
    p.parse();
    p.stats(stats);
    if (!regions) return 0;
    std::vector<lza::Region> regs;
    p.regions(regs);
    int64_t n = std::min<int64_t>((int64_t)regs.size(), cap);
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(regions + 6 * k, &regs[(size_t)k], 6 * sizeof(int32_t));
    return (int64_t)regs.size();
}

// Per-parse event counters (device-engine design instrumentation):
// out[5] = {match_events, lit_synced, lit_desync, ext_symbols, match_symbols}.
void lza_parse_events(const uint8_t* ref, int64_t ref_len, const uint8_t* q,
                      int64_t q_len, const lza_cfg* cfg, int64_t* out) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg));
    lza::Parser p;
    lza::EventStats ev;
    p.ev = &ev;
    p.set_reference(idx);
    p.set_query(q, q_len);
    p.parse();
    out[0] = ev.match_events;
    out[1] = ev.lit_synced;
    out[2] = ev.lit_desync;
    out[3] = ev.ext_symbols;
    out[4] = ev.match_symbols;
}

// Finalize a device-produced pseudo-factor stream: expand it against the
// composite buffers rebuilt from raw codes, then compute stats (and regions
// when a buffer is given). Returns region count, or -1 on malformed input.
int64_t lza_pseudo_finalize(const uint8_t* ref, int64_t ref_len,
                            const uint8_t* q, int64_t q_len,
                            const lza_cfg* cfg, const int32_t* pf,
                            int64_t npf, int32_t* stats, int32_t* regions,
                            int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg), /*tables=*/false);
    lza::Parser p;
    p.set_reference(idx);
    p.set_query(q, q_len, /*streams=*/false);
    if (!p.expand_pseudo(pf, npf)) return -1;
    p.stats(stats);
    if (!regions) return 0;
    std::vector<lza::Region> regs;
    p.regions(regs);
    int64_t n = std::min<int64_t>((int64_t)regs.size(), cap);
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(regions + 6 * k, &regs[(size_t)k], 6 * sizeof(int32_t));
    return (int64_t)regs.size();
}

// Replay a device event log: rebuild buffers, replay emissions, compute
// stats (+regions when given). Returns region count, or -1 on an
// inconsistent log (including bwd/ext mismatches with the reference scans).
int64_t lza_replay_finalize(const uint8_t* ref, int64_t ref_len,
                            const uint8_t* q, int64_t q_len,
                            const lza_cfg* cfg, const int32_t* ev,
                            int64_t nev, int32_t* stats, int32_t* regions,
                            int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg), /*tables=*/false);
    lza::Parser p;
    p.set_reference(idx);
    p.set_query(q, q_len, /*streams=*/false);
    if (!p.replay_events(ev, nev)) return -1;
    p.stats(stats);
    if (!regions) return 0;
    std::vector<lza::Region> regs;
    p.regions(regs);
    int64_t n = std::min<int64_t>((int64_t)regs.size(), cap);
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(regions + 6 * k, &regs[(size_t)k], 6 * sizeof(int32_t));
    return (int64_t)regs.size();
}

// Replay to raw factors (kernel validation aid).
int64_t lza_replay_factors(const uint8_t* ref, int64_t ref_len,
                           const uint8_t* q, int64_t q_len,
                           const lza_cfg* cfg, const int32_t* ev, int64_t nev,
                           int32_t* out, int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg), /*tables=*/false);
    lza::Parser p;
    p.set_reference(idx);
    p.set_query(q, q_len, /*streams=*/false);
    if (!p.replay_events(ev, nev)) return -1;
    int64_t n = std::min<int64_t>((int64_t)p.fac.size(), cap);
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(out + 4 * k, &p.fac[(size_t)k], 4 * sizeof(int32_t));
    return (int64_t)p.fac.size();
}

// Dump the event log of a full native parse (kernel validation aid):
// 8 int32 per event {i_ev, best_pos, best_len, bwd, ext, 0,0,0}.
int64_t lza_parse_event_log(const uint8_t* ref, int64_t ref_len,
                            const uint8_t* q, int64_t q_len,
                            const lza_cfg* cfg, int32_t* out, int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg));
    lza::Parser p;
    lza::EventLogSink sink;
    p.evlog = &sink;
    p.set_reference(idx);
    p.set_query(q, q_len);
    p.parse();
    int64_t n = std::min<int64_t>((int64_t)sink.rec.size() / 8, cap);
    for (int64_t k = 0; k < 8 * n; ++k) out[k] = sink.rec[(size_t)k];
    return (int64_t)(sink.rec.size() / 8);
}

// Expand a pseudo-factor stream to real factors (kernel validation aid).
int64_t lza_expand_pseudo(const uint8_t* ref, int64_t ref_len,
                          const uint8_t* q, int64_t q_len, const lza_cfg* cfg,
                          const int32_t* pf, int64_t npf, int32_t* out,
                          int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg), /*tables=*/false);
    lza::Parser p;
    p.set_reference(idx);
    p.set_query(q, q_len, /*streams=*/false);
    if (!p.expand_pseudo(pf, npf)) return -1;
    int64_t n = std::min<int64_t>((int64_t)p.fac.size(), cap);
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(out + 4 * k, &p.fac[(size_t)k], 4 * sizeof(int32_t));
    return (int64_t)p.fac.size();
}

// Dump the raw factor list for a pair (debug aid for kernel validation).
// Factors are written as 4 int32s {dpos, kind, rpos, len}; returns the count.
int64_t lza_parse_factors(const uint8_t* ref, int64_t ref_len, const uint8_t* q,
                          int64_t q_len, const lza_cfg* cfg, int32_t* out,
                          int64_t cap) {
    lza::RefIndex idx;
    idx.build(ref, ref_len, to_cfg(cfg));
    lza::Parser p;
    p.set_reference(idx);
    p.set_query(q, q_len);
    p.parse();
    int64_t n = std::min<int64_t>((int64_t)p.fac.size(), cap);
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(out + 4 * k, &p.fac[(size_t)k], 4 * sizeof(int32_t));
    return (int64_t)p.fac.size();
}

// Threaded all-vs-all driver (scheduling mirrors lz_matcher.cpp:172-277:
// dynamic reference rows, one index build amortised over all queries).
//
//   seqs/offs/n  : concatenated uint8 codes; offs has n+1 int64 entries
//   indptr/ids   : optional CSR pair filter (indptr: n+1 int64); NULL = dense
//   out          : int32 triples; dense layout row r, query q ->
//                  (r*(n-1) + (q>r ? q-1 : q)) * 3; CSR layout -> entry index * 3
//   region_path  : optional binary dump of regions per pair:
//                  {i32 ref_id, i32 q_id, i32 n_regions, n*6 i32}
//   flt_*        : when flt_enabled, pairs failing the gani/ani/qcov
//                  pre-filter are skipped in the region dump
//                  (lz_matcher.cpp:115-138)
// Returns 0 on success.
}  // extern "C" (template below needs C++ linkage)

// Shared driver body: GetSeq is a callable (i, scratch) -> {ptr, len}
// materializing sequence i (zero-copy for the unpacked layout; a per-worker
// unpack for the packed arena — the reference's own per-row/per-pair unpack,
// parser.cpp:37-50 via seq_view.unpack).
template <class GetSeq>
static int32_t all2all_run(GetSeq get_seq, int64_t n, const int64_t* indptr,
                           const int32_t* ids, const lza_cfg* cfg,
                           int32_t n_threads, int32_t* out,
                           const char* region_path, int32_t flt_enabled,
                           double flt_gani, double flt_ani, double flt_qcov,
                           int64_t* progress, int64_t* ext_next_row) {
    // progress (optional, polled by the host): [0]=rows done, [1]=pairs done
    // ext_next_row (optional): external shared two-ended row queue packed
    // as {tail:32 | head:32} — when given, workers claim rows from the
    // HEAD (longest-first, the reference's P7 schedule) while another
    // scheduler (the TPU driver's hybrid mode) claims the short cheap
    // rows from the TAIL of the same queue (the P1 dynamic-row
    // scheduling of lz_matcher.cpp:184-270 extended across heterogeneous
    // executors)
    std::atomic<int64_t> next_row{0};
    std::FILE* rf = nullptr;
    std::mutex rf_mtx;
    if (region_path) {
        rf = std::fopen(region_path, "wb");
        if (!rf) return 1;
    }

    auto worker = [&]() {
        lza::RefIndex idx;
        lza::Parser p;
        std::vector<lza::Region> regs;
        std::vector<int32_t> rec;
        std::vector<uint8_t> scratch;  // packed-arena unpack target
        while (true) {
            int64_t r = ext_next_row ? lza_claim_head(ext_next_row)
                                     : next_row.fetch_add(1);
            if (r < 0 || r >= n) break;
            auto [r_ptr, r_len] = get_seq(r, scratch);
            idx.build(r_ptr, r_len, to_cfg(cfg));
            p.set_reference(idx);

            int64_t lo = indptr ? indptr[r] : 0;
            int64_t hi = indptr ? indptr[r + 1] : n;
            for (int64_t e = lo; e < hi; ++e) {
                int64_t q = indptr ? (int64_t)ids[e] : e;
                if (!indptr && q == r) continue;
                auto [q_ptr, q_len] = get_seq(q, scratch);
                p.set_query(q_ptr, q_len);
                p.parse();

                int64_t slot =
                    indptr ? e : (r * (n - 1) + (q > r ? q - 1 : q));
                p.stats(out + 3 * slot);

                if (rf) {
                    p.regions(regs);
                    int64_t m = 0, l = 0;
                    for (const auto& g : regs) {
                        m += g.n_match;
                        l += g.n_mismatch;
                    }
                    bool keep = true;
                    if (flt_enabled) {
                        double gani = (double)m / (double)q_len;
                        double ani = (m + l) ? (double)m / (double)(m + l) : 0.0;
                        double qcov = (double)(m + l) / (double)q_len;
                        keep = gani >= flt_gani && ani >= flt_ani && qcov >= flt_qcov;
                    }
                    if (keep) {
                        rec.clear();
                        rec.push_back((int32_t)r);
                        rec.push_back((int32_t)q);
                        rec.push_back((int32_t)regs.size());
                        for (const auto& g : regs) {
                            const int32_t* gp = (const int32_t*)&g;
                            rec.insert(rec.end(), gp, gp + 6);
                        }
                        std::lock_guard<std::mutex> lk(rf_mtx);
                        std::fwrite(rec.data(), sizeof(int32_t), rec.size(), rf);
                    }
                }
                if (progress)
                    __atomic_add_fetch(&progress[1], 1, __ATOMIC_RELAXED);
            }
            if (progress)
                __atomic_add_fetch(&progress[0], 1, __ATOMIC_RELAXED);
        }
    };

    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int32_t t = 0; t < n_threads; ++t) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    if (rf) std::fclose(rf);
    return 0;
}

extern "C" {

int32_t lza_all2all(const uint8_t* seqs, const int64_t* offs, int64_t n,
                    const int64_t* indptr, const int32_t* ids,
                    const lza_cfg* cfg, int32_t n_threads, int32_t* out,
                    const char* region_path, int32_t flt_enabled,
                    double flt_gani, double flt_ani, double flt_qcov,
                    int64_t* progress, int64_t* ext_next_row) {
    auto get_seq = [seqs, offs](int64_t i, std::vector<uint8_t>&)
        -> std::pair<const uint8_t*, int64_t> {
        return {seqs + offs[i], offs[i + 1] - offs[i]};
    };
    return all2all_run(get_seq, n, indptr, ids, cfg, n_threads, out,
                       region_path, flt_enabled, flt_gani, flt_ani, flt_qcov,
                       progress, ext_next_row);
}

// Packed-storage variant (U3 parity: memory_monotonic.h:137-184 +
// seq_reservoir 3-in-byte density). Item i is ceil(slens[i]/3) packed
// bytes at address ptrs[i] (uintptr_t) and decodes to slens[i] symbols;
// workers unpack the reference once per row and each query per pair,
// exactly the reference's own schedule (prepare_reference/prepare_data,
// parser.cpp:16-50). A pointer table instead of one arena means the host
// never materializes a concatenated copy.
int32_t lza_all2all_packed(const uint64_t* ptrs, const int64_t* slens,
                           int64_t n, const int64_t* indptr,
                           const int32_t* ids, const lza_cfg* cfg,
                           int32_t n_threads, int32_t* out,
                           const char* region_path, int32_t flt_enabled,
                           double flt_gani, double flt_ani, double flt_qcov,
                           int64_t* progress, int64_t* ext_next_row) {
    auto get_seq = [ptrs, slens](int64_t i, std::vector<uint8_t>& scratch)
        -> std::pair<const uint8_t*, int64_t> {
        lza::unpack3_into((const uint8_t*)(uintptr_t)ptrs[i], slens[i],
                          scratch);
        return {scratch.data(), slens[i]};
    };
    return all2all_run(get_seq, n, indptr, ids, cfg, n_threads, out,
                       region_path, flt_enabled, flt_gani, flt_ani, flt_qcov,
                       progress, ext_next_row);
}

// ----------------------------------------------------------------------------
// Parallel ordered TSV formatter — the native analog of the reference's
// multi-threaded store_results + parallel_priority_queue
// (lz_matcher.cpp:371-567, parallel-queues.h:204-335). Workers format whole
// reference-row chunks; a writer thread streams them in ref-id order through
// a buffered FILE*, so the full table is never held in memory.
// ----------------------------------------------------------------------------

namespace lzfmt {

static const uint64_t P10[20] = {
    1ull, 10ull, 100ull, 1000ull, 10000ull, 100000ull, 1000000ull,
    10000000ull, 100000000ull, 1000000000ull, 10000000000ull,
    100000000000ull, 1000000000000ull, 10000000000000ull,
    100000000000000ull, 1000000000000000ull, 10000000000000000ull,
    100000000000000000ull, 1000000000000000000ull,
    10000000000000000000ull};

// Exact equivalent of utils/textnum.py::format_real (which itself matches
// refresh::real_to_pchar, numeric_conversions.h:229-300,341-388):
// shortest round-trip decimal (std::to_chars, same digits as dragonbox),
// rounded half-up to `prec` significant digits, plain/scientific layout.
static int fmt_real(double val, int prec, char* out) {
    if (val == 0.0) { out[0] = '0'; return 1; }
    if (std::isnan(val)) { std::memcpy(out, "nan", 3); return 3; }
    if (std::isinf(val)) {
        if (val < 0) { std::memcpy(out, "-inf", 4); return 4; }
        std::memcpy(out, "inf", 3); return 3;
    }
    if (prec < 1) prec = 1;
    if (prec > 15) prec = 15;
    bool neg = val < 0;
    double a = neg ? -val : val;
    char buf[40];
    auto res = std::to_chars(buf, buf + sizeof(buf), a);
    int n = (int)(res.ptr - buf);
    uint64_t sig = 0;
    int frac_len = 0, eval = 0, esign = 1;
    bool in_frac = false, in_exp = false;
    for (int k = 0; k < n; ++k) {
        char c = buf[k];
        if (c == '.') in_frac = true;
        else if (c == 'e' || c == 'E') in_exp = true;
        else if (in_exp) {
            if (c == '-') esign = -1;
            else if (c != '+') eval = eval * 10 + (c - '0');
        } else {
            sig = sig * 10 + (uint64_t)(c - '0');
            if (in_frac) frac_len++;
        }
    }
    int exp10 = esign * eval - frac_len;
    while (sig && sig % 10 == 0) { sig /= 10; exp10++; }
    int n_dig = 1;
    for (uint64_t t = sig; t >= 10; t /= 10) n_dig++;
    if (n_dig > prec) {
        int drop = n_dig - prec;
        sig = (sig + P10[drop] / 2) / P10[drop];
        exp10 += drop;
        n_dig = prec;
        if (sig >= P10[prec]) { sig /= 10; exp10++; }
    }
    char dig[24];
    {
        char tmp[24];
        int m = 0;
        uint64_t t = sig;
        do { tmp[m++] = (char)('0' + t % 10); t /= 10; } while (t);
        for (int k = 0; k < m; ++k) dig[k] = tmp[m - 1 - k];
        n_dig = m;
    }
    char* w = out;
    if (neg) *w++ = '-';
    if (exp10 == 0) {
        std::memcpy(w, dig, (size_t)n_dig); w += n_dig;
    } else if (exp10 > 0 || -exp10 >= n_dig + 4) {
        int e;
        if (n_dig == 1) { *w++ = dig[0]; e = exp10; }
        else {
            *w++ = dig[0]; *w++ = '.';
            std::memcpy(w, dig + 1, (size_t)(n_dig - 1)); w += n_dig - 1;
            e = exp10 + n_dig - 1;
        }
        *w++ = 'e';
        *w++ = e < 0 ? '-' : '+';
        int ae = e < 0 ? -e : e;
        if (ae >= 100) { *w++ = (char)('0' + ae / 100); ae %= 100; }
        *w++ = (char)('0' + ae / 10);
        *w++ = (char)('0' + ae % 10);
    } else if (-exp10 < n_dig) {
        int dot = n_dig + exp10;
        std::memcpy(w, dig, (size_t)dot); w += dot;
        *w++ = '.';
        std::memcpy(w, dig + dot, (size_t)(n_dig - dot)); w += n_dig - dot;
    } else {
        *w++ = '0'; *w++ = '.';
        for (int k = 0; k < -exp10 - n_dig; ++k) *w++ = '0';
        std::memcpy(w, dig, (size_t)n_dig); w += n_dig;
    }
    return (int)(w - out);
}

static void app_real(std::string& s, double v, int prec) {
    char b[40];
    s.append(b, (size_t)fmt_real(v, prec, b));
}

static void app_int(std::string& s, int64_t v) {
    char b[24];
    auto r = std::to_chars(b, b + sizeof(b), v);
    s.append(b, (size_t)(r.ptr - b));
}

// Column ids — must match native_engine.COLUMN_IDS / params registry.
enum {
    COL_RIDX = 0, COL_QIDX, COL_REFERENCE, COL_QUERY, COL_QCOV, COL_RCOV,
    COL_GANI, COL_RLEN, COL_QLEN, COL_LEN_RATIO, COL_ANI, COL_NUM_ALNS,
    COL_NT_MISMATCH, COL_NT_MATCH, COL_TANI
};

}  // namespace lzfmt

// Stream the results TSV (two lines per surviving pair, reference row-major)
// to out_path. Layouts:
//   dense (indptr == NULL): triples slot (r, q) = r*(n-1) + (q>r ? q-1 : q)
//   CSR: entry e of row r covers query ids[e], triple = triples + 3*e;
//        per-row entries are sorted by id (stable) before emission, and the
//        mirror lookup takes the first entry (output.ResultMatrix.from_csr)
// names_blob/name_offs: concatenated latin-1 names (n+1 offsets).
// lens: per-sequence corrected lengths. comps: column ids in output order.
// header: full header line including trailing newline.
// Returns 0 on success, 1 on I/O failure.
int32_t lza_format_results(
    const int32_t* triples, int64_t n, const int64_t* indptr,
    const int32_t* ids, const int64_t* lens, const char* names_blob,
    const int64_t* name_offs, const int32_t* comps, int32_t n_comps,
    int32_t in_percent, int32_t flt_enabled, double f_gani, double f_ani,
    double f_tani, double f_qcov, double f_rcov, int32_t n_threads,
    const char* out_path, const char* header) {
    using namespace lzfmt;
    std::FILE* fh = std::fopen(out_path, "wb");
    if (!fh) return 1;
    std::vector<char> fbuf(1u << 25);
    std::setvbuf(fh, fbuf.data(), _IOFBF, fbuf.size());
    std::fwrite(header, 1, std::strlen(header), fh);

    double mult = in_percent ? 100.0 : 1.0;

    // CSR: per-row stable sort by query id (entry order preserved on ties).
    std::vector<int64_t> sorted_e;   // entry indices, rows back to back
    std::vector<int32_t> sorted_id;  // ids in the same order
    if (indptr) {
        int64_t E = indptr[n];
        sorted_e.resize((size_t)E);
        sorted_id.resize((size_t)E);
        for (int64_t r = 0; r < n; ++r) {
            int64_t lo = indptr[r], hi = indptr[r + 1];
            for (int64_t e = lo; e < hi; ++e) sorted_e[(size_t)e] = e;
            std::stable_sort(
                sorted_e.begin() + lo, sorted_e.begin() + hi,
                [&](int64_t a, int64_t b) { return ids[a] < ids[b]; });
            for (int64_t e = lo; e < hi; ++e)
                sorted_id[(size_t)e] = ids[sorted_e[(size_t)e]];
        }
    }

    // first entry of row `row` with id `want`; -1 when absent
    auto first_entry = [&](int64_t row, int32_t want) -> int64_t {
        int64_t lo = indptr[row], hi = indptr[row + 1];
        const int32_t* base = sorted_id.data();
        const int32_t* it =
            std::lower_bound(base + lo, base + hi, want);
        if (it == base + hi || *it != want) return -1;
        return sorted_e[(size_t)(it - base)];
    };

    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next_row{0};
    std::vector<std::string> chunks((size_t)n);
    std::vector<uint8_t> done((size_t)n, 0);
    std::mutex mx;
    std::condition_variable cv_ready, cv_space;
    int64_t wpos = 0;
    const int64_t window = 4 * (int64_t)n_threads + 4;
    bool io_error = false;

    auto worker = [&]() {
        std::string s;
        char nb[40];
        while (true) {
            int64_t r = next_row.fetch_add(1);
            if (r >= n) break;
            {   // backpressure: stay within `window` rows of the writer
                std::unique_lock<std::mutex> lk(mx);
                cv_space.wait(lk, [&] { return r < wpos + window; });
            }
            s.clear();
            int64_t lo = indptr ? indptr[r] : 0;
            int64_t hi = indptr ? indptr[r + 1] : 0;
            int64_t e_or_q = indptr ? lo : r + 1;
            int64_t end = indptr ? hi : n;
            for (; e_or_q < end; ++e_or_q) {
                int64_t q, t_fwd;
                if (indptr) {
                    int64_t e = sorted_e[(size_t)e_or_q];
                    q = ids[e];
                    if (q <= r) continue;
                    t_fwd = 3 * e;
                } else {
                    q = e_or_q;
                    t_fwd = 3 * (r * (n - 1) + q - 1);
                }
                int64_t t_rev;
                if (indptr) {
                    int64_t e2 = first_entry(q, (int32_t)r);
                    if (e2 < 0) continue;  // asserted symmetric upstream
                    t_rev = 3 * e2;
                } else {
                    t_rev = 3 * (q * (n - 1) + r);
                }
                // direction index 0 = (query=q, reference=r)
                int64_t idv[2] = {r, q};
                int64_t ln[2] = {lens[q], lens[r]};
                int64_t si_mat[2] = {triples[t_fwd], triples[t_rev]};
                int64_t si_lit[2] = {triples[t_fwd + 1], triples[t_rev + 1]};
                int64_t no_reg[2] = {triples[t_fwd + 2], triples[t_rev + 2]};
                double tani = (double)(si_mat[0] + si_mat[1]) /
                              (double)(ln[0] + ln[1]);
                double gani[2], ani[2], cov[2];
                for (int i = 0; i < 2; ++i) {
                    gani[i] = (double)si_mat[i] / (double)ln[i];
                    ani[i] = (si_mat[i] + si_lit[i])
                                 ? (double)si_mat[i] /
                                       (double)(si_mat[i] + si_lit[i])
                                 : 0.0;
                    cov[i] = (double)(si_mat[i] + si_lit[i]) / (double)ln[i];
                }
                int lr_len = 0;
                if (ln[0] && ln[1]) {
                    double lr = ln[0] < ln[1]
                                    ? (double)ln[0] / (double)ln[1]
                                    : (double)ln[1] / (double)ln[0];
                    lr_len = fmt_real(lr, 4, nb);
                } else {
                    nb[0] = '0';
                    lr_len = 1;
                }
                for (int i = 0; i < 2; ++i) {
                    int j = 1 - i;
                    if (flt_enabled &&
                        (gani[i] < f_gani || ani[i] < f_ani ||
                         tani < f_tani || cov[i] < f_qcov ||
                         cov[j] < f_rcov))
                        continue;
                    for (int32_t c = 0; c < n_comps; ++c) {
                        if (c) s.push_back('\t');
                        switch (comps[c]) {
                            case COL_RIDX: app_int(s, idv[i]); break;
                            case COL_QIDX: app_int(s, idv[j]); break;
                            case COL_REFERENCE:
                                s.append(names_blob + name_offs[idv[i]],
                                         (size_t)(name_offs[idv[i] + 1] -
                                                  name_offs[idv[i]]));
                                break;
                            case COL_QUERY:
                                s.append(names_blob + name_offs[idv[j]],
                                         (size_t)(name_offs[idv[j] + 1] -
                                                  name_offs[idv[j]]));
                                break;
                            case COL_QCOV: app_real(s, mult * cov[i], 6); break;
                            case COL_RCOV: app_real(s, mult * cov[j], 6); break;
                            case COL_GANI: app_real(s, mult * gani[i], 6); break;
                            case COL_RLEN: app_int(s, ln[j]); break;
                            case COL_QLEN: app_int(s, ln[i]); break;
                            case COL_LEN_RATIO:
                                s.append(nb, (size_t)lr_len); break;
                            case COL_ANI: app_real(s, mult * ani[i], 6); break;
                            case COL_NUM_ALNS: app_int(s, no_reg[i]); break;
                            case COL_NT_MISMATCH: app_int(s, si_lit[i]); break;
                            case COL_NT_MATCH: app_int(s, si_mat[i]); break;
                            case COL_TANI: app_real(s, mult * tani, 6); break;
                        }
                    }
                    s.push_back('\n');
                }
            }
            std::lock_guard<std::mutex> lk(mx);
            chunks[(size_t)r].swap(s);
            done[(size_t)r] = 1;
            cv_ready.notify_all();
        }
    };

    std::thread writer([&]() {
        while (wpos < n) {
            std::string chunk;
            {
                std::unique_lock<std::mutex> lk(mx);
                cv_ready.wait(lk, [&] { return done[(size_t)wpos] != 0; });
                chunk.swap(chunks[(size_t)wpos]);
            }
            if (!chunk.empty() &&
                std::fwrite(chunk.data(), 1, chunk.size(), fh) !=
                    chunk.size())
                io_error = true;
            {
                std::lock_guard<std::mutex> lk(mx);
                wpos++;
                cv_space.notify_all();
            }
        }
    });

    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int32_t t = 0; t < n_threads; ++t) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    writer.join();
    if (std::fclose(fh) != 0) io_error = true;
    return io_error ? 1 : 0;
}

// ----------------------------------------------------------------------------
// Parallel kmer-db filter parse — the native analog of the reference's
// reader + N-parser pipeline with sharded symmetrization
// (filter.cpp:95-289). The caller hands the decompressed CSV body (all
// lines after the header); rows are tokenized on a thread pool and the
// symmetrized CSR is built in one pass.
//
// Semantics (matching io/kmerdb_filter.py and filter.cpp):
//   * a line whose content (after stripping trailing \r) is <= 2 chars is
//     skipped and does not consume a row id
//   * tokens are comma-separated; one trailing empty token is dropped
//   * a token must contain exactly one ':' to count; id is 1-based
//   * val >= thr keeps the pair; both directions are stored
//
// Returns the total number of CSR entries (= 2 x accepted tokens), or
//   -1 if more data rows than n_rows, -2 on an out-of-range id,
//   -3 if `cap` is too small (caller sizes cap from the ':' count).
// indptr must hold n_rows+1 entries.
int64_t lza_parse_kmerdb(const char* data, int64_t len, double thr,
                         int64_t n_rows, int32_t n_threads, int64_t* indptr,
                         int32_t* ids_out, int64_t cap) {
    struct Line { int64_t off, len; };
    std::vector<Line> lines;
    {
        int64_t pos = 0;
        while (pos < len) {
            const char* nl =
                (const char*)std::memchr(data + pos, '\n', (size_t)(len - pos));
            int64_t end = nl ? (int64_t)(nl - data) : len;
            int64_t l = end - pos;
            while (l > 0 && data[pos + l - 1] == '\r') l--;  // rstrip("\r")
            lines.push_back({pos, l});
            pos = end + 1;
        }
    }
    // row ids: non-short lines only (filter.cpp:104-112)
    std::vector<int64_t> row_of(lines.size());
    int64_t n_used = 0;
    for (size_t k = 0; k < lines.size(); ++k)
        row_of[k] = lines[k].len <= 2 ? -1 : n_used++;
    if (n_used > n_rows) return -1;

    if (n_threads < 1) n_threads = 1;
    int T = (int)std::min<int64_t>(n_threads, (int64_t)lines.size() + 1);
    std::vector<std::vector<std::pair<int32_t, int32_t>>> parts((size_t)T);
    std::atomic<int32_t> bad{0};

    auto parse_range = [&](int t, size_t klo, size_t khi) {
        auto& out = parts[(size_t)t];
        for (size_t k = klo; k < khi && !bad.load(std::memory_order_relaxed);
             ++k) {
            if (row_of[k] < 0) continue;
            int32_t row = (int32_t)row_of[k];
            const char* p = data + lines[k].off;
            const char* lend = p + lines[k].len;
            while (p < lend) {
                const char* tend =
                    (const char*)std::memchr(p, ',', (size_t)(lend - p));
                const char* te = tend ? tend : lend;
                // one trailing empty token is dropped implicitly (te==p at
                // line end contributes nothing)
                const char* colon =
                    (const char*)std::memchr(p, ':', (size_t)(te - p));
                if (colon &&
                    !std::memchr(colon + 1, ':', (size_t)(te - colon - 1))) {
                    char* endp;
                    double val = std::strtod(colon + 1, &endp);
                    if (val >= thr) {
                        long id = std::strtol(p, &endp, 10);
                        int64_t other = (int64_t)id - 1;
                        if (other < 0 || other >= n_rows) {
                            bad.store(2);
                            break;
                        }
                        out.emplace_back(row, (int32_t)other);
                    }
                }
                p = te + 1;
            }
        }
    };

    if (T <= 1) {
        parse_range(0, 0, lines.size());
    } else {
        std::vector<std::thread> ts;
        size_t per = (lines.size() + (size_t)T - 1) / (size_t)T;
        for (int t = 0; t < T; ++t) {
            size_t klo = (size_t)t * per;
            size_t khi = std::min(lines.size(), klo + per);
            if (klo >= khi) break;
            ts.emplace_back(parse_range, t, klo, khi);
        }
        for (auto& th : ts) th.join();
    }
    if (bad.load()) return -2;

    // counts (both directions), prefix, fill
    std::vector<int64_t> cnt((size_t)n_rows, 0);
    int64_t total = 0;
    for (auto& part : parts)
        for (auto& pr : part) {
            cnt[(size_t)pr.first]++;
            cnt[(size_t)pr.second]++;
            total += 2;
        }
    if (total > cap) return -3;
    indptr[0] = 0;
    for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] = indptr[r] + cnt[(size_t)r];
    std::vector<int64_t> cur(indptr, indptr + n_rows);
    for (auto& part : parts)
        for (auto& pr : part) {
            ids_out[cur[(size_t)pr.first]++] = pr.second;
            ids_out[cur[(size_t)pr.second]++] = pr.first;
        }
    return total;
}

// FASTA ingest (lza::Ingest): open a parser for one file, feed it the
// file's bytes in chunks (final != 0 after the last one), and take the
// records each feed finished. A feed returns how many records wait, with
// their packed bytes and their name bytes in sizes[0..1]; take copies
// them out (packed_off and name_offs: n + 1 offsets each) and forgets
// them. Returns -1, and open NULL, when memory runs out.
void* lza_ingest_open(int32_t per_file, int64_t sep_len) {
    try {
        return new lza::Ingest(per_file != 0, sep_len);
    } catch (const std::bad_alloc&) {
        return nullptr;
    }
}

int64_t lza_ingest_feed(void* h, const uint8_t* data, int64_t len,
                        int32_t final, int64_t* sizes) {
    auto* ing = (lza::Ingest*)h;
    try {
        ing->feed(data, data + len);
        if (final && ing->open) ing->finish();
    } catch (const std::bad_alloc&) {
        return -1;
    }
    sizes[0] = (int64_t)ing->rec_start;
    sizes[1] = (int64_t)ing->names.size();
    return (int64_t)ing->slen.size();
}

void lza_ingest_take(void* h, uint8_t* packed, int64_t* packed_off,
                     int64_t* slens, char* names, int64_t* name_offs) {
    ((lza::Ingest*)h)->take(packed, packed_off, slens, names, name_offs);
}

void lza_ingest_close(void* h) { delete (lza::Ingest*)h; }

// Build-info probe so Python can verify the ABI.
// Two-ended shared row queue, packed into one int64 as {tail:32|head:32}
// (init = n << 32). CPU workers pop longest-first rows from the head;
// the device scheduler pops the short cheap rows from the tail. CAS
// loops keep the two ends from ever crossing, so every row is claimed
// exactly once across heterogeneous executors.

int64_t lza_claim_head(int64_t* ctr) {
    int64_t cur = __atomic_load_n(ctr, __ATOMIC_SEQ_CST);
    for (;;) {
        int64_t h = cur & 0xffffffff, t = (uint64_t)cur >> 32;
        if (h >= t) return -1;
        if (__atomic_compare_exchange_n(ctr, &cur, cur + 1, false,
                                        __ATOMIC_SEQ_CST,
                                        __ATOMIC_SEQ_CST))
            return h;
    }
}

// Claim up to k rows from the tail; writes the claimed count to *got and
// returns the first claimed row (the new tail), or -1 when empty.
int64_t lza_claim_tail(int64_t* ctr, int64_t k, int64_t* got) {
    int64_t cur = __atomic_load_n(ctr, __ATOMIC_SEQ_CST);
    for (;;) {
        int64_t h = cur & 0xffffffff, t = (uint64_t)cur >> 32;
        int64_t avail = t - h;
        if (avail <= 0) return -1;
        int64_t kk = avail < k ? avail : k;
        int64_t next = ((t - kk) << 32) | h;
        if (__atomic_compare_exchange_n(ctr, &cur, next, false,
                                        __ATOMIC_SEQ_CST,
                                        __ATOMIC_SEQ_CST)) {
            *got = kk;
            return t - kk;
        }
    }
}

// Replay one downloaded unit of device event logs (the port's collect +
// replay; not in the JAX package's copy of this file): a unit's pairs in
// one call, so a caller's thread pool runs without the interpreter.
//
//   ptrs/slens/packed : the sequences, as lza_all2all_packed takes them
//                       (packed = 1: radix-216 bytes), or packed = 0: raw
//                       codes at ptrs[i]
//   pr/pq/pslot       : each pair's reference, query and triple slot
//                       (out + 3 * slot); a run of consecutive pairs with
//                       one reference builds its composite buffer once
//   pnev/poff         : its log's length and first record in `ev` (int32,
//                       8 a record, as the kernels write them); pnev < 0
//                       means no log (a capacity fallback): the pair is
//                       parsed natively, the reference's tables built at
//                       the run's first such pair
//   n_ev              : records in `ev`; a log past its end is an error
//   n_threads         : the runs are spread over up to this many threads
//                       (1: the calling thread alone)
//   status            : 0 replayed, 1 parsed natively, -1 log rejected
//                       (bwd/ext cross-check; its slot is not written)
//   rec/rec_len       : with want_regions, the region records of the
//                       unit in lza_all2all's dump format {r, q, n, n*6},
//                       after the gani/ani/qcov pre-filter when
//                       flt_enabled (lz_matcher.cpp:115-138); malloc'd,
//                       released with lza_free (NULL when there are none)
// Returns the number of rejected logs, or -2 on malformed input (nothing
// is returned in *rec then). No state outlives the call: concurrent calls
// are safe.
int64_t lza_replay_unit(const uint64_t* ptrs, const int64_t* slens,
                        int32_t packed, const lza_cfg* cfg, int64_t n_pairs,
                        const int32_t* pr, const int32_t* pq,
                        const int64_t* pslot, const int32_t* pnev,
                        const int64_t* poff, const int32_t* ev, int64_t n_ev,
                        int32_t* out, int32_t* status, int32_t want_regions,
                        int32_t flt_enabled, double flt_gani, double flt_ani,
                        double flt_qcov, int32_t n_threads, int32_t** rec,
                        int64_t* rec_len) {
    *rec = nullptr;
    *rec_len = 0;
    for (int64_t k = 0; k < n_pairs; ++k)
        if (pnev[k] >= 0 && (poff[k] < 0 || poff[k] + pnev[k] > n_ev))
            return -2;
    std::vector<int64_t> runs{0};  // [runs[i], runs[i + 1]): one reference
    for (int64_t k = 1; k < n_pairs; ++k)
        if (pr[k] != pr[k - 1]) runs.push_back(k);
    runs.push_back(n_pairs);
    const int64_t n_runs = n_pairs ? (int64_t)runs.size() - 1 : 0;
    const lza::Cfg c = to_cfg(cfg);
    auto get_seq = [&](int64_t i, std::vector<uint8_t>& scratch)
        -> std::pair<const uint8_t*, int64_t> {
        if (!packed) return {(const uint8_t*)(uintptr_t)ptrs[i], slens[i]};
        lza::unpack3_into((const uint8_t*)(uintptr_t)ptrs[i], slens[i],
                          scratch);
        return {scratch.data(), slens[i]};
    };
    std::vector<std::vector<int32_t>> recs((size_t)n_runs);
    std::atomic<int64_t> next_run{0}, rejected{0};

    auto worker = [&]() {
        lza::RefIndex idx;
        lza::Parser p;
        std::vector<uint8_t> r_scratch, q_scratch;
        std::vector<lza::Region> regs;
        for (int64_t i; (i = next_run.fetch_add(1)) < n_runs;) {
            auto rseq = get_seq(pr[runs[i]], r_scratch);
            idx.build(rseq.first, rseq.second, c, /*tables=*/false);
            p.set_reference(idx);
            bool tables = false;
            std::vector<int32_t>& out_rec = recs[(size_t)i];
            for (int64_t k = runs[i]; k < runs[i + 1]; ++k) {
                auto [q_ptr, q_len] = get_seq(pq[k], q_scratch);
                if (pnev[k] < 0) {
                    if (!tables) {
                        idx.build(rseq.first, rseq.second, c);
                        tables = true;
                    }
                    p.set_query(q_ptr, q_len);
                    p.parse();
                    status[k] = 1;
                } else {
                    p.set_query(q_ptr, q_len, /*streams=*/false);
                    if (!p.replay_events(ev + 8 * poff[k], pnev[k])) {
                        status[k] = -1;
                        rejected.fetch_add(1);
                        continue;
                    }
                    status[k] = 0;
                }
                p.stats(out + 3 * pslot[k]);
                if (!want_regions) continue;
                p.regions(regs);
                int64_t m = 0, l = 0;
                for (const auto& g : regs) {
                    m += g.n_match;
                    l += g.n_mismatch;
                }
                if (flt_enabled) {
                    double gani = (double)m / (double)q_len;
                    double ani = (m + l) ? (double)m / (double)(m + l) : 0.0;
                    double qcov = (double)(m + l) / (double)q_len;
                    if (!(gani >= flt_gani && ani >= flt_ani &&
                          qcov >= flt_qcov))
                        continue;
                }
                out_rec.push_back(pr[k]);
                out_rec.push_back(pq[k]);
                out_rec.push_back((int32_t)regs.size());
                for (const auto& g : regs) {
                    const int32_t* gp = (const int32_t*)&g;
                    out_rec.insert(out_rec.end(), gp, gp + 6);
                }
            }
        }
    };

    int64_t nt = std::max<int64_t>(1, std::min<int64_t>(n_threads, n_runs));
    std::vector<std::thread> ts;
    for (int64_t t = 1; t < nt; ++t) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();

    size_t words = 0;
    for (const auto& v : recs) words += v.size();
    if (words) {
        *rec = (int32_t*)std::malloc(words * sizeof(int32_t));
        if (!*rec) return -2;
        int32_t* o = *rec;
        for (const auto& v : recs) {
            std::memcpy(o, v.data(), v.size() * sizeof(int32_t));
            o += v.size();
        }
        *rec_len = (int64_t)words;
    }
    return rejected.load();
}

void lza_free(void* p) { std::free(p); }

int32_t lza_abi_version(void) { return 6; }

}  // extern "C"
