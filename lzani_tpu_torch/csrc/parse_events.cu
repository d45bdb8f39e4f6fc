// ============================================================================
// parse_events.cu - event-log parse kernels of the PyTorch/CUDA port.
//
// Replaces two Pallas TPU kernels that compute the same function with
// different candidate tables:
//   * lzt_parse_events: lzani_tpu/ops/pallas_v7.py make_parse_kernel_sim,
//     launched by pallas_engine.py _get_group_step (the group path);
//   * lzt_parse_events_big: lzani_tpu/ops/pallas_engine.py:307
//     make_parse_kernel(big=True), launched by _get_big_step at :1913
//     (the long-genome path).
// For every (reference g, query b) pair of a dispatch, both compute the
// greedy LZ-parse decision stream of the reference parser
// (parser.cpp:482-716; the C++ oracle is Parser::parse in
// csrc/lzani_core.cpp). Each accepted match logs one 8-int32 record
// {i, pos, len, bwd, ext, 0, 0, 0}; the host replays the log through
// lza_replay_finalize, which rebuilds exact stats/regions and
// cross-checks bwd and ext.
//
// Design: one thread per pair running the scalar automaton of
// Parser::parse, cut down to the decisions that produce events. Its hash
// tables are replaced by the kernel's inputs:
//   * synced seed search: scan [max(0, pred-lit_run), pred+mrd) in
//     ascending order by direct symbol comparison (query N = 5 never
//     equals reference N = 4, so an msl-prefix match implies valid
//     k-mers on both sides); longest wins, then nearest to pred, and an
//     equal distance keeps the earlier position;
//   * anchors: walk poslist[start : start+cnt] with an exact LCE; strict
//     > keeps the smallest position; an anchor at position 0 is ignored
//     only when synced. The candidate table is a template parameter, so
//     both kernels share one automaton:
//       PackedCand   (group path) start << 7 | min(count, 127) per query
//                    position; rows over CNT_CAP fall back on the host;
//       TwoPlaneCand (long-genome path) a start plane and a count plane
//                    per pair, counts unbounded (no pack, no CNT_CAP: the
//                    reference's ht_long probe chains are unbounded too);
//   * arbitration: the host-built WIN bit table (exact replica of the
//     reference's f64 fpow comparison; no f64 on the device, so FMA
//     contraction cannot break bit-exactness);
//   * desync (pred < 0): jump through next_hit to the next position that
//     has anchor candidates;
//   * extensions: the sliding-window scans extend_bwd/extend_fwd; the
//     window's outgoing symbol is re-read instead of kept in a ring;
//   * bwd cap: the pending literal factor after the region-kill merge,
//     carried in (reg_lo, reg_hi, lit_below) as pallas_v7 does.
// Symbols past a buffer's semantic end read as N (4 for the reference,
// 5 for the query), which bounds every LCE and scan without caps. The
// query length dsz is per query on the group path and per pair on the
// long-genome path, where the self pair gets dsz = msl (a no-op).
// Offsets of the per-pair planes are size_t (pair x LqP exceeds 2^31 at
// long-genome sizes); positions fit in int (LrP <= 2^25).
//
// What bounds it: chains of dependent global loads (byte loads of the
// two buffers, candidate/next_hit/poslist/WIN words), one step at a time
// per pair, with heavy divergence across the 32 pairs of a warp. On the
// group path the working set (4 references x <= 1 MB, the queries) sits
// in L2; on the long-genome path a pair streams megabases through L1
// and L2 one line at a time, so a related pair's long forward extension
// is a serial scan of one thread. Latency, not bandwidth, is the limit.
// A warp-per-pair design with lane-parallel seed windows, LCEs and
// extension scans is the next step (later work).
// ============================================================================

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SAT = 27;  // 1 - 4^-l == 1.0 in f64 for l >= 27 (anchor_tables)
constexpr int SYM_N_REF = 4;
constexpr int SYM_N_SEQ = 5;

struct Cfg {
    int mal, msl, mrd, mqd, reg, aw, am, ar;
};

struct Pair {
    const uint8_t* ref;  // composite reference buffer (row g)
    int nr;              // composite length
    const uint8_t* q;    // query buffer (row b)
    int dsz;             // query length + mrd
};

__device__ __forceinline__ int rsym(const Pair& P, int p) {
    return (p >= 0 && p < P.nr) ? (int)P.ref[p] : SYM_N_REF;
}

__device__ __forceinline__ int qsym(const Pair& P, int p) {
    return (p >= 0 && p < P.dsz) ? (int)P.q[p] : SYM_N_SEQ;
}

// Longest common extension of ref[rp..] and q[qp..], known equal below
// `from` (Parser::match_len).
__device__ int lce(const Pair& P, int rp, int qp, int from) {
    int r = from;
    while (rsym(P, rp + r) == qsym(P, qp + r)) ++r;
    return r;
}

__device__ __forceinline__ int miss_at(const Pair& P, int dpos, int rpos,
                                       int e, bool fwd) {
    return fwd ? (qsym(P, dpos + e) != rsym(P, rpos + e))
               : (qsym(P, dpos - 1 - e) != rsym(P, rpos - 1 - e));
}

// Sliding-window approximate extension (Parser::extend_fwd/extend_bwd):
// advance while the mismatches among the last aw symbols stay <= am; the
// result is the longest prefix that ends in a run of >= ar matches.
__device__ int ext_scan(const Pair& P, const Cfg& c, int dpos, int rpos,
                        int max_len, bool fwd) {
    int bad = 0, run = c.ar, last = 0;
    for (int e = 0; e < max_len; ++e) {
        int miss = miss_at(P, dpos, rpos, e, fwd);
        if (e >= c.aw) bad -= miss_at(P, dpos, rpos, e - c.aw, fwd);
        bad += miss;
        if (!miss) {
            if (++run >= c.ar) last = e + 1;
        } else {
            run = 0;
        }
        if (bad > c.am) break;
    }
    return last;
}

// Group path: (G, B, LqP) words start << 7 | min(count, 127).
struct PackedCand {
    const int32_t* cd;
    __device__ PackedCand(const int32_t* cand, int pair, int LqP)
        : cd(cand + (size_t)pair * LqP) {}
    __device__ __forceinline__ void get(int i, int& start, int& cnt) const {
        const int cw = cd[i];
        start = cw >> 7;
        cnt = cw & 127;
    }
};

// Long-genome path: (G, B, 2, LqP) planes, start then unbounded count.
struct TwoPlaneCand {
    const int32_t* st;
    const int32_t* ct;
    __device__ TwoPlaneCand(const int32_t* cand, int pair, int LqP)
        : st(cand + (size_t)pair * 2 * LqP), ct(st + LqP) {}
    __device__ __forceinline__ void get(int i, int& start, int& cnt) const {
        start = st[i];
        cnt = ct[i];
    }
};

// dsz_per_pair: dszs is (G, B) (long-genome path) instead of (B,).
template <class Cand>
__global__ void parse_events_kernel(
    const uint8_t* __restrict__ refbuf, const uint8_t* __restrict__ qbuf,
    const int32_t* __restrict__ poslist, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ next_hit, const uint32_t* __restrict__ win,
    const int32_t* __restrict__ dszs, const int32_t* __restrict__ nrs,
    int32_t* __restrict__ ev, int32_t* __restrict__ nev, int G, int B,
    int LrP, int LqP, int KaP, int WinP, int evc, bool dsz_per_pair,
    Cfg c) {
    const int pair = blockIdx.x * blockDim.x + threadIdx.x;
    if (pair >= G * B) return;
    const int g = pair / B, b = pair % B;
    Pair P;
    P.ref = refbuf + (size_t)g * LrP;
    P.nr = nrs[g];
    P.q = qbuf + (size_t)b * LqP;
    P.dsz = dszs[dsz_per_pair ? pair : b];
    const int32_t* pos = poslist + (size_t)g * KaP;
    const Cand cd(cand, pair, LqP);
    const int32_t* nh = next_hit + (size_t)pair * LqP;
    const uint32_t* wt = win + (size_t)g * WinP;
    int32_t* out = ev + (size_t)pair * evc * 8;

    const int dsz = P.dsz;
    const int limit = dsz - c.msl;  // loop bound: i + msl < dsz
    const int NS = SAT - c.msl + 1, NL = c.mqd + 1;
    int i = 0, pred = -dsz, lit_run = 0;
    int reg_lo = -1, reg_hi = 0, lit_below = 0, ne = 0;

    while (i < limit && ne < evc) {
        if (pred < 0) {
            // desynced: no event before the next anchor candidate
            int j = min(nh[i], limit);
            lit_run += j - i;
            i = j;
            if (i >= limit) break;
        }
        int start, cnt;
        cd.get(i, start, cnt);
        int a_len = 0, a_pos = 0;
        for (int k = 0; k < cnt; ++k) {
            const int p = pos[start + k];
            const int ml = lce(P, p, i, 0);
            if (ml >= c.mal && ml > a_len) {
                a_len = ml;
                a_pos = p;
            }
        }
        int bl = a_len, bp = a_pos;
        if (pred >= 0) {
            int s_len = 0, s_pos = 0;
            const int hi = pred + c.mrd;
            for (int p = max(0, pred - lit_run); p < hi; ++p) {
                int t = 0;
                while (t < c.msl && rsym(P, p + t) == qsym(P, i + t)) ++t;
                if (t < c.msl) continue;
                const int ml = lce(P, p, i, c.msl);
                if (ml > s_len ||
                    (ml == s_len && abs(p - pred) < abs(s_pos - pred))) {
                    s_len = ml;
                    s_pos = p;
                }
            }
            bl = s_len;
            bp = s_pos;
            if (a_pos != 0) {
                bool take = s_pos == 0;
                if (!take) {
                    const int widx =
                        ((min(a_len, SAT) - c.mal) * NS +
                         (min(s_len, SAT) - c.msl)) * NL + lit_run;
                    take = (wt[widx >> 5] >> (widx & 31)) & 1u;
                }
                if (take) {
                    bl = a_len;
                    bp = a_pos;
                }
            }
        }
        if (bl >= c.msl) {
            const bool close = pred >= 0 && abs(bp - pred) <= c.mrd;
            int bwd = 0, tl = 0;
            if (!close) {
                // the pending literal factor after the region-kill merge
                const bool kill = reg_lo >= 0 && reg_hi - reg_lo < c.reg;
                tl = kill ? (i - reg_lo) + lit_below : lit_run;
                if (tl > 0)
                    bwd = ext_scan(P, c, i, bp, min(min(i, bp), tl), false);
            }
            const int i2 = i + bl, pred2 = bp + bl;
            const int ext =
                ext_scan(P, c, i2, pred2, min(dsz - i2, P.nr - pred2), true);
            int32_t* r = out + (size_t)ne * 8;
            r[0] = i;
            r[1] = bp;
            r[2] = bl;
            r[3] = bwd;
            r[4] = ext;
            r[5] = 0;
            r[6] = 0;
            r[7] = 0;
            ++ne;
            if (!close) {
                reg_lo = bwd > 0 ? i - bwd : i;
                lit_below = tl - bwd;
            }
            i = i2 + ext;
            pred = pred2 + ext;
            lit_run = 0;
            reg_hi = i;
        } else {
            ++i;
            if (pred >= 0) ++pred;
            ++lit_run;
            if (lit_run > c.mqd) pred = -dsz;
        }
    }
    nev[pair] = i < limit ? -1 : ne;
}

template <class Cand>
int launch(const void* refbuf, const void* qbuf, const void* poslist,
           const void* cand, const void* next_hit, const void* win,
           const void* dszs, const void* nrs, void* ev, void* nev, int G,
           int B, int LrP, int LqP, int KaP, int WinP, int evc,
           bool dsz_per_pair, const Cfg& c, void* stream) {
    const int n = G * B;
    const int threads = 32;  // one warp per block: 32 consecutive pairs
    const int blocks = (n + threads - 1) / threads;
    if (n > 0)
        parse_events_kernel<Cand>
            <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)refbuf, (const uint8_t*)qbuf,
            (const int32_t*)poslist, (const int32_t*)cand,
            (const int32_t*)next_hit, (const uint32_t*)win,
            (const int32_t*)dszs, (const int32_t*)nrs, (int32_t*)ev,
            (int32_t*)nev, G, B, LrP, LqP, KaP, WinP, evc, dsz_per_pair, c);
    return (int)cudaGetLastError();
}

}  // namespace

// Group path: cand (G, B, LqP) packed, dszs (B,).
extern "C" int lzt_parse_events(
    const void* refbuf, const void* qbuf, const void* poslist,
    const void* cand, const void* next_hit, const void* win,
    const void* dszs, const void* nrs, void* ev, void* nev, int G, int B,
    int LrP, int LqP, int KaP, int WinP, int evc, int mal, int msl, int mrd,
    int mqd, int reg, int aw, int am, int ar, void* stream) {
    return launch<PackedCand>(refbuf, qbuf, poslist, cand, next_hit, win,
                              dszs, nrs, ev, nev, G, B, LrP, LqP, KaP, WinP,
                              evc, false,
                              Cfg{mal, msl, mrd, mqd, reg, aw, am, ar},
                              stream);
}

// Long-genome path: cand (G, B, 2, LqP) two planes, dszs (G, B).
extern "C" int lzt_parse_events_big(
    const void* refbuf, const void* qbuf, const void* poslist,
    const void* cand, const void* next_hit, const void* win,
    const void* dszs, const void* nrs, void* ev, void* nev, int G, int B,
    int LrP, int LqP, int KaP, int WinP, int evc, int mal, int msl, int mrd,
    int mqd, int reg, int aw, int am, int ar, void* stream) {
    return launch<TwoPlaneCand>(refbuf, qbuf, poslist, cand, next_hit, win,
                                dszs, nrs, ev, nev, G, B, LrP, LqP, KaP,
                                WinP, evc, true,
                                Cfg{mal, msl, mrd, mqd, reg, aw, am, ar},
                                stream);
}
