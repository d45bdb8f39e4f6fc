// ============================================================================
// parse_events.cu - event-log parse kernels of the PyTorch/CUDA port.
//
// Replaces the Pallas TPU kernels that compute one function with different
// candidate tables:
//   * lzt_parse_events: lzani_tpu/ops/pallas_v7.py make_parse_kernel_sim,
//     launched by pallas_engine.py _get_group_step (the group path); it
//     also serves the routes of make_parse_kernel(big=False)
//     (pallas_engine.py:307: _get_group_step at ilv=1, _get_ref_step,
//     _get_batch_runner) and of pallas_v5.py make_parse_kernel_ilv, whose
//     streams are the same;
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
// Design: one warp per pair. Every lane holds the same scalar automaton
// state (that of Parser::parse, cut down to the decisions that produce
// events), and every decision comes from a warp vote, so control flow
// never diverges inside a warp. The scans spread over the lanes, 32
// positions per step:
//   * LCE: lane l compares position r + l; __ballot_sync of the
//     mismatches and __ffs give the first one;
//   * extensions (extend_fwd/extend_bwd): the ballot of the mismatches
//     gives the sliding window's count at each lane as a carry plus two
//     popcounts (misses entering the window up to the lane, misses
//     leaving it); for aw <= 32 the leaving misses are the last 64
//     positions' mask shifted by aw, above that each lane re-reads the
//     position it drops. The scan stops at the first lane over am; the
//     result is the last match before it that ends a run of >= ar;
//   * synced seed window [max(0, pred-lit_run), pred+mrd): each lane
//     checks the msl-prefix at its positions by direct symbol comparison
//     (query N = 5 never equals reference N = 4, so a prefix match
//     implies valid k-mers on both sides); each survivor, in ascending
//     position, gets the warp's LCE: survivors are few (one in a
//     non-repetitive window) but their LCEs unbounded (megabases in a
//     related genome), so a lane's own serial LCE would bring back the
//     one-thread scan. Keeping the longest, then the nearest to pred, an
//     equal distance keeping the earlier position, is the order
//     (length desc, |p - pred| asc, p asc);
//   * anchors: poslist[start : start+cnt] in list order, the warp's LCE
//     per candidate (counts are 0-3 almost everywhere); strict > keeps
//     the smallest position; an anchor at position 0 is ignored only
//     when synced.
// Scalar and uniform: the desync jump through next_hit, the WIN lookup
// (the host-built bit table, an exact replica of the reference's f64
// fpow comparison: no f64 on the device), and the bwd-cap bookkeeping
// (the pending literal factor after the region-kill merge, carried in
// reg_lo, reg_hi and lit_below as pallas_v7 does). Lanes 0-7 write each
// record, lane 0 the count. The candidate table is a template parameter:
//   PackedCand   (group path) start << 7 | min(count, 127) per query
//                position; rows over CNT_CAP fall back on the host;
//   TwoPlaneCand (long-genome path) a start plane and a count plane per
//                pair, counts unbounded (the reference's ht_long probe
//                chains are unbounded too).
// Symbols past a buffer's semantic end read as N (4 for the reference,
// 5 for the query), which bounds every LCE and scan without caps. The
// query length dsz is per query on the group path and per pair on the
// long-genome path, where the self pair gets dsz = msl (a no-op).
// Offsets of the per-pair planes are size_t (pair x LqP exceeds 2^31 at
// long-genome sizes); positions fit in int (LrP <= 2^26).
//
// What bounds it: the latency of dependent steps, not bandwidth. A step
// is a coalesced 32-byte load of each buffer and a few votes; a related
// long-genome pair's extensions stream megabases through L1 and L2 one
// step after another, and a literal step of the group path checks up to
// lit_run + mrd seed positions. Pairs are independent warps, so a launch
// lasts as long as its slowest pair, not its slowest group of 32 pairs.
// Launch: four warps per block, one per scheduler of an SM. Spreading a
// small launch wider gains nothing: the 48-pair bacterial launch at one
// warp per block (48 SMs) took 76.10 ms against 75.15-75.20 ms at four
// (12 SMs), and the 1,024-pair group dispatch is the same either way
// (dispatch_probe.py --baseline, NVIDIA H100 80GB HBM3, 700.00 W).
// ============================================================================

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SAT = 27;  // 1 - 4^-l == 1.0 in f64 for l >= 27 (anchor_tables)
constexpr int SYM_N_REF = 4;
constexpr int SYM_N_SEQ = 5;
constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps per block

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

// highest set bit of m != 0
__device__ __forceinline__ int top_bit(unsigned m) { return 31 - __clz(m); }

// Longest common extension of ref[rp..] and q[qp..], known equal below
// `from` (Parser::match_len), 32 offsets per step. The N sentinels end it.
__device__ int lce(const Pair& P, int rp, int qp, int from, int lane) {
    for (int r = from;; r += LANES) {
        const int o = r + lane;
        const unsigned m =
            __ballot_sync(FULL, rsym(P, rp + o) != qsym(P, qp + o));
        if (m) return r + __ffs(m) - 1;
    }
}

template <bool FWD>
__device__ __forceinline__ bool miss_at(const Pair& P, int dpos, int rpos,
                                        int e) {
    return FWD ? qsym(P, dpos + e) != rsym(P, rpos + e)
               : qsym(P, dpos - 1 - e) != rsym(P, rpos - 1 - e);
}

// Sliding-window approximate extension (Parser::extend_fwd/extend_bwd):
// advance while the mismatches among the last aw symbols stay <= am; the
// result is the longest prefix that ends in a run of >= ar matches (the
// run starts at ar, so a match at e = 0 counts). 32 positions per step:
// bad(e) = carry + misses entering in [base, e] - misses leaving.
template <bool FWD>
__device__ int ext_scan(const Pair& P, const Cfg& c, int dpos, int rpos,
                        int max_len, int lane) {
    const unsigned le = FULL >> (31 - lane);  // lanes <= this one
    int carry = 0;                            // misses in the window at base-1
    int lastmiss = -1 - c.ar;                 // the virtual run before e = 0
    int last = 0;
    unsigned prev = 0;                        // miss mask of the last step
    for (int base = 0; base < max_len; base += LANES) {
        const int e = base + lane;
        const bool in = e < max_len;
        const bool miss = in && miss_at<FWD>(P, dpos, rpos, e);
        const unsigned M = __ballot_sync(FULL, miss);
        // lanes whose window drops a miss (position e - aw)
        unsigned O;
        if (c.aw <= LANES) {
            O = (unsigned)((((unsigned long long)M << LANES) | prev)
                           >> (LANES - c.aw));
        } else {
            O = __ballot_sync(FULL, in && e >= c.aw &&
                                        miss_at<FWD>(P, dpos, rpos, e - c.aw));
        }
        const int bad = carry + __popc(M & le) - __popc(O & le);
        const unsigned S = __ballot_sync(FULL, !in || bad > c.am);
        const unsigned Mle = M & le;
        const int lm = Mle ? base + top_bit(Mle) : lastmiss;
        unsigned Q = __ballot_sync(FULL, in && !miss && e - lm >= c.ar);
        if (S) Q &= (1u << (__ffs(S) - 1)) - 1;  // lanes before the stop
        if (Q) last = base + top_bit(Q) + 1;
        if (S) break;
        carry += __popc(M) - __popc(O);
        if (M) lastmiss = base + top_bit(M);
        prev = M;
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
__global__ void __launch_bounds__(WARPS * LANES) parse_events_kernel(
    const uint8_t* __restrict__ refbuf, const uint8_t* __restrict__ qbuf,
    const int32_t* __restrict__ poslist, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ next_hit, const uint32_t* __restrict__ win,
    const int32_t* __restrict__ dszs, const int32_t* __restrict__ nrs,
    int32_t* __restrict__ ev, int32_t* __restrict__ nev, int G, int B,
    int LrP, int LqP, int KaP, int WinP, int evc, bool dsz_per_pair,
    Cfg c) {
    const int lane = threadIdx.x % LANES;
    const int pair = blockIdx.x * WARPS + threadIdx.x / LANES;
    if (pair >= G * B) return;  // the whole warp
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
            const int ml = lce(P, p, i, 0, lane);
            if (ml >= c.mal && ml > a_len) {
                a_len = ml;
                a_pos = p;
            }
        }
        int bl = a_len, bp = a_pos;
        if (pred >= 0) {
            int s_len = 0, s_pos = 0;
            const int hi = pred + c.mrd;
            for (int base = max(0, pred - lit_run); base < hi; base += LANES) {
                const int p = base + lane;
                bool hit = p < hi;
                for (int t = 0; hit && t < c.msl; ++t)
                    hit = rsym(P, p + t) == qsym(P, i + t);
                for (unsigned S = __ballot_sync(FULL, hit); S; S &= S - 1) {
                    const int ps = base + __ffs(S) - 1;
                    const int ml = lce(P, ps, i, c.msl, lane);
                    if (ml > s_len ||
                        (ml == s_len && abs(ps - pred) < abs(s_pos - pred))) {
                        s_len = ml;
                        s_pos = ps;
                    }
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
                    bwd = ext_scan<false>(P, c, i, bp, min(min(i, bp), tl),
                                          lane);
            }
            const int i2 = i + bl, pred2 = bp + bl;
            const int ext = ext_scan<true>(P, c, i2, pred2,
                                           min(dsz - i2, P.nr - pred2), lane);
            if (lane < 8) {
                const int v = lane == 0 ? i : lane == 1 ? bp : lane == 2 ? bl
                            : lane == 3 ? bwd : lane == 4 ? ext : 0;
                out[(size_t)ne * 8 + lane] = v;
            }
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
    if (lane == 0) nev[pair] = i < limit ? -1 : ne;
}

template <class Cand>
int launch(const void* refbuf, const void* qbuf, const void* poslist,
           const void* cand, const void* next_hit, const void* win,
           const void* dszs, const void* nrs, void* ev, void* nev, int G,
           int B, int LrP, int LqP, int KaP, int WinP, int evc,
           bool dsz_per_pair, const Cfg& c, void* stream) {
    const int n = G * B;
    if (n > 0) {
        parse_events_kernel<Cand>
            <<<(n + WARPS - 1) / WARPS, WARPS * LANES, 0,
               (cudaStream_t)stream>>>(
            (const uint8_t*)refbuf, (const uint8_t*)qbuf,
            (const int32_t*)poslist, (const int32_t*)cand,
            (const int32_t*)next_hit, (const uint32_t*)win,
            (const int32_t*)dszs, (const int32_t*)nrs, (int32_t*)ev,
            (int32_t*)nev, G, B, LrP, LqP, KaP, WinP, evc, dsz_per_pair, c);
    }
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
