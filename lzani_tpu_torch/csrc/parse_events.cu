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
// The automaton (parse_pair): one warp per pair. Every lane holds the same
// scalar state (that of Parser::parse, cut down to the decisions that
// produce events), and every decision comes from a warp vote, so control
// flow never diverges inside a warp. Scalar and uniform: the desync jump
// through next_hit, the WIN lookup (the host-built bit table, an exact
// replica of the reference's f64 fpow comparison: no f64 on the device),
// and the bwd-cap bookkeeping (the pending literal factor after the
// region-kill merge, carried in reg_lo, reg_hi and lit_below as pallas_v7
// does). Lanes 0-7 write each record, lane 0 the count. Its searches:
//   * anchors: poslist[start : start+cnt]; the longest exact LCE >= mal
//     wins, the first in list order (the smallest position) on a tie;
//   * synced seed window [max(0, pred-lit_run), pred+mrd): positions whose
//     msl-prefix matches (query N = 5 never equals reference N = 4, so a
//     prefix match implies valid k-mers on both sides), ordered by (length
//     desc, |p - pred| asc, p asc);
//   * extensions (extend_fwd/extend_bwd), 32 positions a step: the
//     mismatch mask gives the sliding window's count at each lane as a
//     carry plus two popcounts (misses entering the window up to the lane,
//     misses leaving it); for aw <= 32 the leaving misses are the last 64
//     positions' mask shifted by aw, above that the mask at offset -aw.
//     The scan stops at the first lane over am; the result is the last
//     match before it that ends a run of >= ar. The long-genome kernel
//     scans 4,096 offsets a step (ext_wide, below).
// Symbols past a buffer's semantic end read as N, which bounds every LCE
// and scan without caps.
//
// Group path (lzt_parse_events), designed for Hopper. What bounded the
// one-warp-per-pair kernel it replaces was the chain of dependent loads
// in the heaviest pair, not bandwidth: a launch lasts as long as its
// slowest pair, and that pair (56 kb x 55 kb, 27,616 decisions) spent 77%
// of its span in the synced seed window, whose lanes checked the
// msl-prefix with up to msl serial one-byte loads from device memory
// (about 225 cycles each), and 10% on the candidate word of each step
// (dispatch_probe.py --probe; NVIDIA H100 80GB HBM3, 700.00 W). So:
//   * the symbols are bit planes: a pre-pass kernel (pack_planes) turns
//     each reference and query row into three planes of 32-symbol words
//     (the 2-bit code as a low and a high plane, and an N plane: 3 bits a
//     symbol; N at and past the row's length). 32 symbols at any position
//     are two words per plane and a funnel shift, and the mismatch mask of
//     two windows is (lo ^ lo') | (hi ^ hi') | N | N';
//   * a block serves one reference: its prologue copies the reference's
//     planes into dynamic shared memory with cp.async (LrP 2^17: 48 KiB,
//     four blocks an SM; up to 2^19: 192 KiB), so every reference read of
//     the seed window, the anchors, the LCEs and the scans is a
//     shared-memory load. A reference whose planes do not fit is read from
//     device memory by the other instantiation of the same kernel,
//     chosen by shape before the launch;
//   * a run of synced literal steps is taken at once: step j of the run
//     would test the query at i + j against the window [lo, pred + j +
//     mrd), so on the diagonal p - i the hits of all the run's steps are
//     the runs of msl matches in one 64-position mismatch mask; lane l
//     takes diagonals l, l + 32, ..., the candidate words give the first
//     step with anchors, and one reduction gives the first step that is
//     not literal (up to 32 steps, and never past the desync at lit_run >
//     mqd). The decisions and their order are those of the steps one by
//     one;
//   * the seed window of a step is one pass: each lane compares its
//     positions' 32-symbol windows with the query's (held in registers,
//     reloaded once per 32 positions of i) and the msl-prefix is a mask of
//     that compare; a lane keeps its own best and one warp reduction picks
//     the winner;
//   * an LCE compares 32 symbols a lane, 1,024 positions a warp step; the
//     anchor candidates get their first 32 symbols compared in parallel,
//     one lane each, and only those that match all 32 need a warp LCE;
//   * the candidate words of 32 query positions are loaded at once, one a
//     lane, and taken with a shuffle at each step;
//   * the candidate and query words at an event's end are loaded before
//     its forward extension runs, so their latency overlaps the scan;
//   * the grid is (slice, reference); a block's warps take that
//     reference's queries from a counter, longest first (the wrapper
//     zeroes the counter and orders the queries), with enough blocks to
//     cover the SMs at G = 1 as at G = 4.
// The viral group dispatch went from 28.0-28.2 to 3.4 ms, and its heaviest
// pair from 56.8 M to 6.17 M cycles in 2,453 iterations. That span is now
// the latency of device-memory loads: the lookahead's 38% mostly waits
// for candidate and query words, the extensions' 21% for query words,
// the anchor search's 19% for position-list entries; the seed window
// takes 5% (dispatch_probe.py --probe; NVIDIA H100 80GB HBM3, 700.00 W).
// Long-genome path (lzt_parse_events_big), designed for Hopper.
// References of up to 2^25 symbols cannot live in shared memory, so both
// sides' planes (packed as above, a query's to its longest pair, which a
// shorter pair reads as N past its own dsz) are read from device memory,
// through the automaton of the group kernel: the same word compares and
// literal-run lookahead, with a two-plane candidate table (a start and
// an unbounded count: the reference's ht_long probe chains are unbounded
// too) whose 32 positions' words are held a lane. What bounds it is
// again the chain of dependent steps of the heaviest pair, but here its
// extensions: between bacterial relatives (3-9% substitutions) the
// approximate extensions cover the whole genome, 5.0 M offsets in 22-65
// events. The one-byte kernel this replaces spent 99% of its 152.6 M
// cycle span there, 972 cycles a 32-offset step (74.8 ms a launch of 6 x
// 8 pairs at LqP 2^23), and the word automaton alone still 87.4 M (560
// cycles a step). So:
//   * the extensions scan 4,096 offsets a warp step (ext_wide in
//     planes.cuh: a lane takes four 32-offset words and holds every
//     window it needs, one vote a step), the next step's plane words
//     loaded before this step's are examined;
//   * a warp a pair, one a block while the pairs are no more than the
//     SMs (a pair is one chain; the launch lasts as long as its slowest),
//     the pairs taken longest first from a counter.
// The launch went to 1.7 ms of device time (parse 1.61 ms, plane packs
// 0.08 ms); its heaviest pair, 3.34 M cycles, is 84% extension steps of
// about 1,400 cycles (2,300 between the two 9% relatives, whose window
// counts take the dense path), the instructions of one warp
// (dispatch_probe.py --big --probe; NVIDIA H100 80GB HBM3, 700.00 W).
// Offsets of per-pair planes are size_t (pair x LqP exceeds 2^31);
// positions fit in int (LrP <= 2^26: 2^21 words a plane).
// ============================================================================

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int SAT = 27;  // 1 - 4^-l == 1.0 in f64 for l >= 27 (anchor_tables)
constexpr int MAX_WARPS = 8;   // warps per block of either kernel
constexpr int SEED_CHUNKS = 4; // 32-position chunks of a seed-window pass

// Probe build (-DLZT_PROBE, dispatch_probe.py --probe): per pair of
// either kernel, the warp's clock64() span and counts by kind of step.
enum {
    PR_SPAN, PR_STEPS, PR_JUMPS, PR_ANC_CAND, PR_ANC_LCE, PR_SYNCED,
    PR_SYNCED_LIT, PR_SEED_CHUNKS, PR_SEED_LOADS, PR_SEED_HITS,
    PR_SEED_LCE, PR_EXT_BWD, PR_EXT_FWD, PR_EVENTS, PR_CYC_ANC,
    PR_CYC_SEED, PR_CYC_EXT, PR_SKIPPED, PR_CYC_RUN, PR_CYC_JUMP,
    NPROBE = 20
};

struct Cfg {
    int mal, msl, mrd, mqd, reg, aw, am, ar;
};

// ---------------------------------------------------------------------------
// candidate tables
// ---------------------------------------------------------------------------

// Group path: (G, B, LqP) words start << 7 | min(count, 127). The words of
// 32 positions from `base` are held one a lane (warp calls), loaded where
// a step finds none held or ahead, at an event's end.
struct PackedCand {
    const int32_t* cd;
    int LqP;
    int base = INT_MIN;  // first cached position
    int mine = 0;        // this lane's word: position base + lane
    __device__ PackedCand(const int32_t* row, int lqp) : cd(row), LqP(lqp) {}
    __device__ __forceinline__ void load(int i, int lane) {
        base = i;
        mine = i + lane < LqP ? cd[i + lane] : 0;
    }
    __device__ __forceinline__ void get(int i, int& start, int& cnt,
                                        int lane) {
        if (i < base || i >= base + LANES) load(i, lane);
        const int cw = __shfl_sync(FULL, mine, i - base);
        start = cw >> 7;
        cnt = cw & 127;
    }
    // the first j < n (1 <= n <= 32) with candidates at i + j, else n;
    // n is cut to the words held (loaded at i when i is not among them)
    __device__ __forceinline__ int first_with(int i, int n, int lane) {
        if (i < base || i >= base + LANES) load(i, lane);
        n = min(n, base + LANES - i);
        const unsigned m = __ballot_sync(FULL, (mine & 127) != 0) >> (i - base);
        const unsigned mn = n >= LANES ? m : m & ((1u << n) - 1);
        return mn ? __ffs(mn) - 1 : n;
    }
};

// Long-genome path: (G, B, 2, LqP) planes, start then an unbounded count
// (the reference's ht_long probe chains are unbounded too). As
// PackedCand: the start and count of 32 positions from `base` held one
// of each a lane, loaded (coalesced) where a step finds none held or
// ahead, at an event's end.
struct TwoPlaneCand {
    const int32_t* st;
    const int32_t* ct;
    int LqP;
    int base = INT_MIN;
    int s_mine = 0, c_mine = 0;
    __device__ TwoPlaneCand(const int32_t* cand, size_t pair, int lqp)
        : st(cand + pair * 2 * lqp), ct(st + lqp), LqP(lqp) {}
    __device__ __forceinline__ void load(int i, int lane) {
        base = i;
        const bool in = i + lane < LqP;
        s_mine = in ? st[i + lane] : 0;
        c_mine = in ? ct[i + lane] : 0;
    }
    __device__ __forceinline__ void get(int i, int& start, int& cnt,
                                        int lane) {
        if (i < base || i >= base + LANES) load(i, lane);
        start = __shfl_sync(FULL, s_mine, i - base);
        cnt = __shfl_sync(FULL, c_mine, i - base);
    }
    __device__ __forceinline__ int first_with(int i, int n, int lane) {
        if (i < base || i >= base + LANES) load(i, lane);
        n = min(n, base + LANES - i);
        const unsigned m = __ballot_sync(FULL, c_mine != 0) >> (i - base);
        const unsigned mn = n >= LANES ? m : m & ((1u << n) - 1);
        return mn ? __ffs(mn) - 1 : n;
    }
};

// ---------------------------------------------------------------------------
// symbols: bit-plane words, the reference in shared or device memory
// ---------------------------------------------------------------------------

// The query reads N at and past the pair's dsz: its planes may be
// packed to a longer pair's length (the long-genome path packs a query
// to its longest pair), so the last word within dsz gets `tail` and the
// words past it are outside Q.nw.
// WIDE: the extensions 4,096 offsets a warp step (ext_wide) where the
// parameters allow, else 32 (ext_scan). The choice follows the genome
// size, through the engine's routing of a row to either kernel: between
// bacterial relatives (the long-genome kernel) the extensions run to
// megabases, and ext_wide took the heaviest pair from 87.4 M to 3.34 M
// cycles; between viral relatives (the group kernel) most scans stop
// within their first 32 offsets (996 forward scans took 996 steps in the
// heaviest pair), the words a wide step examines past an early stop are
// dense in mismatches, and ext_wide made the group dispatch 4.2x slower
// (dispatch_probe.py --big --probe, --baseline; NVIDIA H100 80GB HBM3,
// 700.00 W).
template <bool WIDE>
struct WordSyms {
    Planes R, Q;
    int nr, dsz;
    uint32_t tail;       // N bits of query word Q.nw - 1 at and past dsz
    int q_at = INT_MIN;  // query words q_at, q_at + 1, q_at + 2 ...
    W3 qa, qb, qc;       // ... held in registers (uniform)

    __device__ WordSyms(const Planes& r, const Planes& q, int nr_, int dsz_)
        : R(r), Q(q), nr(nr_), dsz(dsz_),
          tail(dsz_ & 31 ? FULL << (dsz_ & 31) : 0u) {
        Q.nw = min(q.nw, (max(dsz_, 0) + 31) >> 5);
    }

    // the query's word w (N at and past dsz)
    __device__ __forceinline__ W3 qword(int w) const {
        W3 x = word_at(Q, w);
        if (w == Q.nw - 1) x.nn |= tail;
        return x;
    }

    // hold query words w .. w + 2, keeping those already held
    __device__ __forceinline__ void qload(int w) {
        if (w == q_at + 1) {
            qa = qb;
            qb = qc;
        } else if (w == q_at + 2) {
            qa = qc;
            qb = qword(w + 1);
        } else {
            qa = qword(w);
            qb = qword(w + 1);
        }
        qc = qword(w + 2);
        q_at = w;
    }

    // the query's 32 symbols at i
    __device__ __forceinline__ W3 qwin(int i) {
        const int w = i >> 5;
        if (w != q_at && w != q_at + 1) qload(w);
        return w == q_at ? join(qa, qb, i & 31) : join(qb, qc, i & 31);
    }

    // the query's 64 symbols at i
    __device__ __forceinline__ void qwin64(int i, W3& a, W3& b) {
        const int w = i >> 5;
        if (w != q_at) qload(w);
        a = join(qa, qb, i & 31);
        b = join(qb, qc, i & 31);
    }

    // LCE of ref[rp..] and q[qp..] from offset `from`: lane l compares the
    // 32 offsets at o + 32 l, 1,024 offsets a step
    __device__ __forceinline__ int lce(int rp, int qp, int from,
                                       int lane) const {
        for (int o = from;; o += LANES * LANES) {
            const int ql = qp + o + LANES * lane;  // >= 0
            const uint32_t d =
                diff(win32(R, rp + o + LANES * lane),
                     join(qword(ql >> 5), qword((ql >> 5) + 1), ql & 31));
            const unsigned m = __ballot_sync(FULL, d != 0);
            if (m) {
                const int L = __ffs(m) - 1;
                return o + LANES * L + first_miss(__shfl_sync(FULL, d, L));
            }
        }
    }

    // steps of an lce() from `from` that returned `len`
    __device__ __forceinline__ static int lce_steps(int len, int from) {
        return (len - from) / (LANES * LANES) + 1;
    }

    // the candidates 32 at a time, one a lane: its first 32 symbols
    // compared at once, a warp LCE where all 32 match
    __device__ __forceinline__ void anchor(const int32_t* pos, int start,
                                           int cnt, int i, const Cfg& c,
                                           int lane, int& a_len, int& a_pos,
                                           long long* pc) {
        a_len = a_pos = 0;
        if (cnt == 0) return;
        const W3 qi = qwin(i);
        for (int k0 = 0; k0 < cnt; k0 += LANES) {
            PROBE(++pc[PR_ANC_LCE]);
            const bool valid = k0 + lane < cnt;
            const int p = valid ? pos[start + k0 + lane] : 0;
            int ml = valid ? first_miss(diff(win32(R, p), qi)) : 0;
            for (unsigned L = __ballot_sync(FULL, ml == LANES); L;
                 L &= L - 1) {
                const int src = __ffs(L) - 1;
                const int full = lce(__shfl_sync(FULL, p, src), i, LANES,
                                     lane);
                PROBE(pc[PR_ANC_LCE] += lce_steps(full, LANES));
                if (lane == src) ml = full;
            }
            const bool ok = valid && ml >= c.mal;
            const int best = __reduce_max_sync(FULL, ok ? ml : 0);
            if (best > a_len) {  // a later chunk wins only when longer
                const int src =
                    __ffs(__ballot_sync(FULL, ok && ml == best)) - 1;
                a_len = best;
                a_pos = __shfl_sync(FULL, p, src);
            }
        }
    }

    // start loading the candidate and query words at i (an event's end,
    // where the parse resumes after its extension)
    template <class Cand>
    __device__ __forceinline__ void prefetch(Cand& cd, int i, int lane) {
        cd.load(i, lane);
        qload(i >> 5);
    }

    // How many of the steps i, i + 1, ... (at most kmax) are literal steps
    // of the synced state: no anchor candidate at i + j, and no seed hit in
    // step j's window [lo, pred + j + mrd) against the query at i + j. On
    // the diagonal dd = p - i a hit at step j is a run of msl matches from
    // bit j of the diagonal's 64-position mismatch mask; lane l takes the
    // diagonals l, l + 32, ... and one reduction gives the first hit.
    template <class Cand>
    __device__ __forceinline__ int literal_run(Cand& cd, int i, int pred,
                                               int lit_run, int kmax,
                                               const Cfg& c, int lane) {
        W3 q0, q1;  // (its loads overlap the candidate words')
        qwin64(i, q0, q1);
        const int k = cd.first_with(i, min(kmax, LANES), lane);
        if (k == 0) return 0;
        const int lo = max(0, pred - lit_run);
        const int d_hi = pred + c.mrd - i;  // p - i stays below it
        int first = k;
        for (int d0 = lo - i - (k - 1); d0 < d_hi; d0 += LANES) {
            const int p = i + d0 + lane;  // the diagonal's position at step 0
            W3 r0, r1;
            win64(R, p, r0, r1);
            const uint64_t h =
                runs(~((uint64_t)diff(r1, q1) << LANES | diff(r0, q0)),
                     c.msl)
                & ~0ull << max(0, lo - p);  // steps whose window holds p
            if (p - i < d_hi && h) first = min(first, __ffsll(h) - 1);
        }
        return __reduce_min_sync(FULL, first);
    }

    // bit j set where bits j .. j + n - 1 of `ones` are (1 <= n < 32)
    __device__ __forceinline__ static uint64_t runs(uint64_t ones, int n) {
        uint64_t r = ~0ull, h = ones;  // h: runs of 2^b
        int off = 0;
#pragma unroll
        for (int b = 0; b < 5; ++b) {
            if (n >> b & 1) {
                r &= h >> off;
                off += 1 << b;
            }
            h &= h >> (1 << b);
        }
        return r;
    }

    // the window in passes of SEED_CHUNKS x 32 positions: each lane
    // compares its positions' windows with the query's at once (the
    // msl-prefix is a mask), one vote a pass; on a hit it keeps its best by
    // (length desc, |p - pred| asc, p asc), and one warp reduction at the
    // end picks the winner
    __device__ __forceinline__ void seed(int i, int pred, int lit_run,
                                         const Cfg& c, int lane, int& s_len,
                                         int& s_pos, long long* pc) {
        const W3 qi = qwin(i);
        const uint32_t pre = (1u << c.msl) - 1;  // msl <= SAT < 32
        const int hi = pred + c.mrd;
        int b_len = 0, b_dist = INT_MAX, b_pos = INT_MAX;
        bool found = false;
        for (int base = max(0, pred - lit_run); base < hi;
             base += SEED_CHUNKS * LANES) {
            PROBE(++pc[PR_SEED_CHUNKS]);
            PROBE(pc[PR_SEED_LOADS] += SEED_CHUNKS);
            int ml[SEED_CHUNKS];
            bool hit[SEED_CHUNKS], any = false;
#pragma unroll
            for (int u = 0; u < SEED_CHUNKS; ++u) {
                const int p = base + u * LANES + lane;
                const uint32_t d = diff(win32(R, p), qi);
                hit[u] = p < hi && (d & pre) == 0;
                ml[u] = hit[u] ? first_miss(d) : 0;
                any |= hit[u];
            }
            if (!__any_sync(FULL, any)) continue;
            found = true;
#pragma unroll
            for (int u = 0; u < SEED_CHUNKS; ++u) {
                PROBE(pc[PR_SEED_HITS] += __popc(__ballot_sync(FULL, hit[u])));
                const int p0 = base + u * LANES;
                for (unsigned L = __ballot_sync(FULL, ml[u] == LANES); L;
                     L &= L - 1) {
                    const int src = __ffs(L) - 1;
                    const int full = lce(p0 + src, i, LANES, lane);
                    PROBE(pc[PR_SEED_LCE] += lce_steps(full, LANES));
                    if (lane == src) ml[u] = full;
                }
                const int dist = abs(p0 + lane - pred);
                if (hit[u] && (ml[u] > b_len ||
                               (ml[u] == b_len && dist < b_dist))) {
                    b_len = ml[u];
                    b_dist = dist;
                    b_pos = p0 + lane;
                }
            }
        }
        s_len = s_pos = 0;
        if (!found) return;
        s_len = __reduce_max_sync(FULL, b_len);
        const int dist =
            __reduce_min_sync(FULL, b_len == s_len ? b_dist : INT_MAX);
        s_pos = __reduce_min_sync(
            FULL, b_len == s_len && b_dist == dist ? b_pos : INT_MAX);
    }

    // the sliding-window extensions (planes.cuh; a forward scan stops at
    // dsz through max_len, so the query's tail word is not needed)
    template <bool FWD>
    __device__ __forceinline__ int ext(const Cfg& c, int dpos, int rpos,
                                       int max_len, int lane,
                                       long long& steps) const {
        if constexpr (WIDE) {
            if (c.aw <= LANES && c.ar >= 1 && c.ar < LANES)
                return ext_wide<FWD>(Q, R, c.aw, c.am, c.ar, dpos, rpos,
                                     max_len, lane, steps);
        }
        return ext_scan<FWD>(Q, R, c.aw, c.am, c.ar, dpos, rpos, max_len,
                             lane, steps);
    }
};

// ---------------------------------------------------------------------------
// the automaton of one pair (a warp)
// ---------------------------------------------------------------------------

template <class Syms, class Cand>
__device__ void parse_pair(Syms& S, Cand& cd, const int32_t* __restrict__ pos,
                           const int32_t* __restrict__ nh,
                           const uint32_t* __restrict__ wt,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ nev_out, int evc,
                           const Cfg& c, int lane,
                           long long* __restrict__ probe) {
    const int dsz = S.dsz;
    const int limit = dsz - c.msl;  // loop bound: i + msl < dsz
    const int NS = SAT - c.msl + 1, NL = c.mqd + 1;
    int i = 0, pred = -dsz, lit_run = 0;
    int reg_lo = -1, reg_hi = 0, lit_below = 0, ne = 0;
    long long pc[NPROBE] = {};
    PROBE(const long long t_start = clock64());
    PROBE(long long t0 = 0);

    while (i < limit && ne < evc) {
        PROBE(++pc[PR_STEPS]);
        if (pred < 0) {
            // desynced: no event before the next anchor candidate
            PROBE(++pc[PR_JUMPS]);
            PROBE(t0 = clock64());
            const int j = min(nh[i], limit);
            lit_run += j - i;
            i = j;
            PROBE(pc[PR_CYC_JUMP] += clock64() - t0);
            if (i >= limit) break;
        } else {
            // synced: a run of literal steps at once (they desync once
            // lit_run exceeds mqd)
            PROBE(t0 = clock64());
            const int k = S.literal_run(cd, i, pred, lit_run,
                                        min(c.mqd + 1 - lit_run, limit - i),
                                        c, lane);
            PROBE(pc[PR_CYC_RUN] += clock64() - t0);
            if (k > 0) {
                PROBE(pc[PR_SKIPPED] += k);
                i += k;
                pred += k;
                lit_run += k;
                if (lit_run > c.mqd) pred = -dsz;
                continue;
            }
        }
        PROBE(t0 = clock64());
        int start, cnt;
        cd.get(i, start, cnt, lane);
        PROBE(pc[PR_ANC_CAND] += cnt);
        int a_len, a_pos;
        S.anchor(pos, start, cnt, i, c, lane, a_len, a_pos, pc);
        PROBE(pc[PR_CYC_ANC] += clock64() - t0);
        int bl = a_len, bp = a_pos;
        if (pred >= 0) {
            PROBE(++pc[PR_SYNCED]);
            PROBE(t0 = clock64());
            int s_len, s_pos;
            S.seed(i, pred, lit_run, c, lane, s_len, s_pos, pc);
            PROBE(pc[PR_CYC_SEED] += clock64() - t0);
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
            PROBE(t0 = clock64());
            const bool close = pred >= 0 && abs(bp - pred) <= c.mrd;
            int bwd = 0, tl = 0;
            if (!close) {
                // the pending literal factor after the region-kill merge
                const bool kill = reg_lo >= 0 && reg_hi - reg_lo < c.reg;
                tl = kill ? (i - reg_lo) + lit_below : lit_run;
                if (tl > 0)
                    bwd = S.template ext<false>(c, i, bp,
                                                min(min(i, bp), tl), lane,
                                                pc[PR_EXT_BWD]);
            }
            const int i2 = i + bl, pred2 = bp + bl;
            S.prefetch(cd, i2, lane);
            const int ext = S.template ext<true>(
                c, i2, pred2, min(dsz - i2, S.nr - pred2), lane,
                pc[PR_EXT_FWD]);
            PROBE(pc[PR_CYC_EXT] += clock64() - t0);
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
            PROBE(if (pred >= 0) ++pc[PR_SYNCED_LIT]);
            ++i;
            if (pred >= 0) ++pred;
            ++lit_run;
            if (lit_run > c.mqd) pred = -dsz;
        }
    }
    if (lane == 0) *nev_out = i < limit ? -1 : ne;
#ifdef LZT_PROBE
    pc[PR_SPAN] = clock64() - t_start;
    pc[PR_EVENTS] = ne;
    if (probe && lane == 0) {
#pragma unroll
        for (int f = 0; f < NPROBE; ++f) probe[f] = pc[f];  // registers
    }
#endif
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// Group path. Grid (slices, G): block (s, g) serves reference g; its warps
// take queries order[k] from the counter next_q[g]. SMEM: the reference's
// planes (rows of RW words) are copied into shared memory first.
template <bool SMEM>
__global__ void __launch_bounds__(MAX_WARPS * LANES) parse_group_kernel(
    const uint32_t* __restrict__ rpl, const uint32_t* __restrict__ qpl,
    const int32_t* __restrict__ poslist, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ next_hit, const uint32_t* __restrict__ win,
    const int32_t* __restrict__ dszs, const int32_t* __restrict__ nrs,
    const int32_t* __restrict__ order, int32_t* __restrict__ next_q,
    int32_t* __restrict__ ev, int32_t* __restrict__ nev, int B, int RW,
    int QW, int LqP, int KaP, int WinP, int evc, Cfg c,
    long long* __restrict__ probe) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int lane = threadIdx.x % LANES;
    const int g = blockIdx.y;
    const int nr = nrs[g];
    const uint32_t* rg = rpl + (size_t)g * 3 * RW;
    Planes R{rg, rg + RW, rg + 2 * (size_t)RW, RW};
    if constexpr (SMEM) {
        // the words that hold [0, nr) and the one after; later words read
        // as N through Planes::nw
        const int nw = min(RW, (nr >> 5) + 2);
        planes_to_smem(smem, rg, RW, nw, threadIdx.x, blockDim.x);
        cp_async_wait_all();
        __syncthreads();
        R = Planes{smem, smem + RW, smem + 2 * (size_t)RW, nw};
    }
    for (;;) {
        int k = 0;
        if (lane == 0) k = atomicAdd(next_q + g, 1);
        k = __shfl_sync(FULL, k, 0);
        if (k >= B) break;  // the whole warp
        const int b = order[k];
        const size_t pair = (size_t)g * B + b;
        const uint32_t* qb = qpl + (size_t)b * 3 * QW;
        WordSyms<false> S(R, Planes{qb, qb + QW, qb + 2 * (size_t)QW, QW},
                          nr, dszs[b]);
        PackedCand cd(cand + pair * LqP, LqP);
        parse_pair(S, cd, poslist + (size_t)g * KaP, next_hit + pair * LqP,
                   win + (size_t)g * WinP, ev + pair * evc * 8, nev + pair,
                   evc, c, lane, probe ? probe + pair * NPROBE : nullptr);
    }
}

// Long-genome path: dszs (G, B). Each warp takes pairs order[k] (the
// longest query first) from the counter next_pair; both sides' planes are
// read from device memory. A query's planes hold its longest pair's
// length; WordSyms reads a shorter pair's query as N past its dsz.
__global__ void __launch_bounds__(MAX_WARPS * LANES) parse_big_kernel(
    const uint32_t* __restrict__ rpl, const uint32_t* __restrict__ qpl,
    const int32_t* __restrict__ poslist, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ next_hit, const uint32_t* __restrict__ win,
    const int32_t* __restrict__ dszs, const int32_t* __restrict__ nrs,
    const int32_t* __restrict__ order,
    int32_t* __restrict__ next_pair, int32_t* __restrict__ ev,
    int32_t* __restrict__ nev, int G, int B, int RW, int QW, int LqP,
    int KaP, int WinP, int evc, Cfg c, long long* __restrict__ probe) {
    const int lane = threadIdx.x % LANES;
    for (;;) {
        int k = 0;
        if (lane == 0) k = atomicAdd(next_pair, 1);
        k = __shfl_sync(FULL, k, 0);
        if (k >= G * B) break;  // the whole warp
        const int pair = order[k];
        const int g = pair / B, b = pair % B;
        const uint32_t* rg = rpl + (size_t)g * 3 * RW;
        const uint32_t* qb = qpl + (size_t)b * 3 * QW;
        WordSyms<true> S(Planes{rg, rg + RW, rg + 2 * (size_t)RW, RW},
                         Planes{qb, qb + QW, qb + 2 * (size_t)QW, QW},
                         nrs[g], dszs[pair]);
        TwoPlaneCand cd(cand, pair, LqP);
        parse_pair(S, cd, poslist + (size_t)g * KaP,
                   next_hit + (size_t)pair * LqP, win + (size_t)g * WinP,
                   ev + (size_t)pair * evc * 8, nev + pair, evc, c, lane,
                   probe ? probe + (size_t)pair * NPROBE : nullptr);
    }
}

}  // namespace

// Version of the C interface below (dispatch_probe.py --baseline reads it
// to call an older checkout's build).
extern "C" int lzt_parse_abi() { return 3; }

// int64 fields a pair of the probe build's counts (ops/parse_kernel.py
// checks it against its field names when it loads the library).
extern "C" int lzt_parse_nprobe() { return NPROBE; }

// Dynamic shared memory (bytes) a block of the group kernel may take on
// the current device: the opt-in limit less the kernel's static shared
// memory, or -1 on an error.
extern "C" int lzt_parse_smem_max() {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0)
        rc = (int)cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc == 0) rc = (int)cudaFuncGetAttributes(&fa, parse_group_kernel<true>);
    return rc == 0 ? optin - (int)fa.sharedSizeBytes : -1;
}

// Group path: cand (G, B, LqP) packed, dszs (B,). Scratch from the caller:
// rpl (G, 3, LrP / 32) and qpl (B, 3, LqP / 32) uint32 plane words, order
// (B,) the queries longest first, next_q (G,) zeroed counters. The launch:
// `warps` warps a block, `slices` blocks a reference, the reference's
// planes in `smem` bytes of shared memory (0: read from device memory).
// probe (G, B, NPROBE) int64 is written by the probe build only.
extern "C" int lzt_parse_events(
    const void* refbuf, const void* qbuf, const void* poslist,
    const void* cand, const void* next_hit, const void* win,
    const void* dszs, const void* nrs, void* ev, void* nev, int G, int B,
    int LrP, int LqP, int KaP, int WinP, int evc, int mal, int msl, int mrd,
    int mqd, int reg, int aw, int am, int ar, void* stream, void* probe,
    void* rpl, void* qpl, const void* order, void* next_q, int smem,
    int warps, int slices) {
    if (G * B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int rc = pack_planes(refbuf, nrs, G, LrP, rpl, st);
    if (rc == 0) rc = pack_planes(qbuf, dszs, B, LqP, qpl, st);
    if (rc != 0) return rc;
    const Cfg c{mal, msl, mrd, mqd, reg, aw, am, ar};
    const dim3 grid(slices, G);
    const int threads = warps * LANES;
    const int RW = LrP / LANES, QW = LqP / LANES;
    if (smem > 0) {
        rc = (int)cudaFuncSetAttribute(
            parse_group_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != 0) return rc;
        parse_group_kernel<true><<<grid, threads, smem, st>>>(
            (const uint32_t*)rpl, (const uint32_t*)qpl,
            (const int32_t*)poslist, (const int32_t*)cand,
            (const int32_t*)next_hit, (const uint32_t*)win,
            (const int32_t*)dszs, (const int32_t*)nrs, (const int32_t*)order,
            (int32_t*)next_q, (int32_t*)ev, (int32_t*)nev, B, RW, QW, LqP,
            KaP, WinP, evc, c, (long long*)probe);
    } else {
        parse_group_kernel<false><<<grid, threads, 0, st>>>(
            (const uint32_t*)rpl, (const uint32_t*)qpl,
            (const int32_t*)poslist, (const int32_t*)cand,
            (const int32_t*)next_hit, (const uint32_t*)win,
            (const int32_t*)dszs, (const int32_t*)nrs, (const int32_t*)order,
            (int32_t*)next_q, (int32_t*)ev, (int32_t*)nev, B, RW, QW, LqP,
            KaP, WinP, evc, c, (long long*)probe);
    }
    return (int)cudaGetLastError();
}

// Blocks of `warps` warps that one SM holds at once for the group kernel
// with `smem` bytes of shared memory (0: the device-memory
// instantiation), or -1 on an error.
extern "C" int lzt_parse_occupancy(int smem, int warps) {
    int n = 0, rc;
    if (smem > 0) {
        rc = (int)cudaFuncSetAttribute(
            parse_group_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc == 0)
            rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, parse_group_kernel<true>, warps * LANES, smem);
    } else {
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, parse_group_kernel<false>, warps * LANES, 0);
    }
    return rc == 0 ? n : -1;
}

// Long-genome path: cand (G, B, 2, LqP) two planes, dszs (G, B). Scratch
// from the caller: rpl (G, 3, LrP / 32) and qpl (B, 3, LqP / 32) uint32
// plane words, qlens (B,) each query's longest dsz, order (G * B,) the
// pairs longest first, next_pair (1,) a zeroed counter. The launch:
// `blocks` blocks of `warps` warps. probe (G, B, NPROBE) int64 is written
// by the probe build only.
extern "C" int lzt_parse_events_big(
    const void* refbuf, const void* qbuf, const void* poslist,
    const void* cand, const void* next_hit, const void* win,
    const void* dszs, const void* nrs, void* ev, void* nev, int G, int B,
    int LrP, int LqP, int KaP, int WinP, int evc, int mal, int msl, int mrd,
    int mqd, int reg, int aw, int am, int ar, void* stream, void* probe,
    void* rpl, void* qpl, const void* qlens, const void* order,
    void* next_pair, int warps, int blocks) {
    if (G * B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int rc = pack_planes(refbuf, nrs, G, LrP, rpl, st);
    if (rc == 0) rc = pack_planes(qbuf, qlens, B, LqP, qpl, st);
    if (rc != 0) return rc;
    parse_big_kernel<<<blocks, warps * LANES, 0, st>>>(
        (const uint32_t*)rpl, (const uint32_t*)qpl, (const int32_t*)poslist,
        (const int32_t*)cand, (const int32_t*)next_hit,
        (const uint32_t*)win, (const int32_t*)dszs, (const int32_t*)nrs,
        (const int32_t*)order, (int32_t*)next_pair, (int32_t*)ev,
        (int32_t*)nev, G, B, LrP / LANES, LqP / LANES, LqP, KaP, WinP, evc,
        Cfg{mal, msl, mrd, mqd, reg, aw, am, ar}, (long long*)probe);
    return (int)cudaGetLastError();
}
