// ============================================================================
// fold_stats.cu - the event-log fold of the PyTorch/CUDA port: factors and
// the stats triple of every pair, on the device.
//
// Replaces the emission half of the JAX package's XLA automaton
// (lzani_tpu/ops/parse.py make_pair_parser: push/emit_aligned/emit_gap at
// :193-345, the match branches with the region kill at :394-498, the tail
// at :515-527) and its stats fold _component_stats (:536). That backend
// (--backend jax) computes each pair's triple on the device, with no host
// replay. Here the decisions come from the parse kernel's event log
// (csrc/parse_events.cu), and this kernel turns a log into the factor list
// and the triple {sym_in_matches, sym_in_literals, components}. Its exact
// template is the host replay Parser::replay_events with emit_aligned_range,
// emit_gap_two_sided, extend_fwd/extend_bwd and stats
// (csrc/lzani_core.cpp), and it keeps every consistency check of that
// replay: events in query order, no bwd on a close match, and the logged
// bwd and ext equal to the extension scans. A log that fails one, or a
// factor list over the stack's capacity, gets status -1 and no stats: a
// wrong log must not hide.
//
// Inputs are those of a parse_events launch and its outputs:
//   refbuf (G, LrP) u8, qbuf (B, LqP) u8, ev (G, B, evc, 8) i32,
//   nev (G, B) i32 (< 0: no log, the pair is skipped with status 1),
//   dszs (B,) i32 query length + mrd, nrs (G,) i32 composite length.
// Outputs: stats (G, B, 3) i32, status (G, B) i32 (0 ok, -1 rejected,
// 1 skipped), nfac (G, B) i32 factors in the final list, and the factor
// stack (G, B, F, words): with words = 4 it is the factor list {dpos,
// kind, rpos, len}; with words = 2 it is {dpos << 2 | kind, len} (the
// stats need no rpos).
//
// Design, for Hopper. What bounded the one-thread-per-pair kernel this
// replaces was one thread's chain of dependent one-byte loads from device
// memory: its heaviest viral pair (937 events, 807 of them ending in a
// region kill) spent 51% of its 8.6 M cycles in the two extension scans,
// at about 250 cycles a symbol, and 14% stepping over the literal
// positions between events one at a time (dispatch_probe.py --fold;
// NVIDIA H100 80GB HBM3, 700.00 W). So:
//   * one warp per pair: every lane holds the same replay state and every
//     decision is a warp vote; a block serves one reference and its warps
//     take that reference's queries from a counter, longest first (the
//     wrapper orders them and zeroes the counter);
//   * the symbols are the parse kernel's bit planes (planes.cuh, packed
//     by this entry): the block's prologue copies the reference's planes
//     into shared memory with cp.async, and each pair's query planes go
//     to its warp's slot where they fit; what does not fit is read from
//     device memory (chosen by shape before the launch);
//   * records 32 at a time, one a lane, coalesced, and a first pass over
//     them, one event a lane (look_ahead): its forward scan (checked
//     against the logged ext), its backward scan capped only by the
//     buffers, and the mismatch words of its two aligned ranges at the
//     logged lengths. A scan takes 32 offsets a step from one word
//     compare. The ordered pass then hands each record to the warp by
//     shuffles; the literal steps between two events are one subtraction,
//     and the backward scan under the stack's cap is the uncapped one, or
//     the last qualifying offset below the cap (planes.cuh's warp scan
//     for a cap above 32 that cuts it);
//   * emission from mismatch masks: the factors of an aligned range are
//     the runs of its mismatch mask. Up to 32 symbols, lane j takes
//     symbol j of one word; beyond, lane l takes word l (1,024 symbols a
//     warp step) and a warp prefix of the run starts gives each push its
//     stack slot, so pushes are parallel writes. A gap's split is a warp
//     reduction over prefix counts of its two sides' match masks (the
//     rightmost tie wins); the two sides are then runs of the same masks;
//   * the factor stack: every entry is written to device memory (stores
//     the chain never waits for), and the top `ring` entries are also
//     kept in the warp's ring in shared memory, the top entry in
//     registers; a read reaches device memory only for an entry below the
//     ring (a region kill that pops past it, or the stats pass over a
//     list longer than the ring). A region kill reads 32 entries a vote.
//     The capacity stays F = LqP + 4;
//   * the stats are one warp pass: each lane folds a contiguous slice of
//     the final list into a summary (its segments before, between and
//     after DISTANT factors), and the 32 summaries are folded in order.
// What bounds it now: the ordered pass, one warp's chain of dependent
// instructions at about 1,900 cycles an event (region kills about 29% of
// the heaviest pair's span, the first pass 15%, emission 9%), not symbol
// work or bytes: 1.0 ms per viral row launch against 4.1 ms
// (dispatch_probe.py --fold; NVIDIA H100 80GB HBM3, 700.00 W).
// ============================================================================

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int F_LIT = 0, F_CLOSE = 1, F_DISTANT = 2;
constexpr int MAX_WARPS = 8;  // warps a block (the launch bound)

// Probe build (-DLZT_PROBE, dispatch_probe.py --fold): per pair, the
// warp's clock64() span and counts by kind of step. The cycles of the
// records and their first pass (both scans of every event) are cyc_rec;
// cyc_bwd is the ordered pass's choice of the capped backward scan.
enum {
    FP_SPAN, FP_EVENTS, FP_BWD_SCANS, FP_BWD_SYMS, FP_FWD_SYMS, FP_EMIT_SYMS,
    FP_GAPS, FP_GAP_SYMS, FP_GAP_SCAN, FP_GAP_SPLIT, FP_PUSHES, FP_MERGES,
    FP_KILLS, FP_KILL_POPS, FP_MAX_N, FP_NFAC, FP_CYC_REC, FP_CYC_GAP,
    FP_CYC_BWD, FP_CYC_EMIT, FP_CYC_KILL, FP_CYC_STATS, FP_BELOW_RING,
    NPROBE = 23
};

struct Cfg {
    int msl, mrd, mqd, reg, aw, am, ar;
};

// inclusive warp prefix sum
__device__ __forceinline__ int warp_prefix(int v, int lane) {
#pragma unroll
    for (int d = 1; d < LANES; d <<= 1) {
        const int t = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += t;
    }
    return v;
}

// the low n bits (n >= 32: all)
__device__ __forceinline__ unsigned low_bits(int n) {
    return n >= LANES ? FULL : n > 0 ? (1u << n) - 1 : 0u;
}

// The factor stack of one pair. Every lane holds the same copy of the
// scalar fields. Entries [0, n) are in device memory (`words` int32 each);
// entries [lo, n) are also in the ring (shared memory, {dpos << 2 | kind,
// len} in slot k & (K - 1)); the top entry is also in registers. Lane 0
// writes a single entry, and every write is followed by a __syncwarp()
// before another lane reads or writes that entry.
struct Stack {
    int32_t* g;
    int2* ring;
    int words, cap, K;
    int n, lo;
    int t_dpos, t_kind, t_len;  // the top entry (n > 0)
    bool writer;                // lane 0
    int* pc;                    // probe counts (probe build)

    // write entry k
    __device__ __forceinline__ void put(int k, int dpos, int kind, int rpos,
                                        int len, bool in_ring) {
        int32_t* e = g + (size_t)k * words;
        if (words == 4)
            *(int4*)e = make_int4(dpos, kind, rpos, len);
        else
            *(int2*)e = make_int2(dpos * 4 + kind, len);
        if (in_ring) ring[k & (K - 1)] = make_int2(dpos * 4 + kind, len);
    }
    __device__ __forceinline__ void put_len(int k, int len) {
        g[(size_t)k * words + words - 1] = len;
        if (k >= lo) ring[k & (K - 1)].y = len;
    }
    // entry k as {dpos << 2 | kind, len}
    __device__ __forceinline__ int2 get(int k) const {
        if (k >= lo) return ring[k & (K - 1)];
        const int32_t* e = g + (size_t)k * words;
        return words == 4 ? make_int2(e[0] * 4 + e[1], e[3])
                          : *(const int2*)e;
    }
    __device__ __forceinline__ void set_top(int dpos, int kind, int len) {
        t_dpos = dpos;
        t_kind = kind;
        t_len = len;
    }
    __device__ __forceinline__ void count_pushes(int m) {
        PROBE(pc[FP_PUSHES] += m);
        PROBE(if (n > pc[FP_MAX_N]) pc[FP_MAX_N] = n);
    }
    // push one entry; false on overflow
    __device__ __forceinline__ bool push(int dpos, int kind, int rpos,
                                         int len) {
        if (n >= cap) return false;
        if (writer) put(n, dpos, kind, rpos, len, true);
        ++n;
        if (n - lo > K) lo = n - K;
        set_top(dpos, kind, len);
        count_pushes(1);
        return true;
    }
    __device__ __forceinline__ void add_top_len(int d) {
        t_len += d;
        if (writer) put_len(n - 1, t_len);
        PROBE(++pc[FP_MERGES]);
    }
    // drop the top entry
    __device__ __forceinline__ void pop() {
        --n;
        if (lo > n) lo = n;
        __syncwarp();
        if (n > 0) {
            PROBE(if (n - 1 < lo) ++pc[FP_BELOW_RING]);
            const int2 e = get(n - 1);
            set_top(e.x >> 2, e.x & 3, e.y);
        }
    }
};

struct Pair {
    Planes R, Q;
    int nr, dsz;
    Cfg c;
};

// The runs of `mis`, the mismatch mask of an aligned range of len <= 32
// symbols, pushed as factors: lane j takes symbol j. A mismatch run is LIT;
// a match run is `mk`, the first one `mk0`, with rpos rp + x; a run at x
// has dpos d0 + x. With `merge`, a first run that is a mismatch run, on a
// top of kind LIT, is added to the top, and the later runs get dpos
// d0 + x - 1 (the right side of a gap, whose merge does not advance its
// position). False on overflow.
__device__ bool emit_word(Stack& f, unsigned mis, int rp, int len, int d0,
                          int mk0, int mk, bool merge, int lane) {
    if (len <= 0) return true;
    PROBE(f.pc[FP_EMIT_SYMS] += len);
    __syncwarp();  // lane 0's writes of the top before the other lanes'
    const int n0 = f.n;
    const unsigned valid = low_bits(len);
    mis &= valid;
    const unsigned starts = (mis ^ ((mis << 1) | (~mis & 1u))) & valid;
    const bool lit0 = mis & 1u;
    const int adj = merge && lit0 && f.n > 0 && f.t_kind == F_LIT;
    const int first_match = lit0 ? 1 : 0;  // run index
    const int runs = __popc(starts);
    const int n_end = n0 + runs - adj;
    if (n_end > f.cap) return false;
    if (f.lo < n_end - f.K) f.lo = n_end - f.K;
    if ((starts >> lane) & 1u) {
        const int ri = __popc(starts & ((1u << lane) - 1));
        const unsigned rest = starts & ~(FULL >> (31 - lane));
        const int end = rest ? __ffs(rest) - 1 : len;
        const bool lit = (mis >> lane) & 1u;
        const int k = n0 + ri - adj;
        if (ri >= adj)
            f.put(k, d0 + lane - adj,
                  lit ? F_LIT : ri == first_match ? mk0 : mk,
                  lit ? 0 : rp + lane, end - lane, k >= f.lo);
    }
    if (adj) {
        const unsigned rest = starts & ~1u;
        f.t_len += rest ? __ffs(rest) - 1 : len;
        if (lane == 0) f.put_len(n0 - 1, f.t_len);
        PROBE(++f.pc[FP_MERGES]);
    }
    f.n = n_end;
    if (runs > adj) {
        const int last = top_bit(starts);
        f.set_top(d0 + last - adj,
                  (mis >> last) & 1u ? F_LIT
                  : runs - 1 == first_match ? mk0 : mk,
                  len - last);
    }
    f.count_pushes(runs - adj);
    __syncwarp();
    return true;
}

// emit_word's runs for an aligned range of any length: q[qp + x] against
// r[rp + x], x in [0, len); beyond 32 symbols lane l takes word l of each
// 1,024, and a warp prefix of the run starts gives each push its slot
__device__ bool emit_runs(Stack& f, const Pair& P, int qp, int rp, int len,
                          int d0, int mk0, int mk, bool merge, int lane) {
    if (len <= 0) return true;
    if (len <= LANES)
        return emit_word(f, diff(win32(P.Q, qp), win32(P.R, rp)), rp, len,
                         d0, mk0, mk, merge, lane);
    PROBE(f.pc[FP_EMIT_SYMS] += len);
    __syncwarp();
    const int n0 = f.n;
    const bool lit0 = diff(win32(P.Q, qp), win32(P.R, rp)) & 1u;
    const int adj = merge && lit0 && f.n > 0 && f.t_kind == F_LIT;
    const int first_match = lit0 ? 1 : 0;
    int runs = 0;        // runs started so far
    int open_x = 0;      // start of the last run (its end not seen yet)
    unsigned carry = 0;  // the mismatch bit before the chunk
    for (int x0 = 0; x0 < len; x0 += LANES * LANES) {
        const int x = x0 + LANES * lane;
        const unsigned valid = low_bits(len - x);
        const unsigned mis = diff(win32(P.Q, qp + x), win32(P.R, rp + x))
                             & valid;
        unsigned prev = __shfl_up_sync(FULL, mis >> 31, 1);
        if (lane == 0) prev = x0 == 0 ? (~mis & 1u) : carry;
        const unsigned starts = (mis ^ ((mis << 1) | prev)) & valid;
        const int cnt = __popc(starts);
        const int incl = warp_prefix(cnt, lane);
        const int total = __shfl_sync(FULL, incl, LANES - 1);
        const int n_end = n0 + runs + total - adj;
        if (n_end > f.cap) return false;
        // the first start at or after each lane, then after it
        int nxt = starts ? x + __ffs(starts) - 1 : INT_MAX;
#pragma unroll
        for (int d = 1; d < LANES; d <<= 1) {
            const int t = __shfl_down_sync(FULL, nxt, d);
            if (lane + d < LANES) nxt = min(nxt, t);
        }
        const int chunk_first = __shfl_sync(FULL, nxt, 0);
        nxt = __shfl_down_sync(FULL, nxt, 1);
        if (lane == LANES - 1) nxt = INT_MAX;
        if (f.lo < n_end - f.K) f.lo = n_end - f.K;
        // the run left open by the last chunk ends at this chunk's first
        // start
        if (runs > 0 && total > 0) {
            const int L = chunk_first - open_x;
            if (runs - 1 < adj) {
                f.t_len += L;
                if (lane == 0) f.put_len(n0 - 1, f.t_len);
            } else if (lane == 0) {
                f.put_len(n0 + runs - 1 - adj, L);
            }
        }
        int ri = runs + incl - cnt;
        for (unsigned s = starts; s; s &= s - 1, ++ri) {
            const int b = __ffs(s) - 1;
            const unsigned rest = s & (s - 1);
            // the chunk's last run gets its length when its end is seen
            const int end = rest ? x + __ffs(rest) - 1
                                 : nxt != INT_MAX ? nxt : x + b;
            if (ri < adj) continue;
            const bool lit = (mis >> b) & 1u;
            const int k = n0 + ri - adj;
            f.put(k, d0 + x + b - adj,
                  lit ? F_LIT : ri == first_match ? mk0 : mk,
                  lit ? 0 : rp + x + b, end - (x + b), k >= n_end - f.K);
        }
        if (total > 0) {
            const int lw = top_bit(__ballot_sync(FULL, starts != 0));
            const int b = top_bit(starts | 1u);
            open_x = __shfl_sync(FULL, x + b, lw);
            const unsigned lit = __shfl_sync(FULL, (mis >> b) & 1u, lw);
            runs += total;
            if (runs - 1 >= adj)
                f.set_top(d0 + open_x - adj,
                          lit ? F_LIT : runs - 1 == first_match ? mk0 : mk,
                          0);
        }
        carry = __shfl_sync(FULL, mis >> 31, LANES - 1);
    }
    // the last run ends at len
    const int L = len - open_x;
    if (runs - 1 < adj) {
        f.t_len += L;
        if (lane == 0) f.put_len(n0 - 1, f.t_len);
        PROBE(++f.pc[FP_MERGES]);
    } else {
        f.t_len = L;
        if (lane == 0) f.put_len(n0 + runs - 1 - adj, L);
    }
    f.n = n0 + runs - adj;
    f.count_pushes(runs - adj);
    __syncwarp();
    return true;
}

// Parser::emit_gap_two_sided of the literal run [dpos, dpos + len) between
// two close matches. Left side x in [0, to_scan): q[dpos + x] against
// r[r_left + x]; right side: q[qr + x] against r[rr + x] (qr = dpos +
// shift, shift = len - to_scan, rr = r_right - to_scan), absent where
// to_scan - x > lim. The split j maximises the left matches in [0, j)
// plus the right ones in [j, to_scan), the latter counted only for
// to_scan - j <= lim, the rightmost on ties.
struct Gap {
    int dpos, r_left, len, to_scan, lim, shift, qr, rr;
};

__device__ __forceinline__ Gap gap_of(int dpos, int r_left, int r_right,
                                      int len) {
    Gap g;
    g.dpos = dpos;
    g.r_left = r_left;
    g.len = len;
    g.to_scan = r_right < r_left ? len : min(r_right - r_left, len);
    g.lim = min(g.to_scan, r_right);
    g.shift = len - g.to_scan;
    g.qr = dpos + g.shift;
    g.rr = r_right - g.to_scan;
    return g;
}

// the gap's split on the warp: lane l takes j = x0 + l of each 32, and a
// reduction keeps the rightmost of the best
__device__ int gap_split(const Pair& P, const Gap& g, int lane) {
    int rt = 0;  // right-side matches in [0, to_scan)
    for (int x0 = 0; x0 < g.to_scan; x0 += LANES)
        rt += __popc(~diff(win32(P.Q, g.qr + x0), win32(P.R, g.rr + x0))
                     & low_bits(g.to_scan - x0));
    int best = -1, split = 0, lc = 0, rc = 0;
    const unsigned below = (1u << lane) - 1;
    for (int x0 = 0; x0 <= g.to_scan; x0 += LANES) {
        const unsigned v = low_bits(g.to_scan - x0);
        const unsigned wl = ~diff(win32(P.Q, g.dpos + x0),
                                  win32(P.R, g.r_left + x0)) & v;
        const unsigned wr = ~diff(win32(P.Q, g.qr + x0),
                                  win32(P.R, g.rr + x0)) & v;
        const int j = x0 + lane;
        int tot = -1;
        if (j <= g.to_scan)
            tot = lc + __popc(wl & below)
                  + (g.to_scan - j <= g.lim ? rt - rc - __popc(wr & below)
                                            : 0);
        const int mx = __reduce_max_sync(FULL, tot);
        if (mx >= best) {
            best = mx;
            split = __reduce_max_sync(FULL, tot == mx ? j : -1);
        }
        lc += __popc(wl);
        rc += __popc(wr);
    }
    return split;
}

// the gap's factors after its split: the left side's runs, the literal
// middle, the right side's runs. False on overflow.
__device__ bool emit_gap(Stack& f, const Pair& P, const Gap& g, int split,
                         int lane) {
    PROBE(++f.pc[FP_GAPS]);
    PROBE(f.pc[FP_GAP_SYMS] += g.len);
    PROBE(f.pc[FP_GAP_SCAN] += g.to_scan);
    PROBE(f.pc[FP_GAP_SPLIT] += split);
    if (!emit_runs(f, P, g.dpos, g.r_left, split, g.dpos, F_CLOSE, F_CLOSE,
                   false, lane))
        return false;
    if (g.to_scan < g.len) {
        if (split > 0 && f.t_kind == F_LIT)
            f.add_top_len(g.len - g.to_scan);
        else if (!f.push(g.dpos + split, F_LIT, 0, g.len - g.to_scan))
            return false;
    }
    return emit_runs(f, P, g.qr + split, g.rr + split, g.to_scan - split,
                     g.qr + split, F_CLOSE, F_CLOSE, split > 0 || g.shift > 0,
                     lane);
}

// The region kill: pop the entries at or above reg_lo, then the literal
// entries under them, and push one literal entry over those and the
// positions up to i; each vote reads 32 entries once. False on overflow.
__device__ bool kill(Stack& f, int reg_lo, int i, int lane) {
    PROBE(++f.pc[FP_KILLS]);
    PROBE(const int n_before = f.n);
    __syncwarp();
    int run_len = i - reg_lo;
    bool region = true;  // still popping entries at or above reg_lo
    for (;;) {
        const int k = f.n - 1 - lane;
        int2 e = make_int2(0, 0);
        if (k >= 0) e = f.get(k);
        PROBE(f.pc[FP_BELOW_RING] +=
              __popc(__ballot_sync(FULL, k >= 0 && k < f.lo)));
        int c = 0;  // entries this vote pops
        if (region) {
            const unsigned b =
                __ballot_sync(FULL, k >= 0 && (e.x >> 2) >= reg_lo);
            c = b == FULL ? LANES : __ffs(~b) - 1;
            region = c == LANES;
        }
        if (!region) {
            // the literal entries from lane c on
            const unsigned b =
                __ballot_sync(FULL, k >= 0 && (e.x & 3) == F_LIT) >> c;
            const int cl = b == FULL >> c ? LANES - c : __ffs(~b) - 1;
            run_len += __reduce_add_sync(
                FULL, lane >= c && lane < c + cl ? e.y : 0);
            c += cl;
        }
        f.n -= c;
        if (c < LANES) break;
    }
    if (f.lo > f.n) f.lo = f.n;
    PROBE(f.pc[FP_KILL_POPS] += n_before - f.n);
    return f.push(i - run_len, F_LIT, 0, run_len);
}

// Each lane's scan of its own event (planes.cuh's ext_scan, one lane
// instead of a warp), a 32-offset word a step: the window count only
// rises at a miss, so the stop is found among the word's misses, and the
// qualifying offsets (ends of a run of >= ar matches; the run before
// offset 0 counts as ar long) are the word's matches ANDed with their
// ar - 1 predecessors (offset by offset for ar > 32). Returns the
// extension, and in `q0` the qualifying offsets among the first 32
// before the stop.
template <bool FWD>
__device__ __forceinline__ int lane_scan(const Pair& P, int dpos, int rpos,
                                         int max_len, unsigned& q0,
                                         int& words) {
    const Cfg& c = P.c;
    int bad = 0, lastmiss = -1 - c.ar, last = 0;
    unsigned prev = 0;  // the last word's misses
    q0 = 0;
    for (int base = 0; base < max_len; base += LANES) {
        ++words;
        const unsigned inm = low_bits(max_len - base);
        const unsigned M = miss_word<FWD>(P.Q, P.R, dpos, rpos, base) & inm;
        unsigned O;  // offsets whose window drops a miss (e - aw)
        if (c.aw <= LANES) {
            O = (unsigned)((((unsigned long long)M << LANES) | prev)
                           >> (LANES - c.aw));
        } else {
            const int sh = c.aw - base;
            const unsigned ge = sh <= 0 ? FULL : sh >= LANES ? 0u : FULL << sh;
            O = miss_word<FWD>(P.Q, P.R, dpos, rpos, base - c.aw) & inm & ge;
        }
        int stop = __popc(inm);
        for (unsigned m = M; m; m &= m - 1) {
            const unsigned le = FULL >> (31 - (__ffs(m) - 1));
            if (bad + __popc(M & le) - __popc(O & le) > c.am) {
                stop = __ffs(m) - 1;
                break;
            }
        }
        unsigned qm = 0;
        if (c.ar <= LANES) {
            const unsigned long long z =
                ((unsigned long long)~M << LANES) | (base ? ~prev : FULL);
            unsigned long long q = z;
            for (int t = 1; t < c.ar; ++t) q &= z << t;
            qm = (unsigned)(q >> LANES) & low_bits(stop);
        } else {
            for (int b = 0; b < stop; ++b) {
                if ((M >> b) & 1u)
                    lastmiss = base + b;
                else if (base + b - lastmiss >= c.ar)
                    qm |= 1u << b;
            }
        }
        if (base == 0) q0 = qm;
        if (qm) last = base + top_bit(qm) + 1;
        if (stop < LANES) break;
        bad += __popc(M) - __popc(O);
        prev = M;
    }
    return last;
}

// What the ordered pass needs of one event, from the log alone (a lane
// computes its event's): whether the forward scan equals the logged ext,
// the backward scan capped only by the buffers (and its qualifying offsets
// among the first 32, for a lower cap), and the mismatch words of the two
// aligned ranges at the logged lengths (ranges of up to 32 symbols)
struct Ahead {
    int ext_ok, bwd_full;
    unsigned bwd_q0, fwd_mis, bwd_mis;
    int fwd_words, bwd_words;  // words scanned (probe build)
};

__device__ __forceinline__ Ahead look_ahead(const Pair& P, int i, int pos,
                                            int len, int bwd_log,
                                            int ext_log) {
    Ahead a{1, 0, 0u, 0u, 0u, 0, 0};
    unsigned q0;
    const int i2 = i + len, p2 = pos + len;
    a.ext_ok = lane_scan<true>(P, i2, p2, min(P.dsz - i2, P.nr - p2), q0,
                               a.fwd_words) == ext_log;
    a.bwd_full = lane_scan<false>(P, i, pos, min(i, pos), a.bwd_q0,
                                  a.bwd_words);
    a.fwd_mis = ext_log > 0 && ext_log <= LANES
                ? diff(win32(P.Q, i2), win32(P.R, p2)) : 0u;
    a.bwd_mis = bwd_log > 0 && bwd_log <= LANES
                ? diff(win32(P.Q, i - bwd_log), win32(P.R, pos - bwd_log))
                : 0u;
    return a;
}

// Parser::replay_events over the pair's records, 32 at a time: a first
// pass takes one event a lane (look_ahead), then the events are replayed
// in order. False on an inconsistent log or an overflow.
__device__ bool replay(Stack& f, const Pair& P, const int32_t* ev, int nev,
                       int lane) {
    const Cfg& c = P.c;
    const int dsz = P.dsz;
    int pred = -dsz, lit_run = 0, reg_lo = -1, reg_hi = 0, i = 0;
    PROBE(int* pc = f.pc);
    PROBE(long long t0 = 0);
    for (int k0 = 0; k0 < nev; k0 += LANES) {
        PROBE(t0 = clock64());
        int4 rec = make_int4(0, 0, 0, 0);  // record k0 + lane
        int rec_ext = 0;
        Ahead a{1, 0, 0u, 0u, 0u, 0, 0};
        if (k0 + lane < nev) {
            const int4* r = (const int4*)(ev + (size_t)(k0 + lane) * 8);
            rec = r[0];
            rec_ext = r[1].x;
            a = look_ahead(P, rec.x, rec.y, rec.z, rec.w, rec_ext);
        }
        const int m = min(LANES, nev - k0);
        PROBE(pc[FP_FWD_SYMS] +=
              LANES * __reduce_add_sync(FULL, a.fwd_words));
        PROBE(pc[FP_BWD_SYMS] +=
              LANES * __reduce_add_sync(FULL, a.bwd_words));
        PROBE(pc[FP_CYC_REC] += clock64() - t0);
        for (int kk = 0; kk < m; ++kk) {
            PROBE(t0 = clock64());
            PROBE(++pc[FP_EVENTS]);
            const int i_ev = __shfl_sync(FULL, rec.x, kk);
            const int best_pos = __shfl_sync(FULL, rec.y, kk);
            const int best_len = __shfl_sync(FULL, rec.z, kk);
            const int bwd_log = __shfl_sync(FULL, rec.w, kk);
            const int ext_log = __shfl_sync(FULL, rec_ext, kk);
            const int ext_ok = __shfl_sync(FULL, a.ext_ok, kk);
            if (i_ev < i || i_ev + c.msl >= dsz || !ext_ok) return false;
            // the literal steps up to i_ev; pred desyncs once the run
            // passes mqd
            lit_run += i_ev - i;
            pred = lit_run > c.mqd ? -dsz : pred + (i_ev - i);
            i = i_ev;
            PROBE(pc[FP_CYC_REC] += clock64() - t0);
            int flag = F_DISTANT;
            if (pred >= 0 && abs(best_pos - pred) <= c.mrd) {
                if (bwd_log != 0) return false;
                PROBE(t0 = clock64());
                const Gap g = gap_of(i - lit_run, pred - lit_run,
                                     best_pos + best_len, lit_run);
                if (!emit_gap(f, P, g, gap_split(P, g, lane), lane) ||
                    !f.push(i, F_CLOSE, best_pos, best_len))
                    return false;
                PROBE(pc[FP_CYC_GAP] += clock64() - t0);
            } else {
                if (lit_run && !f.push(i - lit_run, F_LIT, 0, lit_run))
                    return false;
                if (reg_lo >= 0 && reg_hi - reg_lo < c.reg) {
                    PROBE(t0 = clock64());
                    if (!kill(f, reg_lo, i, lane)) return false;
                    reg_lo = -1;
                    PROBE(pc[FP_CYC_KILL] += clock64() - t0);
                }
                if (f.n > 0 && f.t_kind == F_LIT) {
                    PROBE(t0 = clock64());
                    PROBE(++pc[FP_BWD_SCANS]);
                    // the scan capped by the literal entry: the uncapped
                    // one where it ends within the cap, else the last
                    // qualifying offset below the cap
                    const int cap = min(min(i, best_pos), f.t_len);
                    const int full = __shfl_sync(FULL, a.bwd_full, kk);
                    const unsigned q0 =
                        __shfl_sync(FULL, a.bwd_q0, kk) & low_bits(cap);
                    long long steps = 0;
                    const int bwd =
                        full <= cap ? full
                        : cap <= LANES ? (q0 ? top_bit(q0) + 1 : 0)
                                       : ext_scan<false>(P.Q, P.R, c.aw, c.am,
                                                         c.ar, i, best_pos,
                                                         cap, lane, steps);
                    PROBE(pc[FP_CYC_BWD] += clock64() - t0);
                    if (bwd != bwd_log) return false;
                    if (bwd) {
                        PROBE(t0 = clock64());
                        const unsigned mis = __shfl_sync(FULL, a.bwd_mis, kk);
                        f.add_top_len(-bwd);
                        if (f.t_len == 0) f.pop();
                        if (!(bwd <= LANES
                              ? emit_word(f, mis, best_pos - bwd, bwd,
                                          i - bwd, F_DISTANT, F_CLOSE, false,
                                          lane)
                              : emit_runs(f, P, i - bwd, best_pos - bwd, bwd,
                                          i - bwd, F_DISTANT, F_CLOSE, false,
                                          lane)))
                            return false;
                        flag = F_CLOSE;
                        reg_lo = i - bwd;
                        PROBE(pc[FP_CYC_EMIT] += clock64() - t0);
                    }
                } else if (bwd_log != 0) {
                    return false;
                }
                if (!f.push(i, flag, best_pos, best_len)) return false;
                if (flag == F_DISTANT) reg_lo = i;
                // reg_lo is now i - bwd or i, never negative: the host
                // replay's search for the latest DISTANT factor when it is
                // negative never runs
            }
            // the forward scan equals ext_log (look_ahead)
            i += best_len;
            pred = best_pos + best_len;
            lit_run = 0;
            PROBE(t0 = clock64());
            const unsigned mis = __shfl_sync(FULL, a.fwd_mis, kk);
            if (!(ext_log <= LANES
                  ? emit_word(f, mis, pred, ext_log, i, F_CLOSE, F_CLOSE,
                              false, lane)
                  : emit_runs(f, P, i, pred, ext_log, i, F_CLOSE, F_CLOSE,
                              false, lane)))
                return false;
            PROBE(pc[FP_CYC_EMIT] += clock64() - t0);
            i += ext_log;
            pred += ext_log;
            reg_hi = i;
        }
    }
    // the literal steps to the end, where i + msl reaches dsz
    if (i + c.msl < dsz) {
        const int d = dsz - c.msl - i;
        lit_run += d;
        pred = lit_run > c.mqd ? -dsz : pred + d;
        i += d;
    }
    PROBE(t0 = clock64());
    const bool ok =
        pred < 0 ? f.push(i - lit_run, F_LIT, 0, lit_run + (dsz - i))
                 : emit_runs(f, P, i - lit_run, pred - lit_run - c.msl,
                             lit_run + (dsz - i), i - lit_run, F_CLOSE,
                             F_CLOSE, false, lane);
    PROBE(pc[FP_CYC_EMIT] += clock64() - t0);
    return ok;
}

// Parser::stats as one warp pass: lane l folds the slice [l s, l s + s)
// of the final list into a summary, and the summaries are folded in lane
// order. A summary: the slice's part before its first DISTANT (close-match
// length, whether it holds a close match, the literal length before its
// last close match and after it) and, when it holds a DISTANT, the
// components it completes and the state after its last DISTANT.
__device__ void component_stats(const Stack& f, int reg, int lane,
                                int out[3]) {
    __syncwarp();
    const int n = f.n;
    const int s = ((n + LANES - 1) / LANES) | 1;  // odd: fewer bank conflicts
    const int a = min(n, lane * s), b = min(n, a + s);
    int C = 0, Lb = 0, La = 0, tm = 0, tl = 0, nc = 0, cm = 0, cl = 0;
    int pend = 0;
    bool hasC = false, hasD = false;
    for (int k = a; k < b; ++k) {
        const int2 e = f.get(k);
        const int kind = e.x & 3, len = e.y;
        if (kind == F_DISTANT) {
            if (hasD && cm && cm + cl >= reg) {
                tm += cm;
                tl += cl;
                ++nc;
            }
            hasD = true;
            cm = len;
            cl = 0;
            pend = 0;
        } else if (!hasD) {
            if (kind == F_CLOSE) {
                C += len;
                Lb += La;
                La = 0;
                hasC = true;
            } else {
                La += len;
            }
        } else if (kind == F_CLOSE) {
            cm += len;
            cl += pend;
            pend = 0;
        } else {
            pend += len;
        }
    }
    PROBE(f.pc[FP_BELOW_RING] +=
          __reduce_add_sync(FULL, max(0, min(b, f.lo) - a)));
    const int flags = (hasC ? 1 : 0) | (hasD ? 2 : 0);
    int s_cm = 0, s_cl = 0, s_pend = 0, t_m = 0, t_l = 0, t_c = 0;
    for (int j = 0; j < LANES; ++j) {
        const int jf = __shfl_sync(FULL, flags, j);
        s_cm += __shfl_sync(FULL, C, j);
        const int jLb = __shfl_sync(FULL, Lb, j);
        const int jLa = __shfl_sync(FULL, La, j);
        if (jf & 1) {
            s_cl += s_pend + jLb;
            s_pend = jLa;
        } else {
            s_pend += jLa;
        }
        if (jf & 2) {
            if (s_cm && s_cm + s_cl >= reg) {
                t_m += s_cm;
                t_l += s_cl;
                ++t_c;
            }
            t_m += __shfl_sync(FULL, tm, j);
            t_l += __shfl_sync(FULL, tl, j);
            t_c += __shfl_sync(FULL, nc, j);
            s_cm = __shfl_sync(FULL, cm, j);
            s_cl = __shfl_sync(FULL, cl, j);
            s_pend = __shfl_sync(FULL, pend, j);
        }
    }
    if (s_cm && s_cm + s_cl >= reg) {
        t_m += s_cm;
        t_l += s_cl;
        ++t_c;
    }
    out[0] = t_m;
    out[1] = t_l;
    out[2] = t_c;
}

// Grid (slices, G): block (s, g) serves reference g; its warps take
// queries order[k] from the counter next_q[g]. Dynamic shared memory: the
// reference's planes (ref_smem; rows of RW words), then a ring of `ring`
// entries a warp, then a slot of three rows of QW words a warp for a
// query's planes (q_smem).
__global__ void __launch_bounds__(MAX_WARPS * LANES) fold_kernel(
    const uint32_t* __restrict__ rpl, const uint32_t* __restrict__ qpl,
    const int32_t* __restrict__ ev, const int32_t* __restrict__ nev,
    const int32_t* __restrict__ dszs, const int32_t* __restrict__ nrs,
    const int32_t* __restrict__ order, int32_t* __restrict__ next_q,
    int32_t* __restrict__ stats, int32_t* __restrict__ status,
    int32_t* __restrict__ stack, int32_t* __restrict__ nfac, int B, int RW,
    int QW, int evc, int F, int words, int ring, int ref_smem, int q_smem,
    Cfg c, long long* __restrict__ probe) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
    const int g = blockIdx.y;
    const int nr = nrs[g];
    const uint32_t* rg = rpl + (size_t)g * 3 * RW;
    Planes R{rg, rg + RW, rg + 2 * (size_t)RW, RW};
    uint32_t* rest = smem;
    if (ref_smem) {
        const int nw = min(RW, (nr >> 5) + 2);
        planes_to_smem(smem, rg, RW, nw, threadIdx.x, blockDim.x);
        cp_async_wait_all();
        __syncthreads();
        R = Planes{smem, smem + RW, smem + 2 * (size_t)RW, nw};
        rest = smem + 3 * (size_t)RW;
    }
    int2* my_ring = (int2*)rest + (size_t)warp * ring;
    uint32_t* qslot = rest + 2 * (size_t)(blockDim.x / LANES) * ring
                      + (size_t)warp * 3 * QW;
    for (;;) {
        __syncwarp();  // the last pair's reads of the query slot are done
        int k = 0;
        if (lane == 0) k = atomicAdd(next_q + g, 1);
        k = __shfl_sync(FULL, k, 0);
        if (k >= B) break;  // the whole warp
        const int b = order[k];
        const size_t pair = (size_t)g * B + b;
#ifdef LZT_PROBE
        int pc[NPROBE] = {};  // 32 bits: fewer registers than clock64()'s
        const long long t_start = clock64();
#else
        int* pc = nullptr;
#endif
        const int n_ev = nev[pair];
        int st[3] = {0, 0, 0};
        int code = 1, nf = 0;
        if (n_ev >= 0) {
            const int dsz = dszs[b];
            const uint32_t* qb = qpl + (size_t)b * 3 * QW;
            Planes Q{qb, qb + QW, qb + 2 * (size_t)QW, QW};
            if (q_smem) {
                const int nw = min(QW, (dsz >> 5) + 2);
                planes_to_smem(qslot, qb, QW, nw, lane, LANES);
                cp_async_wait_all();
                __syncwarp();
                Q = Planes{qslot, qslot + QW, qslot + 2 * (size_t)QW, nw};
            }
            const Pair P{R, Q, nr, dsz, c};
            Stack f{stack + pair * F * words, my_ring, words, F, ring, 0, 0,
                    0, 0, 0, lane == 0, pc};
            code = -1;
            if (n_ev <= evc &&
                replay(f, P, ev + pair * evc * 8, n_ev, lane)) {
                PROBE(const long long t0 = clock64());
                component_stats(f, c.reg, lane, st);
                PROBE(pc[FP_CYC_STATS] += clock64() - t0);
                code = 0;
                nf = f.n;
            }
            PROBE(pc[FP_NFAC] = f.n);
        }
        if (lane == 0) {
            int32_t* so = stats + pair * 3;
            so[0] = st[0];
            so[1] = st[1];
            so[2] = st[2];
            status[pair] = code;
            nfac[pair] = nf;
        }
#ifdef LZT_PROBE
        pc[FP_SPAN] = (int)(clock64() - t_start);
        if (probe && lane == 0)
            for (int j = 0; j < NPROBE; ++j) probe[pair * NPROBE + j] = pc[j];
#endif
    }
}

}  // namespace

// Version of the C interface below (dispatch_probe.py --baseline reads it
// to call an older checkout's build).
extern "C" int lzt_fold_abi() { return 2; }

// int64 fields a pair of the probe build's counts (ops/fold_stats.py
// checks it against its field names when it loads the library).
extern "C" int lzt_fold_nprobe() { return NPROBE; }

// Dynamic shared memory (bytes) a block of the fold kernel may take on the
// current device: the opt-in limit less the kernel's static shared memory,
// or -1 on an error.
extern "C" int lzt_fold_smem_max() {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0)
        rc = (int)cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc == 0) rc = (int)cudaFuncGetAttributes(&fa, fold_kernel);
    return rc == 0 ? optin - (int)fa.sharedSizeBytes : -1;
}

// Blocks of `warps` warps with `smem` bytes of shared memory that one SM
// holds at once, or -1 on an error.
extern "C" int lzt_fold_occupancy(int smem, int warps) {
    int n = 0;
    int rc = (int)cudaFuncSetAttribute(
        fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == 0)
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, fold_kernel, warps * LANES, smem);
    return rc == 0 ? n : -1;
}

// One launch over G x B pairs on `stream`; returns cudaGetLastError().
// Scratch from the caller: rpl (G, 3, LrP / 32) and qpl (B, 3, LqP / 32)
// uint32 plane words (LrP a multiple of 128, LqP of 32), order (B,) the
// queries longest first, next_q (G,) zeroed counters. The launch: `warps`
// warps a block, `slices` blocks a reference, `smem` bytes of shared
// memory holding the reference's planes (ref_smem), a ring of `ring`
// entries (a power of two) a warp, and a query's planes a warp (q_smem,
// LqP a multiple of 128). probe (G, B, NPROBE) int64 is written by the
// probe build only.
extern "C" int lzt_fold_stats(const void* refbuf, const void* qbuf,
                              const void* ev, const void* nev,
                              const void* dszs, const void* nrs, void* stats,
                              void* status, void* stack, void* nfac, int G,
                              int B, int LrP, int LqP, int evc, int F,
                              int words, int msl, int mrd, int mqd, int reg,
                              int aw, int am, int ar, void* stream,
                              void* probe, void* rpl, void* qpl,
                              const void* order, void* next_q, int smem,
                              int ref_smem, int q_smem, int ring, int warps,
                              int slices) {
    if (G * B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int rc = pack_planes(refbuf, nrs, G, LrP, rpl, st);
    if (rc == 0) rc = pack_planes(qbuf, dszs, B, LqP, qpl, st);
    if (rc == 0)
        rc = (int)cudaFuncSetAttribute(
            fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    fold_kernel<<<dim3(slices, G), warps * LANES, smem, st>>>(
        (const uint32_t*)rpl, (const uint32_t*)qpl, (const int32_t*)ev,
        (const int32_t*)nev, (const int32_t*)dszs, (const int32_t*)nrs,
        (const int32_t*)order, (int32_t*)next_q, (int32_t*)stats,
        (int32_t*)status, (int32_t*)stack, (int32_t*)nfac, B, LrP / LANES,
        LqP / LANES, evc, F, words, ring, ref_smem, q_smem,
        Cfg{msl, mrd, mqd, reg, aw, am, ar}, (long long*)probe);
    return (int)cudaGetLastError();
}
