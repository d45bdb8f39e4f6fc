// ============================================================================
// fold_stats.cu - the event-log fold of the PyTorch/CUDA port: factors and
// the stats triple of every pair, on the device.
//
// Replaces the emission half of the JAX package's XLA automaton
// (lzani_tpu/ops/parse.py make_pair_parser: push/emit_aligned/emit_gap at
// :193-345, the match branches with the region kill at :394-498, the tail
// at :515-527) and its stats fold _component_stats (:535). That backend
// (--backend jax) computes each pair's triple on the device, with no host
// replay. Here the decisions come from the parse kernel's event log
// (csrc/parse_events.cu), and this kernel turns a log into the factor list
// and the triple {sym_in_matches, sym_in_literals, components}. Its exact
// template is the host replay Parser::replay_events with emit_aligned_range,
// emit_gap_two_sided, extend_fwd/extend_bwd and stats
// (csrc/lzani_core.cpp), and it keeps every consistency check of that
// replay: events in query order, no bwd on a close match, and the logged
// bwd and ext equal to the extension scans. A log that fails one gets
// status -1 and no stats: a wrong log must not hide.
//
// Inputs are those of a parse_events launch and its outputs:
//   refbuf (G, LrP) u8, qbuf (B, LqP) u8, ev (G, B, evc, 8) i32,
//   nev (G, B) i32 (< 0: no log, the pair is skipped with status 1),
//   dszs (B,) i32 query length + mrd, nrs (G,) i32 composite length.
// Outputs: stats (G, B, 3) i32, status (G, B) i32 (0 ok, -1 rejected,
// 1 skipped), nfac (G, B) i32 factors in the final list, and the factor
// stack (G, B, F, words): with words = 4 it is the factor list {dpos,
// kind, rpos, len}; with words = 2 it is scratch {dpos << 2 | kind, len}
// (the stats need no rpos).
//
// Design: one thread per pair, the scalar replay as it is, alone in its
// warp: pairs differ in every branch and loop count, and 32 pairs in one
// warp would run their branches in turn. The factor list is a stack in
// global memory (F = LqP + 4 entries a pair, the JAX automaton's Fmax),
// because the region kill pops factors pushed earlier.
// The gap split needs no arrays: the right side's match count is counted
// once, then the split sweep adds the left side's count and takes off the
// right side's as it moves. The extension window is a count, and the
// position that leaves it is read again (no aw-sized array). Symbols past
// a buffer's end read as N (4 for the reference, 5 for the query), as in
// the parse kernel and the host's guard band.
//
// What bounds it: the latency of one thread's dependent steps. A pair's
// thread walks its aligned ranges symbol by symbol (each extension twice,
// scan then emission), so a launch lasts as long as its longest related
// pair, and the card is nearly idle (64 to 512 busy threads a launch on
// the main path). Warp-level emission (the parse kernel's ballots) is the
// later design.
// ============================================================================

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SYM_N_REF = 4;
constexpr int SYM_N_SEQ = 5;
constexpr int F_LIT = 0, F_CLOSE = 1, F_DISTANT = 2;
constexpr int LANES = 32;
constexpr int THREADS = 128;  // four warps a block, one pair a warp

struct Cfg {
    int msl, mrd, mqd, reg, aw, am, ar;
};

// The factor stack of one pair: `words` int32 per entry.
struct Stack {
    int32_t* base;
    int words;
    int cap;
    int n;
    bool overflow;

    __device__ void push(int dpos, int kind, int rpos, int len) {
        if (n >= cap) {
            overflow = true;
            return;
        }
        int32_t* e = base + (size_t)n * words;
        if (words == 4) {
            e[0] = dpos;
            e[1] = kind;
            e[2] = rpos;
            e[3] = len;
        } else {
            e[0] = dpos * 4 + kind;
            e[1] = len;
        }
        ++n;
    }
    __device__ int32_t* top() const { return base + (size_t)(n - 1) * words; }
    __device__ int kind_at(int k) const {
        const int32_t* e = base + (size_t)k * words;
        return words == 4 ? e[1] : (e[0] & 3);
    }
    __device__ int dpos_at(int k) const {
        const int32_t* e = base + (size_t)k * words;
        return words == 4 ? e[0] : (e[0] >> 2);
    }
    __device__ int len_at(int k) const {
        return base[(size_t)k * words + words - 1];
    }
    __device__ int top_kind() const { return kind_at(n - 1); }
    __device__ int top_len() const { return len_at(n - 1); }
    __device__ void add_top_len(int d) { top()[words - 1] += d; }
};

struct Pair {
    const uint8_t* ref;
    int nr;
    const uint8_t* q;
    int dsz;
    Cfg c;

    __device__ int r(int p) const {
        return (p >= 0 && p < nr) ? (int)ref[p] : SYM_N_REF;
    }
    __device__ int s(int p) const {
        return (p >= 0 && p < dsz) ? (int)q[p] : SYM_N_SEQ;
    }
    __device__ bool eq(int rp, int qp) const { return r(rp) == s(qp); }

    // Parser::emit_aligned_range
    __device__ void emit_aligned(Stack& f, int dpos, int rpos, int len,
                                 bool backward) const {
        int flag = backward ? F_DISTANT : F_CLOSE;
        int run = 0;
        bool matching = false;
        for (int j = 0; j < len; ++j) {
            if (eq(rpos + j, dpos + j)) {
                if (matching) {
                    ++run;
                } else {
                    if (run) f.push(dpos + j - run, F_LIT, 0, run);
                    run = 1;
                    matching = true;
                }
            } else if (matching) {
                f.push(dpos + j - run, flag, rpos + j - run, run);
                run = 1;
                matching = false;
                flag = F_CLOSE;
            } else {
                ++run;
            }
        }
        if (matching)
            f.push(dpos + len - run, flag, rpos + len - run, run);
        else if (run)
            f.push(dpos + len - run, F_LIT, 0, run);
    }

    // rhs[j] of Parser::emit_gap_two_sided: j in 1..min(to_scan, r_right)
    // compares from the right end; beyond that the entry is absent (false)
    __device__ bool rhs_eq(int dpos, int r_right, int len, int lim,
                           int j) const {
        return j >= 1 && j <= lim && eq(r_right - j, dpos + len - j);
    }

    // Parser::emit_gap_two_sided
    __device__ void emit_gap(Stack& f, int dpos, int r_left, int r_right,
                             int len) const {
        const int to_scan =
            r_right < r_left ? len : min(r_right - r_left, len);
        const int lim = min(to_scan, r_right);
        // rhs_nm[m]: matches over 1..m for m <= lim, 0 above (the host's
        // rhs is resized with zero entries)
        int pm = 0;
        for (int j = 1; j <= lim; ++j) pm += eq(r_right - j, dpos + len - j);
        // split: argmax over j of lhs_nm[j] + rhs_nm[to_scan - j], the
        // rightmost on ties; pm is the prefix count at m = to_scan - j
        int best = 0, split = 0, lnm = 0;
        for (int j = 0; j <= to_scan; ++j) {
            if (j > 0) {
                lnm += eq(r_left + j - 1, dpos + j - 1);
                pm -= rhs_eq(dpos, r_right, len, lim, to_scan - j + 1);
            }
            const int tot = lnm + (to_scan - j <= lim ? pm : 0);
            if (tot >= best) {
                best = tot;
                split = j;
            }
        }
        if (split > 0) {
            bool e = eq(r_left, dpos);
            int dp = dpos;
            f.push(dp++, e ? F_CLOSE : F_LIT, e ? r_left : 0, 1);
            for (int j = 2; j <= split; ++j, ++dp) {
                e = eq(r_left + j - 1, dpos + j - 1);
                const int kind = e ? F_CLOSE : F_LIT;
                if (kind == f.top_kind())
                    f.add_top_len(1);
                else
                    f.push(dp, kind, e ? r_left + j - 1 : 0, 1);
            }
        }
        if (to_scan < len) {
            if (split > 0 && f.top_kind() == F_LIT)
                f.add_top_len(len - to_scan);
            else
                f.push(dpos + split, F_LIT, 0, len - to_scan);
        }
        if (split < to_scan) {
            const int shift = len - to_scan;
            const int from_right = to_scan - split;
            bool e = rhs_eq(dpos, r_right, len, lim, from_right);
            int dp = dpos + split + shift;
            if (!e && (split > 0 || shift > 0) && f.n > 0 &&
                f.top_kind() == F_LIT) {
                f.add_top_len(1);  // dp deliberately not advanced
            } else {
                f.push(dp++, e ? F_CLOSE : F_LIT,
                       e ? r_right - from_right : 0, 1);
            }
            for (int j = from_right - 1; j > 0; --j, ++dp) {
                e = rhs_eq(dpos, r_right, len, lim, j);
                const int kind = e ? F_CLOSE : F_LIT;
                if (kind == f.top_kind())
                    f.add_top_len(1);
                else
                    f.push(dp, kind, e ? r_right - j : 0, 1);
            }
        }
    }

    // Parser::extend_fwd / extend_bwd: the window count of misses over the
    // last aw steps; the step leaving the window is read again
    __device__ int extend(int dpos, int rpos, int max_len, bool fwd) const {
        int bad = 0, run = c.ar, last = 0;
        for (int e = 0;; ++e) {
            if (fwd ? !(dpos + e < dsz && rpos + e < nr)
                    : !(dpos - e > 0 && rpos - e > 0 && e < max_len))
                break;
            const int miss = fwd ? !eq(rpos + e, dpos + e)
                                 : !eq(rpos - e - 1, dpos - e - 1);
            if (e >= c.aw) {
                const int o = e - c.aw;
                bad -= fwd ? !eq(rpos + o, dpos + o)
                           : !eq(rpos - o - 1, dpos - o - 1);
            }
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

    // Parser::replay_events; false on an inconsistent log
    __device__ bool replay(Stack& f, const int32_t* ev, int nev) const {
        const int msl = c.msl;
        int pred = -dsz, lit_run = 0, reg_lo = -1, reg_hi = 0, i = 0;
        for (int k = 0; k < nev; ++k) {
            const int32_t* e = ev + (size_t)k * 8;
            const int i_ev = e[0], best_pos = e[1], best_len = e[2];
            const int bwd_log = e[3], ext_log = e[4];
            if (i_ev < i || i_ev + msl >= dsz) return false;
            while (i < i_ev) {
                ++i;
                ++pred;
                ++lit_run;
                if (lit_run > c.mqd) pred = -dsz;
            }
            int flag = F_DISTANT;
            if (pred >= 0 && abs(best_pos - pred) <= c.mrd) {
                if (bwd_log != 0) return false;
                emit_gap(f, i - lit_run, pred - lit_run, best_pos + best_len,
                         lit_run);
                f.push(i, F_CLOSE, best_pos, best_len);
            } else {
                if (lit_run) f.push(i - lit_run, F_LIT, 0, lit_run);
                if (reg_lo >= 0 && reg_hi - reg_lo < c.reg) {
                    while (f.n > 0 && f.dpos_at(f.n - 1) >= reg_lo) --f.n;
                    int run_len = i - reg_lo;
                    while (f.n > 0 && f.top_kind() == F_LIT) {
                        run_len += f.top_len();
                        --f.n;
                    }
                    f.push(i - run_len, F_LIT, 0, run_len);
                    reg_lo = -1;
                }
                if (f.n > 0 && f.top_kind() == F_LIT) {
                    const int bwd = extend(i, best_pos, f.top_len(), false);
                    if (bwd != bwd_log) return false;
                    if (bwd) {
                        f.add_top_len(-bwd);
                        if (f.top_len() == 0) --f.n;
                        emit_aligned(f, i - bwd, best_pos - bwd, bwd, true);
                        flag = F_CLOSE;
                        reg_lo = i - bwd;
                    }
                } else if (bwd_log != 0) {
                    return false;
                }
                f.push(i, flag, best_pos, best_len);
                if (flag == F_DISTANT) reg_lo = i;
                if (reg_lo < 0)
                    for (int j = f.n - 1; j >= 0; --j)
                        if (f.kind_at(j) == F_DISTANT) {
                            reg_lo = f.dpos_at(j);
                            break;
                        }
            }
            i += best_len;
            pred = best_pos + best_len;
            lit_run = 0;
            const int ext = extend(i, pred, 0, true);
            if (ext != ext_log) return false;
            emit_aligned(f, i, pred, ext, false);
            i += ext;
            pred += ext;
            reg_hi = i;
        }
        while (i + msl < dsz) {
            ++i;
            ++pred;
            ++lit_run;
            if (lit_run > c.mqd) pred = -dsz;
        }
        if (pred < 0)
            f.push(i - lit_run, F_LIT, 0, lit_run + (dsz - i));
        else
            emit_aligned(f, i - lit_run, pred - lit_run - msl,
                         lit_run + (dsz - i), false);
        return true;
    }
};

// Parser::stats over the final factor list
__device__ void component_stats(const Stack& f, int reg, int32_t* out) {
    int tm = 0, tl = 0, nc = 0, cm = 0, cl = 0, pend = 0;
    for (int k = 0; k < f.n; ++k) {
        const int kind = f.kind_at(k), len = f.len_at(k);
        if (kind == F_DISTANT) {
            if (cm && cm + cl >= reg) {
                tm += cm;
                tl += cl;
                ++nc;
            }
            cm = len;
            cl = 0;
            pend = 0;
        } else if (kind == F_CLOSE) {
            cm += len;
            cl += pend;
            pend = 0;
        } else {
            pend += len;
        }
    }
    if (cm && cm + cl >= reg) {
        tm += cm;
        tl += cl;
        ++nc;
    }
    out[0] = tm;
    out[1] = tl;
    out[2] = nc;
}

__global__ void __launch_bounds__(THREADS) fold_stats_kernel(
    const uint8_t* __restrict__ refbuf, const uint8_t* __restrict__ qbuf,
    const int32_t* __restrict__ ev, const int32_t* __restrict__ nev,
    const int32_t* __restrict__ dszs, const int32_t* __restrict__ nrs,
    int32_t* __restrict__ stats, int32_t* __restrict__ status,
    int32_t* __restrict__ stack, int32_t* __restrict__ nfac, int G, int B,
    int LrP, int LqP, int evc, int F, int words, Cfg c) {
    const int pair = (blockIdx.x * THREADS + threadIdx.x) / LANES;
    if (threadIdx.x % LANES != 0 || pair >= G * B) return;
    const int g = pair / B, b = pair % B;
    int32_t* st = stats + (size_t)pair * 3;
    st[0] = st[1] = st[2] = 0;
    nfac[pair] = 0;
    const int n_ev = nev[pair];
    if (n_ev < 0) {
        status[pair] = 1;
        return;
    }
    const Pair P{refbuf + (size_t)g * LrP, nrs[g], qbuf + (size_t)b * LqP,
                 dszs[b], c};
    Stack f{stack + (size_t)pair * F * words, words, F, 0, false};
    const bool ok = n_ev <= evc &&
                    P.replay(f, ev + (size_t)pair * evc * 8, n_ev) &&
                    !f.overflow;
    if (!ok) {
        status[pair] = -1;
        return;
    }
    component_stats(f, c.reg, st);
    nfac[pair] = f.n;
    status[pair] = 0;
}

}  // namespace

// One launch over G x B pairs on `stream`; returns cudaGetLastError().
extern "C" int lzt_fold_stats(const void* refbuf, const void* qbuf,
                              const void* ev, const void* nev,
                              const void* dszs, const void* nrs, void* stats,
                              void* status, void* stack, void* nfac, int G,
                              int B, int LrP, int LqP, int evc, int F,
                              int words, int msl, int mrd, int mqd, int reg,
                              int aw, int am, int ar, void* stream) {
    const int n = G * B;
    const int per_block = THREADS / LANES;
    if (n > 0) {
        fold_stats_kernel<<<(n + per_block - 1) / per_block, THREADS, 0,
                            (cudaStream_t)stream>>>(
            (const uint8_t*)refbuf, (const uint8_t*)qbuf,
            (const int32_t*)ev, (const int32_t*)nev, (const int32_t*)dszs,
            (const int32_t*)nrs, (int32_t*)stats, (int32_t*)status,
            (int32_t*)stack, (int32_t*)nfac, G, B, LrP, LqP, evc, F, words,
            Cfg{msl, mrd, mqd, reg, aw, am, ar});
    }
    return (int)cudaGetLastError();
}
