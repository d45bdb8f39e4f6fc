// ============================================================================
// planes.cuh - bit-plane symbols, shared by the port's CUDA kernels
// (parse_events.cu, fold_stats.cu).
//
// A (rows, L) buffer of one-byte symbol codes is packed by a pre-pass
// kernel (pack_planes) into three planes of 32-symbol words a row: bit j
// of word w is symbol 32 w + j; lo and hi are bits 0 and 1 of the code,
// nn marks N (a code >= 4, or a position at or past the row's length).
// 32 symbols at any position are two words a plane and a funnel shift,
// and the mismatch mask of two windows is (lo ^ lo') | (hi ^ hi') | N |
// N': any N mismatches, as the reference's N (4) never equals the
// query's (5). Words outside a row read as N, so every scan past a
// buffer's end stops without caps.
//
// Also here: the sliding-window extension scan on those words
// (Parser::extend_fwd / extend_bwd of csrc/lzani_core.cpp), which both
// kernels run, 32 offsets a warp step (ext_scan) or, for the long-genome
// parse, 4,096 (ext_wide), and the cp.async copy of a row's planes into
// shared memory.
// ============================================================================
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// Probe builds (-DLZT_PROBE): per-pair spans and counts.
#ifdef LZT_PROBE
#define PROBE(stmt) stmt
#else
#define PROBE(stmt)
#endif

namespace {

constexpr int SYM_N_REF = 4;
constexpr int SYM_N_SEQ = 5;
constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;

// highest set bit of m != 0
__device__ __forceinline__ int top_bit(unsigned m) { return 31 - __clz(m); }

// Three planes of 32-symbol words (lo = bit 0 of the code, hi = bit 1,
// nn = N). Words outside [0, nw) read as N.
struct Planes {
    const uint32_t* lo;
    const uint32_t* hi;
    const uint32_t* nn;
    int nw;
};

struct W3 {
    uint32_t lo, hi, nn;
};

__device__ __forceinline__ W3 word_at(const Planes& P, int w) {
    if ((unsigned)w < (unsigned)P.nw) return W3{P.lo[w], P.hi[w], P.nn[w]};
    return W3{0u, 0u, FULL};
}

// the 32 symbols [32 w + s, 32 w + s + 32) of words w (a) and w + 1 (b)
__device__ __forceinline__ W3 join(const W3& a, const W3& b, int s) {
    return W3{__funnelshift_r(a.lo, b.lo, s), __funnelshift_r(a.hi, b.hi, s),
              __funnelshift_r(a.nn, b.nn, s)};
}

// the 32 symbols [p, p + 32) (p may be negative: they read as N)
__device__ __forceinline__ W3 win32(const Planes& P, int p) {
    const int w = p >> 5;  // floor
    return join(word_at(P, w), word_at(P, w + 1), p & 31);
}

// the 64 symbols [p, p + 64) as two windows
__device__ __forceinline__ void win64(const Planes& P, int p, W3& a, W3& b) {
    const int w = p >> 5;
    const W3 x = word_at(P, w), y = word_at(P, w + 1), z = word_at(P, w + 2);
    a = join(x, y, p & 31);
    b = join(y, z, p & 31);
}

// bit j set where the two windows' symbols j differ or either is N
__device__ __forceinline__ uint32_t diff(const W3& a, const W3& b) {
    return (a.lo ^ b.lo) | (a.hi ^ b.hi) | a.nn | b.nn;
}

// offset of the first mismatch of a window, 32 when all 32 match
__device__ __forceinline__ int first_miss(uint32_t d) {
    return d ? __ffs(d) - 1 : LANES;
}

// mismatch mask of scan offsets [e0, e0 + 32) of an extension from query
// position dpos and reference position rpos: bit j is offset e0 + j,
// which compares dpos + e0 + j with rpos + e0 + j forward, and
// dpos - 1 - e0 - j with rpos - 1 - e0 - j backward
template <bool FWD>
__device__ __forceinline__ unsigned miss_word(const Planes& Q,
                                              const Planes& R, int dpos,
                                              int rpos, int e0) {
    if (FWD) return diff(win32(Q, dpos + e0), win32(R, rpos + e0));
    // offset e reads position dpos - 1 - e: the window ending there,
    // reversed
    return __brev(diff(win32(Q, dpos - e0 - LANES),
                       win32(R, rpos - e0 - LANES)));
}

// Sliding-window approximate extension (Parser::extend_fwd/extend_bwd)
// over at most max_len offsets, 32 a warp step, each step's mismatch mask
// one word compare: lane l's window count is a carry plus the misses
// entering up to it less those leaving (for aw <= 32 the last 64
// offsets' mask shifted by aw, above that the mask at offset -aw); the
// scan stops at the first offset over am, and returns the end of the
// last match before it that ends a run of >= ar (the run before offset
// 0 counts as ar long). Every lane returns the same value; `steps` counts
// the warp steps in probe builds.
template <bool FWD>
__device__ __forceinline__ int ext_scan(const Planes& Q, const Planes& R,
                                        int aw, int am, int ar, int dpos,
                                        int rpos, int max_len, int lane,
                                        long long& steps) {
    const unsigned le = FULL >> (31 - lane);  // lanes <= this one
    int carry = 0, lastmiss = -1 - ar, last = 0;
    unsigned prev = 0;                        // miss mask of the last step
    for (int base = 0; base < max_len; base += LANES) {
        PROBE(++steps);
        const int left = max_len - base;
        const unsigned inm = left >= LANES ? FULL : (1u << left) - 1;
        const unsigned M = miss_word<FWD>(Q, R, dpos, rpos, base) & inm;
        unsigned O;  // offsets whose window drops a miss (e - aw)
        if (aw <= LANES) {
            O = (unsigned)((((unsigned long long)M << LANES) | prev)
                           >> (LANES - aw));
        } else {
            const int sh = aw - base;
            const unsigned ge = sh <= 0 ? FULL : sh >= LANES ? 0u : FULL << sh;
            O = miss_word<FWD>(Q, R, dpos, rpos, base - aw) & inm & ge;
        }
        const bool in = (inm >> lane) & 1u;
        const bool miss = (M >> lane) & 1u;
        const int bad = carry + __popc(M & le) - __popc(O & le);
        const unsigned S = __ballot_sync(FULL, !in || bad > am);
        const unsigned Mle = M & le;
        const int lm = Mle ? base + top_bit(Mle) : lastmiss;
        unsigned Qm = __ballot_sync(FULL, in && !miss && base + lane - lm >= ar);
        if (S) Qm &= (1u << (__ffs(S) - 1)) - 1;  // offsets before the stop
        if (Qm) last = base + top_bit(Qm) + 1;
        if (S) break;
        carry += __popc(M) - __popc(O);
        if (M) lastmiss = base + top_bit(M);
        prev = M;
    }
    return last;
}

// bit k set where bits 32 + k - n + 1 .. 32 + k of the 64 bits hi:lo are
// (1 <= n < 32): the offsets of the word hi that end a run of n ones
__device__ __forceinline__ uint32_t run_ends(uint32_t lo, uint32_t hi,
                                             int n) {
    uint32_t r = FULL;  // lo:hi hold the runs of 2^b ones ending at a bit
    int off = 0;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
        if (n >> b & 1) {
            r &= __funnelshift_l(lo, hi, off);
            off += 1 << b;
        }
        hi &= __funnelshift_l(lo, hi, 1 << b);
        lo &= lo << (1 << b);
    }
    return r;
}

// 32-offset words a lane takes in a step of ext_wide
constexpr int EXT_WORDS = 4;

// The plane words that hold a lane's EXT_WORDS scan words from offset e
// of an extension (ext_wide): the EXT_WORDS + 1 words of each side's
// planes from the lowest position the scan words read.
struct ScanWords {
    W3 q[EXT_WORDS + 1], r[EXT_WORDS + 1];
    int sq, sr;  // the windows' shift within a word

    template <bool FWD>
    __device__ __forceinline__ void load(const Planes& Q, const Planes& R,
                                         int dpos, int rpos, int e) {
        // forward, offset word u reads [pos + e + 32 u, + 32); backward,
        // [pos - e - 32 (u + 1), + 32), reversed
        const int pq = FWD ? dpos + e : dpos - e - EXT_WORDS * LANES;
        const int pr = FWD ? rpos + e : rpos - e - EXT_WORDS * LANES;
        sq = pq & 31;
        sr = pr & 31;
#pragma unroll
        for (int k = 0; k <= EXT_WORDS; ++k) {
            q[k] = word_at(Q, (pq >> 5) + k);
            r[k] = word_at(R, (pr >> 5) + k);
        }
    }

    // the mismatch word of offsets e + 32 u + [0, 32) (miss_word)
    template <bool FWD>
    __device__ __forceinline__ unsigned miss(int u) const {
        const int k = FWD ? u : EXT_WORDS - 1 - u;
        const unsigned d = diff(join(q[k], q[k + 1], sq),
                                join(r[k], r[k + 1], sr));
        return FWD ? d : __brev(d);
    }
};

// ext_scan for aw <= 32 and 1 <= ar < 32, 32 x EXT_WORDS x 32 offsets a
// warp step: lane l takes the EXT_WORDS mismatch words from word
// EXT_WORDS l of the step (EXT_WORDS + 1 plane words a plane and side).
// With the word before each (its own, the lower lane's, or the last
// step's lane 31's), a lane holds every window it needs in one 64-offset
// mask: the misses in (e - aw, e] are a popcount of it, taken window by
// window only for the 8 windows of a quarter word whose span holds more
// than am misses, and e qualifies where e and the ar - 1 offsets before
// it match. A lane's words are examined without branches but that rare
// count (a word past the lane's first stop changes nothing), so their
// work overlaps; the lane keeps its last qualifying offset. The first
// stop is a vote, and the last qualifying offset before it a reduction.
// The next step's plane words are loaded before this step's are
// examined. Returns what ext_scan returns; `steps` counts the warp steps.
template <bool FWD>
__device__ __forceinline__ int ext_wide(const Planes& Q, const Planes& R,
                                        int aw, int am, int ar, int dpos,
                                        int rpos, int max_len, int lane,
                                        long long& steps) {
    constexpr int STEP = LANES * EXT_WORDS * LANES;
    const int e_lane = EXT_WORDS * LANES * lane;  // the lane's first offset
    const uint64_t win = ~0ull >> (64 - aw);      // a window's aw bits
    const uint64_t quarter = ~0ull >> (57 - aw);  // 8 windows' 7 + aw bits
    ScanWords next;
    next.load<FWD>(Q, R, dpos, rpos, e_lane);
    unsigned carry = 0;  // the word before the step's first
    int best = 0;        // the lane's last qualifying offset + 1
    for (int base = 0; base < max_len; base += STEP) {
        PROBE(++steps);
        unsigned M[EXT_WORDS];
#pragma unroll
        for (int u = 0; u < EXT_WORDS; ++u) M[u] = next.miss<FWD>(u);
        next.load<FWD>(Q, R, dpos, rpos, base + STEP + e_lane);
        const unsigned up = __shfl_up_sync(FULL, M[EXT_WORDS - 1], 1);
        unsigned prev = lane ? up : carry;
        uint64_t W[EXT_WORDS];
        unsigned inm[EXT_WORDS], q[EXT_WORDS];
        bool dense = false;
#pragma unroll
        for (int u = 0; u < EXT_WORDS; ++u) {
            const int left = max_len - (base + e_lane + u * LANES);
            inm[u] = left >= LANES ? FULL : left <= 0 ? 0u : (1u << left) - 1;
            const unsigned m = M[u] & inm[u];
            // bit t of W is offset e0 - aw + 1 + t (e0 the word's
            // first): the window of offset e0 + j is bits [j, j + aw)
            W[u] = ((uint64_t)m << LANES | prev) >> (LANES + 1 - aw);
            dense |= __popcll(W[u]) > am;
            // offsets whose ar-run of matches ends there
            q[u] = run_ends(~prev, ~m, ar) & inm[u];
            prev = m;
        }
        unsigned over[EXT_WORDS];  // offsets that stop the scan
#pragma unroll
        for (int u = 0; u < EXT_WORDS; ++u) over[u] = ~inm[u];
        if (dense) {
#pragma unroll
            for (int u = 0; u < EXT_WORDS; ++u) {
                if (__popcll(W[u]) <= am) continue;
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    const uint64_t E = W[u] >> (8 * h);
                    if (__popcll(E & quarter) > am) {
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            over[u] |= (unsigned)(__popcll(E >> j & win)
                                                  > am) << (8 * h + j);
                    }
                }
            }
        }
        int mine = best;
        bool stopped = false;
#pragma unroll
        for (int u = 0; u < EXT_WORDS; ++u) {
            unsigned qu = q[u];
            if (over[u]) qu &= (1u << (__ffs(over[u]) - 1)) - 1;
            if (!stopped && qu)
                mine = base + e_lane + u * LANES + top_bit(qu) + 1;
            stopped |= over[u] != 0;
        }
        const unsigned S = __ballot_sync(FULL, stopped);
        if (S) {
            // lanes above the first stop's keep what they held before
            const int L = __ffs(S) - 1;
            return __reduce_max_sync(FULL, lane <= L ? mine : best);
        }
        best = mine;
        carry = __shfl_sync(FULL, M[EXT_WORDS - 1], LANES - 1);
    }
    return __reduce_max_sync(FULL, best);
}

// the bits 0 of 8 bytes, byte i's at bit i (a multiply gathers them: each
// byte's bit lands at a bit of its own in the top byte, without carries)
__device__ __forceinline__ uint32_t gather8(uint64_t ones) {
    return (uint32_t)((ones & 0x0101010101010101ull) * 0x0102040810204080ull
                      >> 56);
}

// Bit planes of a (rows, L) symbol buffer (16-byte aligned, L a multiple
// of 32), one thread per 32-symbol word: (rows, 3, L / 32) words, a code
// >= 4 or a position at or past the row's length read as N. A thread
// reads its 32 bytes in two 16-byte loads and gathers each plane's bits
// 8 bytes at a time.
__global__ void pack_planes_kernel(const uint8_t* __restrict__ buf,
                                   const int32_t* __restrict__ lens,
                                   int rows, int L,
                                   uint32_t* __restrict__ planes) {
    const int nw = L / LANES;
    const int total = rows * nw;
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += gridDim.x * blockDim.x) {
        const int row = t / nw, w = t % nw;
        const uint4* src =
            (const uint4*)(buf + (size_t)row * L + (size_t)w * LANES);
        const uint4 a = src[0], b = src[1];
        const uint64_t v[4] = {(uint64_t)a.y << 32 | a.x,
                               (uint64_t)a.w << 32 | a.z,
                               (uint64_t)b.y << 32 | b.x,
                               (uint64_t)b.w << 32 | b.z};
        uint32_t lo = 0, hi = 0, nn = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // bit 7 of a byte set where the byte is >= 4
            const uint64_t big = v[k] & 0xfcfcfcfcfcfcfcfcull;
            const uint64_t n7 =
                ((big & 0x7f7f7f7f7f7f7f7full) + 0x7f7f7f7f7f7f7f7full) | big;
            lo |= gather8(v[k]) << (8 * k);
            hi |= gather8(v[k] >> 1) << (8 * k);
            nn |= gather8(n7 >> 7) << (8 * k);
        }
        const int left = lens[row] - w * LANES;  // symbols of the row here
        nn |= left >= LANES ? 0u : left <= 0 ? FULL : FULL << left;
        uint32_t* o = planes + (size_t)row * 3 * nw + w;
        o[0] = lo & ~nn;
        o[nw] = hi & ~nn;
        o[2 * (size_t)nw] = nn;
    }
}

int pack_planes(const void* buf, const void* lens, int rows, int L,
                void* planes, cudaStream_t st) {
    const long long words = (long long)rows * (L / LANES);
    if ((size_t)buf % 16 || L % LANES || words >= INT_MAX)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long want = (words + threads - 1) / threads;
    const int blocks = (int)(want < 4096 ? want : 4096);
    if (blocks > 0)
        pack_planes_kernel<<<blocks, threads, 0, st>>>(
            (const uint8_t*)buf, (const int32_t*)lens, rows, L,
            (uint32_t*)planes);
    return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const size_t s = __cvta_generic_to_global(src);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(s)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying words [0, nw) of a row's three planes (rows of `stride`
// words, a multiple of 4, 16-byte aligned) into `dst` (the same layout)
// in 16-byte chunks, thread t of nt; the caller waits
// (cp_async_wait_all) and syncs before reading.
__device__ __forceinline__ void planes_to_smem(uint32_t* dst,
                                               const uint32_t* src,
                                               int stride, int nw, int t,
                                               int nt) {
    const int n16 = (nw + 3) >> 2;  // 16-byte chunks a plane
    for (int c = t; c < 3 * n16; c += nt) {
        const int pl = c / n16, k = 4 * (c % n16);
        cp_async16(dst + (size_t)pl * stride + k,
                   src + (size_t)pl * stride + k);
    }
}

}  // namespace
