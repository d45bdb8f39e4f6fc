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
// kernels run, and the cp.async copy of a row's planes into shared
// memory.
// ============================================================================
#pragma once

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

// Bit planes of a (rows, L) symbol buffer, one warp per 32-symbol word:
// (rows, 3, L / 32) words, a code >= 4 or a position at or past the row's
// length read as N.
__global__ void pack_planes_kernel(const uint8_t* __restrict__ buf,
                                   const int32_t* __restrict__ lens,
                                   int rows, int L,
                                   uint32_t* __restrict__ planes) {
    const int lane = threadIdx.x % LANES;
    const int nw = L / LANES;
    const long long total = (long long)rows * nw;
    const long long step = (long long)gridDim.x * blockDim.x / LANES;
    for (long long t = (blockIdx.x * (long long)blockDim.x + threadIdx.x)
                       / LANES;
         t < total; t += step) {
        const int row = (int)(t / nw), w = (int)(t % nw);
        const int p = w * LANES + lane;
        const int s = buf[(size_t)row * L + p];
        const bool n = p >= lens[row] || s >= SYM_N_REF;
        const unsigned lo = __ballot_sync(FULL, !n && (s & 1));
        const unsigned hi = __ballot_sync(FULL, !n && (s & 2));
        const unsigned nn = __ballot_sync(FULL, n);
        uint32_t* o = planes + (size_t)row * 3 * nw + w;
        if (lane == 0) o[0] = lo;
        if (lane == 1) o[nw] = hi;
        if (lane == 2) o[2 * (size_t)nw] = nn;
    }
}

int pack_planes(const void* buf, const void* lens, int rows, int L,
                void* planes, cudaStream_t st) {
    const long long words = (long long)rows * (L / LANES);
    const int threads = 256;
    const long long want = (words * LANES + threads - 1) / threads;
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
