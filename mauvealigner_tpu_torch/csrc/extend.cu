// K2 maximal extension on Hopper (sm_90a): every candidate anchor of the
// multi-MUM search grown base by base to maximality.  Plain C interface,
// loaded with ctypes by ops/extend_cuda.py; the launcher returns
// cudaGetLastError().
//
// It replaces no TPU kernel.  The JAX package extends its anchors on the
// host (mauvealigner_tpu/ops/matchops.py::extend_matches_maximal), and so
// did the port: the loop native/mauve_native.cpp::extend_matches, one row
// and one base at a time on one host thread, which this kernel replaces on
// the device path of ops/matchops.py::find_multi_mums_device.
//
// What it computes is exactly that loop's result.  A row holds a length and
// one signed 1-based start per genome (0 = absent); match-space column c of
// a present component is genome base left0 + c (forward) or the complement
// of base left0 + len - 1 - c (reverse), left0 = |start| - 1.  The match
// grows to the right in match space while every present component reads the
// same base below 4 in the next column, then to the left likewise; a code
// >= 4 or a sequence end stops it.  A right step leaves a forward start
// where it is and moves a reverse one (start + 1); a left step moves a
// forward start (start - 1) and leaves a reverse one.  So the two walks
// read disjoint columns that neither walk moves, and run independently:
// right walk k reads base left0 + len + k (forward) or left0 - 1 - k
// (reverse); left walk k reads left0 - 1 - k (forward) or left0 + len + k
// (reverse).  A row whose first column either way lies outside a genome
// does not move that way, as the loop's bounds check has it.
//
// Layout: genome j's bases lie at codes[offset_j + i], 0 <= i < length_j
// (layout = [n_seqs][2] int64 {offset, length}); at least 32 bytes of a
// code >= 4 lie before and after every genome (ops/extend_cuda.PAD), so
// a walk stops at a sequence end by reading such a code, and every word a
// walk reads stays inside the buffer.
//
// Bound: bytes.  Each genome is read from HBM once, and the rows are read
// and written once: at 3 x 4.6 Mbp, about 1.5 M rows, 13.8 MB of genomes
// and 98 MB of rows, 0.033 ms at 3.35 TB/s.  The walks read bases many
// times over (about 150 M steps of 2-3 components there, as the spaced seed
// cuts one maximal match into several candidate rows that walk the same
// bases), but the genomes fit the 50 MB L2, so those reads are not HBM
// traffic.  No arithmetic to speak of.
//
// Design.  One thread walks one row one way: thread 2r takes row r's right
// walk, thread 2r + 1 its left walk, so the two walks of a row run side by
// side in one warp and meet in a shuffle that hands each the other's count;
// the even thread then writes the length and the reverse starts, the odd
// one the forward starts.  A walk reads 16 bases of each component a step:
// five aligned 32-bit loads (a funnel shift puts the window in place, a
// byte permute reverses a walk that runs down the genome, an XOR with 3
// complements a reverse component), and compares the 16 bytes four at a
// time with the SIMD byte compares.  Walk lengths within a warp are uneven
// (10 to a few hundred bases, from the way the spaced seed cuts a maximal
// match into several candidates); a warp takes as many steps as its
// longest walk needs, and 16 bases a step cuts those to a few dozen at
// most, while the 2 x rows threads (several waves of the card's 270 K
// resident threads at the cells' row counts) keep enough loads in flight
// to hide the latency of the dependent reads.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kBelow4 = 0x04040404u;
constexpr unsigned kComplement = 0x03030303u;

// The 16 match-space bases at genome positions p, p + 1, .. (up) or p,
// p - 1, .. (down) of the genome at codes + base, complemented if comp, as
// four words, match-space base 4i + b in byte b of m[i].  Reads the five
// aligned words that hold the window.
__device__ __forceinline__ void load16(const uint8_t* __restrict__ codes, long long base,
                                       long long p, bool up, bool comp, unsigned m[4]) {
    const long long first = base + (up ? p : p - 15);
    const unsigned* w = reinterpret_cast<const unsigned*>(codes + (first & ~3LL));
    unsigned x[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) x[k] = __ldg(w + k);
    const unsigned shift = 8u * (unsigned)(first & 3);
    unsigned y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = __funnelshift_r(x[k], x[k + 1], shift);
    const unsigned flip = comp ? kComplement : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = (up ? y[i] : __byte_perm(y[3 - i], 0, 0x0123)) ^ flip;
}

// Genome position of the walk's first column for a present component, and
// whether the walk runs up the genome.
__device__ __forceinline__ long long first_column(long long s, long long len, bool right,
                                                  bool* up) {
    const bool fwd = s > 0;
    const long long left0 = (fwd ? s : -s) - 1;
    *up = right == fwd;
    return *up ? left0 + len : left0 - 1;
}

__global__ void __launch_bounds__(kThreads) extend_matches_kernel(
    const uint8_t* __restrict__ codes, const long long* __restrict__ layout,
    const long long* __restrict__ starts, const long long* __restrict__ lengths,
    long long n_rows, int n_seqs, long long* __restrict__ out_starts,
    long long* __restrict__ out_lengths) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long row = t >> 1;
    const bool right = (t & 1) == 0;
    const bool live = row < n_rows;
    const long long* srow = starts + (live ? row : 0) * n_seqs;
    const long long len = live ? lengths[row] : 0;
    long long ext = 0;
    bool walk = false;
    if (live) {
        bool inside = true;
        for (int j = 0; j < n_seqs; ++j) {
            const long long s = srow[j];
            if (s == 0) continue;
            bool up;
            const long long g = first_column(s, len, right, &up);
            walk = true;
            inside = inside && g >= 0 && g < layout[2 * j + 1];
        }
        walk = walk && inside;
    }
    while (walk) {
        unsigned ref[4], ok[4];
        bool first = true;
        for (int j = 0; j < n_seqs; ++j) {
            const long long s = srow[j];
            if (s == 0) continue;
            bool up;
            const long long g = first_column(s, len, right, &up);
            unsigned m[4];
            load16(codes, layout[2 * j], up ? g + ext : g - ext, up, s < 0, m);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (first) {
                    ref[i] = m[i];
                    ok[i] = __vcmpltu4(m[i], kBelow4);
                } else {
                    ok[i] &= __vcmpeq4(m[i], ref[i]);
                }
            }
            first = false;
        }
        int grown = 0;
        bool stopped = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (!stopped) {
                if (ok[i] == kFullMask) {
                    grown += 4;
                } else {
                    grown += (__ffs((int)~ok[i]) - 1) >> 3;
                    stopped = true;
                }
            }
        }
        ext += grown;
        walk = !stopped;
    }
    const long long other = __shfl_xor_sync(kFullMask, ext, 1);
    if (!live) return;
    const long long r_ext = right ? ext : other;
    const long long l_ext = right ? other : ext;
    long long* orow = out_starts + row * n_seqs;
    if (right) out_lengths[row] = len + r_ext + l_ext;
    for (int j = 0; j < n_seqs; ++j) {
        const long long s = srow[j];
        if (right && s <= 0) orow[j] = s < 0 ? s + r_ext : 0;
        if (!right && s > 0) orow[j] = s - l_ext;
    }
}

}  // namespace

extern "C" {

// codes: the padded genome buffer (uint8); layout: [n_seqs][2] int64
// {offset, length}; starts [n_rows][n_seqs] and lengths [n_rows] int64;
// out_starts and out_lengths likewise, written whole.  Device pointers, all
// on the current device; stream: a cudaStream_t.
int extend_matches_launch(const void* codes, const void* layout, const void* starts,
                          const void* lengths, long long n_rows, int n_seqs, void* out_starts,
                          void* out_lengths, void* stream) {
    if (n_rows <= 0) return 0;
    const long long blocks = (2 * n_rows + kThreads - 1) / kThreads;
    if (n_seqs <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    extend_matches_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const long long*)layout, (const long long*)starts,
        (const long long*)lengths, n_rows, n_seqs, (long long*)out_starts,
        (long long*)out_lengths);
    return (int)cudaGetLastError();
}

}  // extern "C"
