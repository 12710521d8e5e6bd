// K3 Gotoh affine-gap global alignment on Hopper (sm_90a): forward pass
// (code pairs or count profiles) and traceback, batched.  Plain C interface, loaded with ctypes
// by ops/gotoh_cuda.py; every launcher returns cudaGetLastError().
//
// Decision bytes are laid out by anti-diagonal, dec[b][d][i] = cell
// (i, j = d - i), (M+N+1) x (M+1) bytes per problem: bits 0-1 the H source
// (0 diag, 1 up/F, 2 left/E), bit 2 E opened from H, bit 3 F opened from H.
// Ops: 1 diag, 2 up (consumes A), 3 left (consumes B), end of alignment
// first, 0 after the walk ends.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
// the most warps one problem takes, and so the widest block
constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = 32 * kMaxWarps;
// steps per phase of a multi-warp problem, and the phases strip k+1 starts
// after strip k: its chunk c reads (one step ahead) row 32k+31 up to column
// kChunk * (c + 1), which strip k's lane 31 writes in its chunk
// c + 1 + 31 / kChunk
constexpr int kChunk = 32;
constexpr int kLag = 2 + 31 / kChunk;

// The forward recurrence both input modes share (gotoh_forward_problem)
// replaces the TPU kernel mauvealigner_tpu/ops/dp_pallas.py::_kernel (driven
// by gotoh_forward_pallas), whose arithmetic order and tie rules it keeps:
// E = max(H[i][j-1] + (go+ge), E[i][j-1] + ge), open on >=; F likewise from
// row i-1; H = diag, then F only if strictly greater, then E only if
// strictly greater.  Row 0 scores NEG, column 0 scores 0; the substitution
// score of any other cell comes from the Score provider, per cell, and
// accumulates in f32.
//
// Live cells only.  A problem computes its rectangle 0 <= i <= la,
// 0 <= j <= lb and nothing else: every cell of it reads only cells of it
// and the sentinels around it, and the traceback and the score read
// nothing outside it.  Bytes outside the rectangle stay unwritten.  The
// sentinels are those the whole-bucket sweep computes: with gap scores
// <= 0 (the wrapper checks), every cell left of column 0 holds H = E = NEG
// and F <= NEG, so column 0 reads H[i][-1] = E[i][-1] = H[i-1][-1] = NEG,
// and row 0 reads NEG for H and F of row -1, as the plain version's lane
// shift does.  Hence row 0's F-open bit and column 0's E-open bit are
// f32(NEG + go_ge) >= f32(NEG + ge), the same value the plain version
// writes there (tests/test_torch_dp.py pins it).
//
// A warp-synchronous wavefront in registers.  Rows are cut into strips of
// 32; lane t of strip k owns row i = 32k + t and at step s computes
// column j = s - t, so all 32 cells of a step lie on diagonal 32k + s and
// one warp-wide store writes 32 consecutive decision bytes.  H[i-1][j] and
// F[i-1][j] come from lane t-1 by __shfl_up_sync; the diagonal H[i-1][j-1]
// is what the lane received the step before; H[i][j-1] and E[i][j-1] stay
// in the lane's registers.  Lane 0 of strip k > 0 reads row 32k-1 from the
// bottom-row buffer that strip k-1's lane 31 writes (two full-length H/F
// buffers in shared memory, by strip parity).  Lanes that have not reached
// column 0 hold NEG, which is what the cells left of column 0 hold.
//
// Problems to blocks.  A problem gets W warps (forward_shape: one up to
// side 32, four up to 256, eight at 512, sixteen above; chosen by timing
// the main path's launch lists, scripts/gotoh_replay.py).  Its strips go
// round-robin to the warps, in phases of kChunk steps: strip k takes its
// step chunk c in phase start(k) + c, start(rW + w) = r * max(kLag W,
// chunks) + kLag w for warp w in round r, so a warp starts its next strip
// once it is done with the last and strip k+1 runs kLag phases behind the
// strip it reads.  Strip k+2 overwrites the buffer strip k+1 reads only
// kLag phases after strip k+1 read the same column.  With W > 1 a block
// holds one problem and each phase ends in __syncthreads; with W = 1 a
// block holds several problems and a warp ends its phases with
// __syncwarp.  Warps idle in a phase only wait at the barrier; other
// blocks on the SM use the issue slots.  (Per-strip progress flags in
// place of the barrier, and 16-step phases, both timed slower.)
//
// Inputs are staged once, their loads issued together: the lengths, the B
// side (N code bytes, or N x 5 floats of pB, normalized when asked) into
// shared memory with kPad columns of padding either side, and the first
// strip's A-side rows; each later strip's A rows are loaded one strip
// ahead.  The lane's A-side datum (its code's row of the 6 x 6 table, or
// q_i = pA[i-1] . SUBST) lives in registers.
//
// Bound on this card: per live cell one decision byte written (0.30 ps at
// 3.35 TB/s) and about 12 f32 operations for codes, 21 for profiles
// (0.18 / 0.31 ps at 67 TFLOP/s), so bytes bound both.  The kernel is far
// from it: a step of 32 cells issues about 60 warp instructions (two
// shuffles, the recurrence, the edge selects, one byte store, lane 31's
// two buffer stores, and the next step's loads), so the SMs' issue rate
// sets the time when enough warps are resident, and within one problem the
// chain of dependent steps does (2 kChunk steps of lag per strip).  The
// byte stores alone take about a third of the time at side 4096 (PERF.md);
// the layout of dec, fixed by its callers, allows no wider store.
struct Lane {
    float hl, el;     // H and E of the lane's row, previous column
    float h_out, f_out;  // H and F of the cell computed last step
    float hup_prev;   // the H received from the row above last step
};

// Columns staged before column 1 and after column N, so that a lane reads
// its B-side datum with no clamp: j - 1 runs over -kPad .. lb + kPad - 1.
// Padding scores 0 (code 5, or a zero profile row), which is the plain
// version's score left of column 1; right of column lb nothing is live.
constexpr int kPad = 32;

// Steps s0 .. s1-1 of strip k.  Lane 0 of strip 0 is row 0 and reads NEG
// from row -1; lane 0 of a later strip reads row 32k-1 from the bottom-row
// buffer `top` (F at top + fstride).  Straight-line code: every load of a
// step is made one step ahead through pointers that advance by one column
// (the cell score, the row above), stores are predicated, and the cell's H
// is a max of maxes, so the chain from one step's shuffle to the next is
// one add and three max operations.  One copy of the loop serves every
// strip and chunk: a second copy without the edge selects for interior
// chunks timed faster at side 4096 but slower on the main path's sides.
template <class Score>
__device__ __forceinline__ void strip_steps(
    const Score& score, const typename Score::Row& row, Lane& st, int k, int s0, int s1,
    int la, int lb, float go_ge, float ge, const float* top, float* bot, int fstride,
    uint8_t* __restrict__ db, int Wd, float* __restrict__ score_out)
{
    const int t = threadIdx.x & 31;
    const int i = 32 * k + t;
    const bool row0 = (i == 0);
    const bool from_buffer = (k > 0);
    const bool live_row = (i <= la);
    uint8_t* p = db + ((size_t)(32 * k + s0) * Wd + i);
    typename Score::Col col = score.col(s0 - t);
    float sc_next = score(row, col);
    const float* tp = top + s0;         // lane 0's column, one ahead
    float* bp = bot + (s0 - 31);        // lane 31's column
    float th = tp[0], tf = tp[fstride];
#pragma unroll 4
    for (int s = s0; s < s1; ++s, p += Wd, ++tp, ++bp) {
        const int j = s - t;
        float h_up = __shfl_up_sync(kFullMask, st.h_out, 1);
        float f_up = __shfl_up_sync(kFullMask, st.f_out, 1);
        if (t == 0) {
            h_up = from_buffer ? th : kNeg;
            f_up = from_buffer ? tf : kNeg;
        }
        const float sc = sc_next;
        Score::advance(col);
        sc_next = score(row, col);
        th = tp[1];
        tf = tp[1 + fstride];
        const float diag = st.hup_prev;
        st.hup_prev = h_up;
        const float e_from_h = st.hl + go_ge;
        const float e_from_e = st.el + ge;
        const bool e_open = e_from_h >= e_from_e;
        const float ev = (j >= 1) ? fmaxf(e_from_h, e_from_e) : kNeg;
        const float f_from_h = h_up + go_ge;
        const float f_from_f = f_up + ge;
        const bool f_open = f_from_h >= f_from_f;
        const float fv = row0 ? kNeg : fmaxf(f_from_h, f_from_f);
        // row 0 scores NEG and its diagonal is NEG: the select comes after
        // the add, so the score's loads stay unconditional (a select before
        // it compiled to a branch around them)
        const float hd = row0 ? kNeg + kNeg : diag + sc;
        // the plain version's "F only if strictly greater, then E only if
        // strictly greater": the value is the max (no NaN, no -0 arises)
        const float m1 = fmaxf(hd, fv);
        const float best = fmaxf(m1, ev);
        const int choice = (ev > m1) ? 2 : ((fv > hd) ? 1 : 0);
        const bool live = live_row && (unsigned)j <= (unsigned)lb;
        if (live) *p = (uint8_t)(choice | (e_open ? 4 : 0) | (f_open ? 8 : 0));
        if (live && t == 31) {
            bp[0] = best;
            bp[fstride] = fv;
        }
        st.hl = best;
        st.el = ev;
        st.h_out = best;
        st.f_out = fv;
    }
    // the lane of row la computes column lb in its strip's last step
    if (i == la && s1 - 1 - t == lb && s1 > s0) *score_out = st.hl;
}

// Lane state at the start of strip k: the cells left of column 0 (and the
// origin for row 0, whose step 0 is not computed: H = 0, E = F = NEG).
__device__ __forceinline__ Lane strip_start(int k) {
    const bool origin = (k == 0) && ((threadIdx.x & 31) == 0);
    Lane st;
    st.hl = origin ? 0.0f : kNeg;
    st.el = kNeg;
    st.h_out = st.hl;
    st.f_out = kNeg;
    st.hup_prev = kNeg;
    return st;
}

// Floats of one bottom-row buffer: columns 0 .. N, plus the columns lane 0
// reads ahead past lb (unused values).
__host__ __device__ __forceinline__ int buffer_len(int N) { return N + 1 + 32; }

// One problem: `warps` warps (w this one's index) over the rectangle
// (la + 1) x (lb + 1).  buf: four bottom-row buffers of buffer_len(N)
// floats, H by strip parity, then F by strip parity.
// raw: this warp's first strip's A-side rows, loaded before the staging
// barrier; each later strip's are loaded one strip ahead.
template <class Score>
__device__ __forceinline__ void gotoh_forward_problem(
    const Score& score, typename Score::Raw raw, int la, int lb, int M, int warps, int w,
    float go_ge, float ge, float* buf, int N, uint8_t* __restrict__ db, int Wd,
    float* __restrict__ score_out)
{
    const int t = threadIdx.x & 31;
    const int rows = la + 1;
    const int nstrips = (rows + 31) >> 5;
    const int nchunks = (lb + 32 + kChunk - 1) / kChunk;  // steps 0 .. lb + 31
    const int len = buffer_len(N);
    const int fstride = 2 * len;
    if (w == 0 && t == 0) {
        db[0] = 0;
        if (la + lb == 0) *score_out = 0.0f;
    }
    const int period = max(kLag * warps, nchunks);
    const int last = nstrips - 1;
    const int phases = (last / warps) * period + kLag * (last % warps) + nchunks;
    Lane st = strip_start(0);
    typename Score::Row row{};
    for (int ph = 0; ph < phases; ++ph) {
        const int q = ph - kLag * w;
        if (q >= 0) {
            const int r = q / period;
            const int c = q - r * period;
            const int k = r * warps + w;
            if (c < nchunks && k < nstrips) {
                if (c == 0) {
                    st = strip_start(k);
                    row = score.row(raw);
                    raw = score.raw(32 * (k + warps) + t, M);
                }
                const int par = k & 1;
                const int s0 = max(kChunk * c, k == 0 ? 1 : 0);
                const int s1 = min(kChunk * (c + 1), lb + min(32, rows - 32 * k));
                strip_steps(score, row, st, k, s0, s1, la, lb, go_ge, ge, buf + (par ^ 1) * len,
                            buf + par * len, fstride, db, Wd, score_out);
            }
        }
        // one warp per problem: strips in turn, no block barrier
        if (warps == 1) __syncwarp(); else __syncthreads();
    }
}

// Code pairs: the score is a lookup in the 6 x 6 substitution table (codes
// > 4 are padding and score 0).  The lane keeps the table row of its A
// code; a column is a pointer into the staged B codes (min(code, 5)).
// Rows past la and columns past lb read the caller's padding: those cells
// are not live.
struct CodeScore {
    using Raw = int;
    using Row = const float*;
    using Col = const uint8_t*;
    const uint8_t* ca;   // device memory, this problem's A codes
    const uint8_t* cb;   // shared memory, B codes of columns 1 - kPad .. N + kPad
    const float* sub6;   // shared memory, [6, 6]
    __device__ __forceinline__ Raw raw(int i, int M) const {
        return (i >= 1 && i <= M) ? min((int)ca[i - 1], 5) : 5;
    }
    __device__ __forceinline__ Row row(Raw a) const { return sub6 + 6 * a; }
    __device__ __forceinline__ Col col(int j) const { return cb + kPad + j - 1; }
    __device__ __forceinline__ static void advance(Col& c) { ++c; }
    __device__ __forceinline__ float operator()(Row r, Col c) const { return r[*c]; }
};

// One profile row into p[5], divided by max(row total, 1) when normalize
// is set (the total summed left to right): ops/dp.py::normalize_profiles.
__device__ __forceinline__ void load_profile_row(
    const float* __restrict__ src, bool normalize, float* p)
{
#pragma unroll
    for (int l = 0; l < 5; ++l) p[l] = src[l];
    if (normalize) {
        float total = p[0];
#pragma unroll
        for (int l = 1; l < 5; ++l) total = __fadd_rn(total, p[l]);
        const float den = fmaxf(total, 1.0f);
#pragma unroll
        for (int l = 0; l < 5; ++l) p[l] = __fdiv_rn(p[l], den);
    }
}

// Profiles: the lane's row score q_i = pA[i-1] . SUBST (5 floats) sits in
// registers; a cell reads pB[j-1] from shared memory and takes
// s = sum_l q_i[l] * pB[j-1][l] over l = 0..4 in order.  Every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn: no fused multiply-add),
// the order ops/dp.py::gotoh_forward_profiles_ref uses, so kernel and plain
// version agree to the bit; on integer counts with an integer matrix every
// partial sum is an integer below 2^24 and the result equals the JAX
// package's in any order.  pB's stride of 5 floats puts the 32 lanes'
// loads of one l on 32 distinct banks (a float4 + float layout timed
// slower).  Padding columns score +-0, and diag + (+-0) = diag for the NEG
// diagonals left of column 1.
struct ProfileScore {
    struct Raw { float p[5]; };
    struct Row { float q[5]; };
    using Col = const float*;
    const float* pa;     // device memory, this problem's [M, 5]
    const float* pb;     // shared memory, pB rows of columns 1 - kPad .. N + kPad
    const float* subst;  // device memory, [5, 5]
    bool normalize;
    __device__ __forceinline__ Raw raw(int i, int M) const {
        Raw a;
#pragma unroll
        for (int l = 0; l < 5; ++l) a.p[l] = 0.0f;
        if (i >= 1 && i <= M) {
#pragma unroll
            for (int l = 0; l < 5; ++l) a.p[l] = pa[(size_t)(i - 1) * 5 + l];
        }
        return a;
    }
    __device__ __forceinline__ Row row(const Raw& a) const {
        float p[5];
        load_profile_row(a.p, normalize, p);
        Row r;
#pragma unroll
        for (int l = 0; l < 5; ++l) {
            float q = __fmul_rn(p[0], subst[l]);
#pragma unroll
            for (int m = 1; m < 5; ++m) q = __fadd_rn(q, __fmul_rn(p[m], subst[m * 5 + l]));
            r.q[l] = q;
        }
        return r;
    }
    __device__ __forceinline__ Col col(int j) const { return pb + 5 * (kPad + j - 1); }
    __device__ __forceinline__ static void advance(Col& c) { c += 5; }
    __device__ __forceinline__ float operator()(const Row& r, Col x) const {
        float s = __fmul_rn(r.q[0], x[0]);
#pragma unroll
        for (int l = 1; l < 5; ++l) s = __fadd_rn(s, __fmul_rn(r.q[l], x[l]));
        return s;
    }
};

// Which problem this warp works on and its index inside it: with one warp
// per problem a block holds blockDim.x / 32 problems, else one.
struct Placement {
    int b, w, slot, warps, tid;  // tid: the thread's index inside its problem
};

__device__ __forceinline__ Placement place(int warps) {
    const int warp = threadIdx.x >> 5;
    if (warps == 1) {
        const int per_block = blockDim.x >> 5;
        return {(int)blockIdx.x * per_block + warp, 0, warp, 1, (int)threadIdx.x & 31};
    }
    return {(int)blockIdx.x, warp, 0, warps, (int)threadIdx.x};
}

__host__ __device__ __forceinline__ size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

// Shared memory of one problem: the four bottom-row buffers, then the staged
// B side of N + 2 kPad columns (code bytes, or 5 floats each), a multiple of
// 16 bytes.
__host__ __device__ __forceinline__ size_t problem_bytes(int N, size_t column_bytes) {
    return round16(4 * sizeof(float) * (size_t)buffer_len(N) + column_bytes * (N + 2 * kPad));
}

// Both forward kernels: at most kMaxThreads threads, and one block per SM
// is enough, so ptxas may give a thread up to 128 registers (bounded by
// the block size alone it held the profile kernel to 64, which timed
// slower); -Xptxas -v shows no spills.
__global__ void __launch_bounds__(kMaxThreads, 1) gotoh_forward_codes_kernel(
    const uint8_t* __restrict__ codes_a,  // [B, M], codes > 4 are padding
    const uint8_t* __restrict__ codes_b,  // [B, N]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int B, int M, int N, int warps,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec)            // [B, M+N+1, M+1]
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float sub6[36];
    for (int k = threadIdx.x; k < 36; k += blockDim.x) {
        const int r = k / 6, c = k % 6;
        sub6[k] = (r < 5 && c < 5) ? subst[r * 5 + c] : 0.0f;
    }
    const Placement pl = place(warps);
    const bool active = pl.b < B;
    float* buf = reinterpret_cast<float*>(smem + pl.slot * problem_bytes(N, 1));
    uint8_t* cb = reinterpret_cast<uint8_t*>(buf + 4 * buffer_len(N));
    // lengths, staged columns and first rows load together (no load waits
    // on another)
    const int la = active ? lens_a[pl.b] : 0;
    const int lb = active ? lens_b[pl.b] : 0;
    const CodeScore score{codes_a + (size_t)(active ? pl.b : 0) * M, cb, sub6};
    const CodeScore::Raw raw = score.raw(32 * pl.w + (threadIdx.x & 31), active ? M : 0);
    if (active) {
        const uint8_t* src = codes_b + (size_t)pl.b * N;
        for (int x = pl.tid; x < N; x += 32 * pl.warps) cb[kPad + x] = (uint8_t)min((int)src[x], 5);
        for (int x = pl.tid; x < 2 * kPad; x += 32 * pl.warps) cb[x < kPad ? x : N + x] = 5;
    }
    __syncthreads();  // sub6, and cb of every problem of the block
    if (!active) return;
    gotoh_forward_problem(score, raw, la, lb, M, pl.warps, pl.w, go_ge, ge, buf, N,
                          dec + (size_t)pl.b * (size_t)(M + N + 1) * (M + 1), M + 1,
                          scores + pl.b);
}

// gotoh_forward_profiles_kernel: the profile input of the same TPU kernel
// (the JAX package's count-profile DP, dp.align_profiles_batch_async).
// Shared memory per problem: the bottom-row buffers plus pB staged once
// (normalized when asked), 16 x (N+33) + 20 x (N+64) bytes: 149,264 at
// N = 4096.
__global__ void __launch_bounds__(kMaxThreads, 1) gotoh_forward_profiles_kernel(
    const float* __restrict__ prof_a,     // [B, M, 5], zero rows past lens_a
    const float* __restrict__ prof_b,     // [B, N, 5]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int B, int M, int N, int normalize, int warps,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec)            // [B, M+N+1, M+1]
{
    extern __shared__ __align__(16) unsigned char smem[];
    const Placement pl = place(warps);
    const bool active = pl.b < B;
    float* buf = reinterpret_cast<float*>(smem + pl.slot * problem_bytes(N, 5 * sizeof(float)));
    float* pb = buf + 4 * buffer_len(N);
    // lengths, staged columns and first rows load together (no load waits
    // on another)
    const int la = active ? lens_a[pl.b] : 0;
    const int lb = active ? lens_b[pl.b] : 0;
    const ProfileScore score{prof_a + (size_t)(active ? pl.b : 0) * M * 5, pb, subst,
                             normalize != 0};
    const ProfileScore::Raw raw = score.raw(32 * pl.w + (threadIdx.x & 31), active ? M : 0);
    if (active) {
        const float* src = prof_b + (size_t)pl.b * N * 5;
        for (int x = pl.tid; x < N; x += 32 * pl.warps) {
            float p[5];
            load_profile_row(src + (size_t)x * 5, normalize != 0, p);
#pragma unroll
            for (int l = 0; l < 5; ++l) pb[(kPad + x) * 5 + l] = p[l];
        }
        for (int x = pl.tid; x < 2 * kPad; x += 32 * pl.warps) {
#pragma unroll
            for (int l = 0; l < 5; ++l) pb[(x < kPad ? x : N + x) * 5 + l] = 0.0f;
        }
    }
    __syncthreads();
    if (!active) return;
    gotoh_forward_problem(score, raw, la, lb, M, pl.warps, pl.w, go_ge, ge, buf, N,
                          dec + (size_t)pl.b * (size_t)(M + N + 1) * (M + 1), M + 1,
                          scores + pl.b);
}

// gotoh_traceback_kernel replaces the XLA traceback
// mauvealigner_tpu/ops/dp.py::gotoh_traceback (a fixed-trip lax.scan, a
// TPU miscompile workaround).  One thread per problem walks from (mA, mB)
// to (0, 0) with the H/F/E mode state and writes ops end first; it reads
// only cells of the live rectangle.
//
// Bound on this card: one dependent byte load from the decision array per
// step, up to M+N steps; loads of neighbouring threads hit unrelated
// problems.  Later work: fuse it into the forward kernel's CTA with the
// decisions still in shared memory.
__global__ void gotoh_traceback_kernel(
    const uint8_t* __restrict__ dec,     // [B, M+N+1, M+1]
    const int32_t* __restrict__ lens_a,  // [B]
    const int32_t* __restrict__ lens_b,  // [B]
    int B, int M, int N,
    uint8_t* __restrict__ ops,           // [B, M+N]
    int32_t* __restrict__ counts)        // [B]
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int W = M + 1;
    const int L = M + N;
    const long long n_cells = (long long)(M + N + 1) * W;
    const uint8_t* db = dec + (size_t)b * (size_t)n_cells;
    uint8_t* ob = ops + (size_t)b * L;
    int i = lens_a[b], j = lens_b[b], mode = 0, t = 0;
    while ((i > 0 || j > 0) && t < L) {
        long long idx = (long long)(i + j) * W + i;
        idx = idx < 0 ? 0 : (idx >= n_cells ? n_cells - 1 : idx);
        const int byte = db[idx];
        int c = mode;
        if (c == 0) c = (i == 0) ? 2 : ((j == 0) ? 1 : (byte & 3));
        ob[t++] = (uint8_t)(c + 1);
        if (c == 0) {
            --i; --j;
            mode = 0;
        } else if (c == 1) {
            --i;
            mode = ((byte >> 3) & 1) ? 0 : 1;
        } else {
            --j;
            mode = ((byte >> 2) & 1) ? 0 : 2;
        }
    }
    counts[b] = t;
    for (; t < L; ++t) ob[t] = 0;
}

// Block shape of a forward launch: warps per problem (the caller's, or by
// side: 1 up to 32, 4 up to 256, 8 at 512, 16 above) and, with one warp
// per problem, problems per block, as many as shared memory allows up to
// 4.
struct Shape {
    int warps, per_block, threads, blocks;
    size_t smem;
};

Shape forward_shape(int B, int M, size_t per_problem, int warps) {
    if (warps <= 0) warps = (M <= 32) ? 1 : (M <= 256 ? 4 : (M <= 512 ? 8 : kMaxWarps));
    if (warps > kMaxWarps) warps = kMaxWarps;
    Shape s;
    s.warps = warps;
    s.per_block = 1;
    if (warps == 1) {
        const size_t cap = 200 * 1024;
        s.per_block = 4;
        while (s.per_block > 1 && s.per_block * per_problem > cap) --s.per_block;
    }
    s.threads = 32 * (warps == 1 ? s.per_block : warps);
    s.blocks = (B + s.per_block - 1) / s.per_block;
    s.smem = s.per_block * per_problem;
    return s;
}

}  // namespace

extern "C" {

int gotoh_forward_codes_launch(
    const void* codes_a, const void* codes_b, const void* lens_a, const void* lens_b,
    const void* subst, float go_ge, float ge, int B, int M, int N, int warps,
    void* scores, void* dec, void* stream)
{
    const Shape s = forward_shape(B, M, problem_bytes(N, 1), warps);
    cudaError_t err = cudaFuncSetAttribute(
        gotoh_forward_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err != cudaSuccess) return (int)err;
    gotoh_forward_codes_kernel<<<s.blocks, s.threads, s.smem, (cudaStream_t)stream>>>(
        (const uint8_t*)codes_a, (const uint8_t*)codes_b, (const int32_t*)lens_a,
        (const int32_t*)lens_b, (const float*)subst, go_ge, ge, B, M, N, s.warps,
        (float*)scores, (uint8_t*)dec);
    return (int)cudaGetLastError();
}

int gotoh_forward_profiles_launch(
    const void* prof_a, const void* prof_b, const void* lens_a, const void* lens_b,
    const void* subst, float go_ge, float ge, int B, int M, int N, int normalize, int warps,
    void* scores, void* dec, void* stream)
{
    const Shape s = forward_shape(B, M, problem_bytes(N, 5 * sizeof(float)), warps);
    cudaError_t err = cudaFuncSetAttribute(
        gotoh_forward_profiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err != cudaSuccess) return (int)err;
    gotoh_forward_profiles_kernel<<<s.blocks, s.threads, s.smem, (cudaStream_t)stream>>>(
        (const float*)prof_a, (const float*)prof_b, (const int32_t*)lens_a,
        (const int32_t*)lens_b, (const float*)subst, go_ge, ge, B, M, N, normalize, s.warps,
        (float*)scores, (uint8_t*)dec);
    return (int)cudaGetLastError();
}

int gotoh_traceback_launch(
    const void* dec, const void* lens_a, const void* lens_b, int B, int M, int N,
    void* ops, void* counts, void* stream)
{
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    gotoh_traceback_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)dec, (const int32_t*)lens_a, (const int32_t*)lens_b, B, M, N,
        (uint8_t*)ops, (int32_t*)counts);
    return (int)cudaGetLastError();
}

const char* gotoh_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
