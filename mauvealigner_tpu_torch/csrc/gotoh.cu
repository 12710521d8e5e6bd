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
// the problem's buffer with kPad columns of padding either side, and the first
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
//
// Sides above shared memory.  A problem's four bottom-row buffers and its
// staged B side (problem_bytes) live in the block's shared memory when they
// fit the opt-in limit (the codes kernel up to side 8192, the profile kernel
// up to 4096), else in a slab of device memory the caller allocates, one
// problem_bytes row per problem (forward_scratch).  The body is the same:
// only where buf and the staged columns point changes (a template flag,
// kSlab).  The strip lag holds on either: every phase ends in
// __syncthreads (several warps) or __syncwarp (one warp), which order
// global as well as shared writes among the threads that meet there, so
// strip k+1 reads row 32k+31 only after strip k wrote it, and strip k+2
// overwrites it only after strip k+1 read it.  The slab's rows are read and
// written through L1 and L2 like any global data; this path is for the rare
// sides above the limit and is not tuned.
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

// The buffer of one problem: the four bottom-row buffers, then the staged
// B side of N + 2 kPad columns (code bytes, or 5 floats each), a multiple of
// 16 bytes.
__host__ __device__ __forceinline__ size_t problem_bytes(int N, size_t column_bytes) {
    return round16(4 * sizeof(float) * (size_t)buffer_len(N) + column_bytes * ((size_t)N + 2 * kPad));
}

// Where problem b's buffer lies: its row of the device slab (kSlab), else
// slot `slot` of the block's shared memory.  A compile-time choice, so that
// the shared-memory instance addresses buf as shared memory (a pointer that
// may point to either space compiles to generic loads and stores, which
// timed slower).
template <bool kSlab>
__device__ __forceinline__ unsigned char* problem_buffer(
    unsigned char* smem, unsigned char* scratch, int b, int slot, size_t bytes)
{
    if constexpr (kSlab) return scratch + (size_t)b * bytes;
    else return smem + (size_t)slot * bytes;
}

// Both forward kernels: at most kMaxThreads threads, and one block per SM
// is enough, so ptxas may give a thread up to 128 registers (bounded by
// the block size alone it held the profile kernel to 64, which timed
// slower); -Xptxas -v shows no spills.  kSlab: the problem buffers lie in
// `scratch` (device memory) instead of shared memory.
template <bool kSlab>
__global__ void __launch_bounds__(kMaxThreads, 1) gotoh_forward_codes_kernel(
    const uint8_t* __restrict__ codes_a,  // [B, M], codes > 4 are padding
    const uint8_t* __restrict__ codes_b,  // [B, N]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int B, int M, int N, int warps,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec,            // [B, M+N+1, M+1]
    unsigned char* scratch)               // kSlab: [B, problem_bytes]
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float sub6[36];
    for (int k = threadIdx.x; k < 36; k += blockDim.x) {
        const int r = k / 6, c = k % 6;
        sub6[k] = (r < 5 && c < 5) ? subst[r * 5 + c] : 0.0f;
    }
    const Placement pl = place(warps);
    const bool active = pl.b < B;
    float* buf = reinterpret_cast<float*>(
        problem_buffer<kSlab>(smem, scratch, active ? pl.b : 0, pl.slot, problem_bytes(N, 1)));
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
// Buffer per problem: the bottom-row buffers plus pB staged once
// (normalized when asked), 16 x (N+33) + 20 x (N+64) bytes: 149,264 at
// N = 4096 (shared memory), 296,720 at 8192 (the device slab).
template <bool kSlab>
__global__ void __launch_bounds__(kMaxThreads, 1) gotoh_forward_profiles_kernel(
    const float* __restrict__ prof_a,     // [B, M, 5], zero rows past lens_a
    const float* __restrict__ prof_b,     // [B, N, 5]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int B, int M, int N, int normalize, int warps,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec,            // [B, M+N+1, M+1]
    unsigned char* scratch)               // kSlab: [B, problem_bytes]
{
    extern __shared__ __align__(16) unsigned char smem[];
    const Placement pl = place(warps);
    const bool active = pl.b < B;
    float* buf = reinterpret_cast<float*>(problem_buffer<kSlab>(
        smem, scratch, active ? pl.b : 0, pl.slot, problem_bytes(N, 5 * sizeof(float))));
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
        // four rows' loads in flight a thread: left to itself, nvcc unrolled
        // this loop twice in the template and four times before it, and the
        // many small problems of the main path timed 4% slower
#pragma unroll 4
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
// TPU miscompile workaround) and serves both forward kernels.  A problem
// walks from (la, lb) towards (0, 0) with the H/F/E mode state, for at most
// L = M+N steps, reading the byte of cell (i, j) at (i+j)(M+1) + i clamped
// to its slab, as the plain version does (so a walk that garbage bytes
// lead out of the rectangle reads what the plain version reads).  It writes
// ops end first, OP_NONE (0) after the walk, and the step count.
//
// Bound on this card: one dependent byte a step.  The bytes (each step's
// byte read once, the ops and counts written:
// scripts/gotoh_replay.py::traceback_bound) take microseconds; the floor
// is the chain of dependent steps, the longest walk of a launch times the
// latency of one step (scripts/gotoh_replay.py::traceback_chain_floor: 50
// cycles assumed, a shared-memory load and a few integer operations, at
// the maximum SM clock that nvidia-smi reads, 1980 MHz on an H100 SXM).
// The design makes a step one shared-memory load and a few integer
// operations instead of a load from L2 or HBM:
//
// - A warp per problem, per_block problems a block, so a launch spreads
//   over every SM.  The 32 lanes walk the problem in lockstep, each reading
//   the same shared byte (a broadcast), so every lane knows the position
//   without a shuffle.
// - Tiles.  A step goes from (d = i+j, i) to (d-2, i-1), (d-1, i-1) or
//   (d-1, i), so from an anchor (d0, i0) the walk stays at least R steps
//   inside diagonals d0-2R+1 .. d0 and rows i0-R+1 .. i0, the tile: on
//   each diagonal R contiguous bytes of dec.  The warp copies a tile into
//   shared memory in 16-byte cp.async chunks (a row of dec is M+1 bytes, so
//   TMA's 16-byte stride rule does not fit); a chunk that would cross an
//   end of the slab is read byte by byte at clamped indices instead, so no
//   read leaves the slab, and diagonals below 0 (only a walk on garbage
//   bytes goes there) take the clamped byte 0 without a read each.
//   Diagonal r of a tile lies at a pitch of K = P - (M+1) mod 16 bytes (P a
//   multiple of 16), which keeps every chunk 16-byte aligned in shared
//   memory and puts the byte of (d0 - r, i0 - R + 1 + q) at base + rK + q:
//   a step adds one of three constants to its pointer.  R is the least of
//   17, 33 and 65 above M (65 for larger M), so a problem of side <= 64
//   loads one tile.  A tile costs about a microsecond of latency plus the
//   time of its copies, which grows as R^2 while the steps it serves grow
//   as R: tiles of 129 rows timed slower than 65 at side 4096 and on
//   config 3's launch list (PERF.md).
// - One tile at a time: the next is loaded where the walk leaves the last.
//   A second buffer filled ahead (issued half-way through a tile, anchored
//   where the walk stood) timed slower too: it loaded twice the tiles, and
//   the warp that issues the copies is the warp that walks.
// - Ops go to a ring in shared memory (lane 0, a byte a step) and out to
//   device memory 32 bytes a warp store at each tile; the OP_NONE tail is
//   written by the whole warp, 16 bytes a lane where aligned.  Offsets into
//   dec and ops are 64-bit.  Offsets inside a problem's slab are of type
//   Off: int while the slab holds under 2^31 bytes, long long above (side
//   32768 and up); 64-bit arithmetic in the tile loads timed 7% slower on
//   config 3's launch list, so the launcher picks the narrow type where it
//   fits.

#ifndef CUDA_CPU_EMULATION
// Every read of dec goes through these two: 16 bytes of a problem's slab
// into shared memory, asynchronously (slab + off and dst 16-byte aligned),
// and one byte.  dec_copy_wait completes the thread's copies.
__device__ __forceinline__ void dec_copy16(uint8_t* dst, const uint8_t* slab, long long off) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(slab + off) : "memory");
}
__device__ __forceinline__ uint8_t dec_byte(const uint8_t* slab, long long off) { return slab[off]; }
__device__ __forceinline__ void dec_copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
#endif

constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }

// The geometry of a traceback tile of R rows (see the note above).
template <int R>
struct TbGeom {
    static constexpr int kDiags = 2 * R;
    static constexpr int kChunks = (R + 15 + 15) / 16;     // 16-byte chunks a diagonal
    static constexpr int kPitch = 16 * kChunks + 32;       // K = kPitch - W mod 16
    static constexpr int kTileBytes = kDiags * kPitch + 16;
    static constexpr int kRing = pow2_at_least(kDiags + 2);  // > a tile's steps
    static constexpr int kWarpBytes = kTileBytes + kRing;
    static constexpr int kMaxPerBlock = 232448 / kWarpBytes < 8 ? 232448 / kWarpBytes : 8;
};

// A tile in shared memory: the shared offset of its lowest row on its
// anchor diagonal, and the diagonals it holds.
struct TbTile {
    int base, rows;
};

// The warp loads the tile anchored at (d0, i0) into buf and waits for it:
// lane l takes chunk l % kChunks of diagonals l / kChunks, l / kChunks +
// 32 / kChunks, ...  Slab offsets are of type Off (n = (M+N+1)(M+1) bytes).
template <int R, class Off>
__device__ __forceinline__ TbTile tb_load_tile(
    uint8_t* buf, const uint8_t* slab, Off n, int W, int K, int d0, int i0)
{
    using G = TbGeom<R>;
    constexpr int kRowsAtOnce = 32 / G::kChunks;
    TbTile tile;
    // diagonals below 0 read byte 0 at every cell; a tile holds them only
    // when it starts there
    tile.rows = d0 >= 0 ? min(G::kDiags, d0 + 1) : G::kDiags;
    const unsigned addr = (unsigned)(uintptr_t)slab;  // its low 4 bits set the skews
    const Off lin0 = (Off)d0 * W + i0 - (R - 1);  // the anchor diagonal's lowest row
    tile.base = (int)((addr + lin0) & 15);
    const int lane = threadIdx.x & 31;
    const unsigned below = d0 < 0 ? dec_byte(slab, 0) * 0x01010101u : 0u;
    if (lane < kRowsAtOnce * G::kChunks) {
        const int ch = lane % G::kChunks;
#pragma unroll 2
        for (int r = lane / G::kChunks; r < tile.rows; r += kRowsAtOnce) {
            const Off lin = lin0 - (Off)r * W;
            const int skew = (int)((addr + lin) & 15);
            const Off src = lin - skew + 16 * ch;
            uint8_t* dst = buf + tile.base + r * K - skew + 16 * ch;
            if (d0 < 0) {
                *reinterpret_cast<uint4*>(dst) = make_uint4(below, below, below, below);
            } else if (src >= 0 && src <= n - 16) {
                dec_copy16(dst, slab, src);
            } else {
#pragma unroll
                for (int e = 0; e < 16; ++e) dst[e] = dec_byte(slab, min(max(src + e, (Off)0), n - 1));
            }
        }
    }
    dec_copy_wait();
    __syncwarp();
    return tile;
}

// The walk's state; r, q: the position's diagonal and row inside the tile
// (r = d0 - d, q = i - ilo); at: its byte in shared memory; fsel: the H
// source that the mode (F: up, E: left) or an edge (i = 0: left, j = 0:
// up) forces, or 0 if none, in the low nibble of 0x4440; mask: 3 if none
// is forced, else 0.
struct TbWalk {
    int i, j, mode, t, r, q;
    const uint8_t* at;
    unsigned fsel, mask;
    __device__ __forceinline__ void force() {
        const int edge = ((i == 0) << 1) | (j == 0);  // 3 only at the origin: not live
        const int forced = mode ? mode : edge;
        fsel = 0x4440u | (unsigned)forced;
        mask = forced ? 0u : 3u;
    }
    __device__ __forceinline__ bool live(int L) const { return (i > 0 || j > 0) && t < L; }
};

// Byte (sel & 3) of table, zero-extended: prmt with selector nibbles 1-3
// set to 4 (bytes of the zero operand).
__device__ __forceinline__ unsigned tb_pick(unsigned table, unsigned sel) {
#ifdef CUDA_CPU_EMULATION
    return __byte_perm(table, 0, sel);
#else
    unsigned d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(table), "r"(0u), "r"(sel));
    return d;
#endif
}

// One step.  The H source c is the byte's low two bits unless forced; c = 3
// is a source no forward kernel writes, which the plain version emits as
// left, steps diagonally and leaves in E.  The chain from one step's byte
// to the next step's load is short: sel = (byte & mask) | fsel, the
// pointer's change picked by prmt from `deltas`, and one three-input add
// (a diagonal step adds 2K - 1, up K - 1, left K: K - 1 plus the byte K, 0
// or 1 of deltas).  The rest (ops, counters, the next fsel and mask) runs
// beside it.
template <int kRing>
__device__ __forceinline__ void tb_step(TbWalk& w, uint8_t* ring, unsigned deltas, int k1,
                                        bool lane0)
{
    const unsigned byte = *w.at;
    const unsigned sel = (byte & w.mask) | w.fsel;
    w.at += k1 + (int)tb_pick(deltas, sel);
    const int c = (int)(sel & 3);
    const int c2 = min(c, 2);
    if (lane0) ring[w.t & (kRing - 1)] = (uint8_t)(c2 + 1);
    const int di = (c != 2);
    const int dj = (c != 1);
    w.i -= di;
    w.j -= dj;
    w.r += di + dj;
    w.q -= di;
    ++w.t;
    const unsigned opened = byte & (c == 1 ? 8u : 4u);
    w.mode = (c == 0 || opened) ? 0 : c2;
    w.force();
}

// Steps while the walk is live (not at the origin, fewer than L steps) and
// inside the tile (r < rows, q >= 0); every lane runs the same steps.
// Four at a time, with no test between them, while none of the four can
// end the walk or leave the tile (a step lowers i + j by at most 2, raises
// r by at most 2 and lowers q by at most 1).
template <int kRing>
__device__ __forceinline__ void tb_walk(TbWalk& w, uint8_t* ring, int L, unsigned deltas, int k1,
                                        int rows)
{
    const bool lane0 = (threadIdx.x & 31) == 0;
    while (w.i + w.j > 8 && w.t <= L - 4 && w.r <= rows - 8 && w.q >= 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) tb_step<kRing>(w, ring, deltas, k1, lane0);
    }
    while (w.live(L) && w.r < rows && w.q >= 0) tb_step<kRing>(w, ring, deltas, k1, lane0);
}

template <int R, class Off>
__global__ void __launch_bounds__(256) gotoh_traceback_kernel(
    const uint8_t* __restrict__ dec,     // [B, M+N+1, M+1]
    const int32_t* __restrict__ lens_a,  // [B]
    const int32_t* __restrict__ lens_b,  // [B]
    int B, int M, int N,
    uint8_t* __restrict__ ops,           // [B, M+N]
    int32_t* __restrict__ counts)        // [B]
{
    using G = TbGeom<R>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;
    const int W = M + 1;
    const int L = M + N;
    const int K = G::kPitch - (W & 15);
    const unsigned deltas = (unsigned)K | 1u << 16 | (unsigned)K << 24;  // c = 0, 1, 2, 3
    const Off n = (Off)(M + N + 1) * W;
    const uint8_t* slab = dec + (size_t)b * (size_t)n;
    uint8_t* ob = ops + (size_t)b * (size_t)L;
    // the tile and the ring, made from smem by arithmetic only so that the
    // walk's loads compile as shared-memory loads
    uint8_t* const buf = smem + (size_t)warp * G::kWarpBytes;
    uint8_t* const ring = buf + G::kTileBytes;
    TbWalk w{lens_a[b], lens_b[b], 0, 0, 0, 0, nullptr, 0, 0};
    w.force();
    int flushed = 0;
    while (w.live(L)) {
        const TbTile tile = tb_load_tile<R, Off>(buf, slab, n, W, K, w.i + w.j, w.i);
        w.r = 0;
        w.q = R - 1;
        w.at = buf + tile.base + (R - 1);
        tb_walk<G::kRing>(w, ring, L, deltas, K - 1, tile.rows);
        __syncwarp();  // the ring; and every lane is done with the tile
        for (int x = flushed + lane; x < w.t; x += 32) ob[x] = ring[x & (G::kRing - 1)];
        flushed = w.t;
    }
    if (lane == 0) counts[b] = w.t;
    // OP_NONE after the walk: bytes up to a 16-byte boundary, 16 bytes a
    // lane, then the bytes after the last whole 16
    const int t = w.t;
    const int head = min(L - t, (int)((16 - ((uintptr_t)(ob + t) & 15)) & 15));
    if (lane < head) ob[t + lane] = 0;
    const int body = t + head;
    const int body_end = body + ((L - body) & ~15);
    for (int x = body + 16 * lane; x < body_end; x += 16 * 32)
        *reinterpret_cast<uint4*>(ob + x) = make_uint4(0, 0, 0, 0);
    if (body_end + lane < L) ob[body_end + lane] = 0;
}

template <int R>
int tb_launch(const void* dec, const void* lens_a, const void* lens_b, int B, int M, int N,
              int per_block, void* ops, void* counts, cudaStream_t stream)
{
    using G = TbGeom<R>;
    if (per_block <= 0) per_block = 1;
    if (per_block > G::kMaxPerBlock) per_block = G::kMaxPerBlock;
    const int smem = per_block * G::kWarpBytes;
    // slab offsets in 32 bits while a slab holds under 2^31 bytes
    const bool wide = (long long)(M + N + 1) * (M + 1) > 0x7fffffffLL;
    const auto kernel = wide ? gotoh_traceback_kernel<R, long long> : gotoh_traceback_kernel<R, int>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + per_block - 1) / per_block;
    kernel<<<blocks, 32 * per_block, smem, stream>>>(
        (const uint8_t*)dec, (const int32_t*)lens_a, (const int32_t*)lens_b, B, M, N,
        (uint8_t*)ops, (int32_t*)counts);
    return (int)cudaGetLastError();
}

// Block shape of a forward launch: warps per problem (the caller's, or by
// side: 1 up to 32, 4 up to 256, 8 at 512, 16 above) and, with one warp
// per problem, problems per block, as many as shared memory allows up to
// 4.  per_problem: the dynamic shared memory of one problem, 0 when its
// buffer lies in the device slab.
struct Shape {
    int warps, per_block, threads, blocks;
    size_t smem;
};

Shape forward_shape(int B, int M, size_t per_problem, int warps, long long smem_limit) {
    if (warps <= 0) warps = (M <= 32) ? 1 : (M <= 256 ? 4 : (M <= 512 ? 8 : kMaxWarps));
    if (warps > kMaxWarps) warps = kMaxWarps;
    Shape s;
    s.warps = warps;
    s.per_block = 1;
    if (warps == 1) {
        const size_t cap = smem_limit < 200 * 1024 ? (size_t)smem_limit : (size_t)200 * 1024;
        s.per_block = 4;
        while (s.per_block > 1 && s.per_block * per_problem > cap) --s.per_block;
    }
    s.threads = 32 * (warps == 1 ? s.per_block : warps);
    s.blocks = (B + s.per_block - 1) / s.per_block;
    s.smem = s.per_block * per_problem;
    return s;
}

// Bytes a forward kernel's block can hold in dynamic shared memory: the
// caller's limit, or (smem_limit <= 0) the device's opt-in limit less room
// for the kernels' static shared memory (the codes kernel's 144-byte table).
constexpr int kStaticSmemReserve = 1024;

long long smem_budget(long long smem_limit) {
    if (smem_limit > 0) return smem_limit;
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
        return 0;
    return (long long)optin - kStaticSmemReserve;
}

// Bytes of device slab a forward launch needs: 0 when a problem's buffer
// fits shared memory, else B rows of problem_bytes.
long long forward_scratch(int B, int N, size_t column_bytes, long long smem_limit) {
    const size_t per = problem_bytes(N, column_bytes);
    return (long long)per > smem_budget(smem_limit) ? (long long)B * (long long)per : 0;
}

// One forward launch: plans it and hands `launch` the kernel instance (the
// shared-memory one, or the slab one when a problem's buffer does not fit
// the block), the block shape and the slab (null for shared memory).
template <class Kernel, class Launch>
int forward_launch(Kernel shared_kernel, Kernel slab_kernel, int B, int M, int N,
                   size_t column_bytes, int warps, long long smem_limit, void* scratch,
                   Launch launch)
{
    const long long budget = smem_budget(smem_limit);
    if (budget <= 0) return (int)cudaErrorInvalidValue;
    const bool slab = forward_scratch(B, N, column_bytes, budget) > 0;
    if (slab && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const Shape s = forward_shape(B, M, slab ? 0 : problem_bytes(N, column_bytes), warps, budget);
    const Kernel kernel = slab ? slab_kernel : shared_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err != cudaSuccess) return (int)err;
    launch(kernel, s, slab ? (unsigned char*)scratch : nullptr);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device slab the caller allocates for a forward launch (profiles:
// 0 codes, 1 count profiles), 0 when none is needed.  smem_limit as for the
// launchers.
long long gotoh_forward_scratch_bytes(int B, int N, int profiles, long long smem_limit) {
    return forward_scratch(B, N, profiles ? 5 * sizeof(float) : 1, smem_limit);
}

// smem_limit: the dynamic shared memory a block may use, 0 for the
// device's opt-in limit; scratch: gotoh_forward_scratch_bytes of device
// memory, or null when that is 0.
int gotoh_forward_codes_launch(
    const void* codes_a, const void* codes_b, const void* lens_a, const void* lens_b,
    const void* subst, float go_ge, float ge, int B, int M, int N, int warps,
    long long smem_limit, void* scratch, void* scores, void* dec, void* stream)
{
    return forward_launch(
        gotoh_forward_codes_kernel<false>, gotoh_forward_codes_kernel<true>, B, M, N, 1, warps,
        smem_limit, scratch, [&](auto kernel, const Shape& s, unsigned char* slab) {
            kernel<<<s.blocks, s.threads, s.smem, (cudaStream_t)stream>>>(
                (const uint8_t*)codes_a, (const uint8_t*)codes_b, (const int32_t*)lens_a,
                (const int32_t*)lens_b, (const float*)subst, go_ge, ge, B, M, N, s.warps,
                (float*)scores, (uint8_t*)dec, slab);
        });
}

int gotoh_forward_profiles_launch(
    const void* prof_a, const void* prof_b, const void* lens_a, const void* lens_b,
    const void* subst, float go_ge, float ge, int B, int M, int N, int normalize, int warps,
    long long smem_limit, void* scratch, void* scores, void* dec, void* stream)
{
    return forward_launch(
        gotoh_forward_profiles_kernel<false>, gotoh_forward_profiles_kernel<true>, B, M, N,
        5 * sizeof(float), warps, smem_limit, scratch,
        [&](auto kernel, const Shape& s, unsigned char* slab) {
            kernel<<<s.blocks, s.threads, s.smem, (cudaStream_t)stream>>>(
                (const float*)prof_a, (const float*)prof_b, (const int32_t*)lens_a,
                (const int32_t*)lens_b, (const float*)subst, go_ge, ge, B, M, N, normalize,
                s.warps, (float*)scores, (uint8_t*)dec, slab);
        });
}

// per_block: problems (warps) a block, 0 for the default of 1 (1, 2 and 4
// timed alike on config 3's launch list, 8 slower), at most 8 and what
// shared memory allows.
int gotoh_traceback_launch(
    const void* dec, const void* lens_a, const void* lens_b, int B, int M, int N,
    int per_block, void* ops, void* counts, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    if (M < 17) return tb_launch<17>(dec, lens_a, lens_b, B, M, N, per_block, ops, counts, s);
    if (M < 33) return tb_launch<33>(dec, lens_a, lens_b, B, M, N, per_block, ops, counts, s);
    return tb_launch<65>(dec, lens_a, lens_b, B, M, N, per_block, ops, counts, s);
}

const char* gotoh_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
