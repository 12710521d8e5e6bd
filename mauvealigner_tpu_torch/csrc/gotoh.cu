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

// The forward recurrence both input modes share (gotoh_forward_diagonals)
// replaces the TPU kernel mauvealigner_tpu/ops/dp_pallas.py::_kernel (driven
// by gotoh_forward_pallas), whose arithmetic order and tie rules it keeps:
// E = max(H[i][j-1] + (go+ge), E[i][j-1] + ge), open on >=; F likewise from
// row i-1; H = diag, then F only if strictly greater, then E only if
// strictly greater.  Lane 0 scores NEG, cells off the band (j < 1 or j > N)
// score 0; the substitution score of a live cell comes from the Score
// provider, per cell (no sheared [M, N] score matrix), and accumulates in
// f32.
//
// One CTA per problem walks all M+N anti-diagonals with one __syncthreads()
// each; thread t owns lanes i = t + k * blockDim.x, k < Score::kLanes.  The
// TPU kernel carried H/E/F across its sequential grid axis in VMEM scratch;
// here that carry is the in-block diagonal loop over shared memory: three
// rotating H rows (diagonals d, d-1, d-2) and ping-pong E and F rows,
// 7 x 4 x (M+1) bytes (112 KB at M = 4096, 224 KB at 8192).
//
// Bound on this card: the serial chain of M+N dependent diagonals (one
// barrier each, a handful of lanes per thread) and the stores of the
// (M+N+1)(M+1) decision bytes.  Later work: a warp per problem for buckets
// <= 64 (no block barrier), stopping each CTA at its own mA + mB, and
// decision bytes kept in shared memory with a fused traceback so they never
// reach device memory.
template <class Score>
__device__ __forceinline__ void gotoh_forward_diagonals(
    const Score& score, float* rows, int M, int N, int ma, int d_final,
    float go_ge, float ge, float* __restrict__ score_out, uint8_t* __restrict__ db)
{
    const int W = M + 1;
    // H rows 0..2, E rows 3..4, F rows 5..6.  Diagonal 0: H = [0, NEG, ...]
    // in row 0; the "diagonal -1" H row (row 2) and E/F (rows 3, 5) are NEG.
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        rows[i] = (i == 0) ? 0.0f : kNeg;
        rows[2 * W + i] = kNeg;
        rows[3 * W + i] = kNeg;
        rows[5 * W + i] = kNeg;
        db[i] = 0;
    }
    if (threadIdx.x == 0 && d_final == 0) *score_out = 0.0f;
    __syncthreads();

    int r_cur = 1, r_prev = 0, r_prev2 = 2;  // H rows of diagonals d, d-1, d-2
    for (int d = 1; d <= M + N; ++d) {
        const float* hp = rows + r_prev * W;
        const float* hp2 = rows + r_prev2 * W;
        float* hn = rows + r_cur * W;
        const float* ep = rows + (3 + ((d - 1) & 1)) * W;
        float* en = rows + (3 + (d & 1)) * W;
        const float* fp = rows + (5 + ((d - 1) & 1)) * W;
        float* fn = rows + (5 + (d & 1)) * W;
        uint8_t* drow = db + (size_t)d * W;
#pragma unroll
        for (int k = 0; k < Score::kLanes; ++k) {
            const int i = threadIdx.x + k * blockDim.x;
            if (i >= W) break;
            const int j = d - i;
            const float e_from_h = hp[i] + go_ge;
            const float e_from_e = ep[i] + ge;
            const bool e_open = e_from_h >= e_from_e;
            const float ev = (j >= 1) ? fmaxf(e_from_h, e_from_e) : kNeg;
            // lane 0 shifts in NEG for the up and diagonal neighbours, and
            // its diagonal score is NEG as well (the JAX shift_down + pad)
            const float h_up = (i >= 1) ? hp[i - 1] : kNeg;
            const float f_up = (i >= 1) ? fp[i - 1] : kNeg;
            const float f_from_h = h_up + go_ge;
            const float f_from_f = f_up + ge;
            const bool f_open = f_from_h >= f_from_f;
            const float fv = (i >= 1) ? fmaxf(f_from_h, f_from_f) : kNeg;
            float s = kNeg;
            if (i >= 1) {
                s = 0.0f;
                if (j >= 1 && j <= N) s = score(k, i, j);
            }
            const float hd = ((i >= 1) ? hp2[i - 1] : kNeg) + s;
            float best = hd;
            int choice = 0;
            if (fv > best) { best = fv; choice = 1; }
            if (ev > best) { best = ev; choice = 2; }
            drow[i] = (uint8_t)(choice | (e_open ? 4 : 0) | (f_open ? 8 : 0));
            hn[i] = best;
            en[i] = ev;
            fn[i] = fv;
            if (i == ma && d == d_final) *score_out = best;
        }
        __syncthreads();
        r_prev2 = r_prev;
        r_prev = r_cur;
        r_cur = (r_cur + 1) % 3;
    }
}

// Code pairs: the score is a lookup in the substitution matrix (codes > 4
// are padding and score 0).  Lanes per thread: ceil((8192 + 1) / 1024).
struct CodeScore {
    static constexpr int kLanes = 9;
    const uint8_t* ca;
    const uint8_t* cb;
    const float* sub6;  // [6, 6], zero row and column for padding
    __device__ __forceinline__ float operator()(int, int i, int j) const {
        return sub6[min((int)ca[i - 1], 5) * 6 + min((int)cb[j - 1], 5)];
    }
};

// Profiles: lane i's row score q_i = pA[i-1] . SUBST (5 floats) is computed
// once per owned lane into registers; a cell reads pB[j-1] from shared
// memory and takes s = sum_l q_i[l] * pB[j-1][l] over l = 0..4 in order.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// fused multiply-add), the order ops/dp.py::gotoh_forward_profiles_ref
// uses, so kernel and plain version agree to the bit; on integer counts
// with an integer matrix every partial sum is an integer below 2^24 and the
// result equals the JAX package's in any order.  Lanes per thread:
// ceil((4096 + 1) / 1024).
struct ProfileScore {
    static constexpr int kLanes = 5;
    float q[kLanes][5];
    const float* pb;  // shared memory, [N, 5]
    __device__ __forceinline__ float operator()(int k, int, int j) const {
        const float* r = pb + (j - 1) * 5;
        float s = __fmul_rn(q[k][0], r[0]);
#pragma unroll
        for (int l = 1; l < 5; ++l) s = __fadd_rn(s, __fmul_rn(q[k][l], r[l]));
        return s;
    }
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

// Both forward kernels launch up to 1024 threads (one per lane of the
// widest diagonal), so each may hold at most 64 registers: the bound makes
// ptxas fit that instead of refusing the launch at sides >= 1024.
__global__ void __launch_bounds__(1024) gotoh_forward_codes_kernel(
    const uint8_t* __restrict__ codes_a,  // [B, M], codes > 4 are padding
    const uint8_t* __restrict__ codes_b,  // [B, N]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int M, int N,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec)            // [B, M+N+1, M+1]
{
    extern __shared__ float rows[];  // 7 rows of M + 1 floats
    __shared__ float sub6[36];
    const int b = blockIdx.x;
    for (int k = threadIdx.x; k < 36; k += blockDim.x) {
        const int r = k / 6, c = k % 6;
        sub6[k] = (r < 5 && c < 5) ? subst[r * 5 + c] : 0.0f;
    }
    // sub6 is read only after the body's first barrier
    const CodeScore score{codes_a + (size_t)b * M, codes_b + (size_t)b * N, sub6};
    const int ma = lens_a[b];
    gotoh_forward_diagonals(score, rows, M, N, ma, ma + lens_b[b], go_ge, ge,
                            scores + b, dec + (size_t)b * (size_t)(M + N + 1) * (M + 1));
}

// gotoh_forward_profiles_kernel: the profile input of the same TPU kernel
// (the JAX package's count-profile DP, dp.align_profiles_batch_async).
// Shared memory: the 7 state rows plus pB staged once (normalized when asked),
// 7 x 4 x (M+1) + 20 x N bytes: 192 KB at M = N = 4096, so this kernel's
// side limit is 4096 (PROFILE_MAX_SIDE in ops/gotoh_cuda.py).
__global__ void __launch_bounds__(1024) gotoh_forward_profiles_kernel(
    const float* __restrict__ prof_a,     // [B, M, 5], zero rows past lens_a
    const float* __restrict__ prof_b,     // [B, N, 5]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int M, int N, int normalize,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec)            // [B, M+N+1, M+1]
{
    extern __shared__ float rows[];  // 7 rows of M + 1 floats, then pB [N, 5]
    const int b = blockIdx.x;
    const int W = M + 1;
    float* pb = rows + 7 * W;
    const float* pa_b = prof_a + (size_t)b * M * 5;
    const float* pb_b = prof_b + (size_t)b * N * 5;
    for (int r = threadIdx.x; r < N; r += blockDim.x) {
        float p[5];
        load_profile_row(pb_b + (size_t)r * 5, normalize != 0, p);
#pragma unroll
        for (int l = 0; l < 5; ++l) pb[r * 5 + l] = p[l];
    }
    ProfileScore score;
    score.pb = pb;
#pragma unroll
    for (int k = 0; k < ProfileScore::kLanes; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
#pragma unroll
        for (int l = 0; l < 5; ++l) score.q[k][l] = 0.0f;
        if (i < 1 || i >= W) continue;
        float p[5];
        load_profile_row(pa_b + (size_t)(i - 1) * 5, normalize != 0, p);
#pragma unroll
        for (int l = 0; l < 5; ++l) {
            float q = __fmul_rn(p[0], subst[l]);
#pragma unroll
            for (int m = 1; m < 5; ++m) q = __fadd_rn(q, __fmul_rn(p[m], subst[m * 5 + l]));
            score.q[k][l] = q;
        }
    }
    // pb is read only after the body's first barrier
    const int ma = lens_a[b];
    gotoh_forward_diagonals(score, rows, M, N, ma, ma + lens_b[b], go_ge, ge,
                            scores + b, dec + (size_t)b * (size_t)(M + N + 1) * W);
}

// gotoh_traceback_kernel replaces the XLA traceback
// mauvealigner_tpu/ops/dp.py::gotoh_traceback (a fixed-trip lax.scan, a
// TPU miscompile workaround).  One thread per problem walks from (mA, mB)
// to (0, 0) with the H/F/E mode state and writes ops end first.
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

}  // namespace

extern "C" {

int gotoh_forward_codes_launch(
    const void* codes_a, const void* codes_b, const void* lens_a, const void* lens_b,
    const void* subst, float go_ge, float ge, int B, int M, int N,
    void* scores, void* dec, void* stream)
{
    const int W = M + 1;
    int threads = ((W + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    const size_t smem = 7 * sizeof(float) * (size_t)W;
    cudaError_t err = cudaFuncSetAttribute(
        gotoh_forward_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gotoh_forward_codes_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)codes_a, (const uint8_t*)codes_b, (const int32_t*)lens_a,
        (const int32_t*)lens_b, (const float*)subst, go_ge, ge, M, N,
        (float*)scores, (uint8_t*)dec);
    return (int)cudaGetLastError();
}

int gotoh_forward_profiles_launch(
    const void* prof_a, const void* prof_b, const void* lens_a, const void* lens_b,
    const void* subst, float go_ge, float ge, int B, int M, int N, int normalize,
    void* scores, void* dec, void* stream)
{
    const int W = M + 1;
    int threads = ((W + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    const size_t smem = sizeof(float) * (7 * (size_t)W + 5 * (size_t)N);
    cudaError_t err = cudaFuncSetAttribute(
        gotoh_forward_profiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gotoh_forward_profiles_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)prof_a, (const float*)prof_b, (const int32_t*)lens_a,
        (const int32_t*)lens_b, (const float*)subst, go_ge, ge, M, N, normalize,
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
