// K3 Gotoh affine-gap global alignment on Hopper (sm_90a): forward pass and
// traceback for batches of code pairs.  Plain C interface, loaded with ctypes
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

// gotoh_forward_codes_kernel replaces the TPU kernel
// mauvealigner_tpu/ops/dp_pallas.py::_kernel (driven by
// gotoh_forward_pallas), whose arithmetic order and tie rules it keeps:
// E = max(H[i][j-1] + (go+ge), E[i][j-1] + ge), open on >=; F likewise from
// row i-1; H = diag, then F only if strictly greater, then E only if
// strictly greater.  The substitution score is looked up from the codes per
// cell (no sheared [M, N] score matrix) and accumulates in f32.
//
// One CTA per problem walks all M+N anti-diagonals with one __syncthreads()
// each; thread t owns lanes i = t, t + blockDim.x, ...  The TPU kernel
// carried H/E/F across its sequential grid axis in VMEM scratch; here that
// carry is the in-block diagonal loop over shared memory: three rotating H
// rows (diagonals d, d-1, d-2) and ping-pong E and F rows, 7 x 4 x (M+1)
// bytes (112 KB at M = 4096, 224 KB at 8192).
//
// Bound on this card: the serial chain of M+N dependent diagonals (one
// barrier each, a handful of lanes per thread) and the stores of the
// (M+N+1)(M+1) decision bytes.  Later work: a warp per problem for buckets
// <= 64 (no block barrier), and decision bytes kept in shared memory with a
// fused traceback so they never reach device memory.
__global__ void gotoh_forward_codes_kernel(
    const uint8_t* __restrict__ codes_a,  // [B, M], codes > 4 are padding
    const uint8_t* __restrict__ codes_b,  // [B, N]
    const int32_t* __restrict__ lens_a,   // [B]
    const int32_t* __restrict__ lens_b,   // [B]
    const float* __restrict__ subst,      // [5, 5]
    float go_ge, float ge, int M, int N,
    float* __restrict__ scores,           // [B]
    uint8_t* __restrict__ dec)            // [B, M+N+1, M+1]
{
    extern __shared__ float rows[];  // 7 rows of W floats
    __shared__ float sub6[36];       // subst with a zero row/column for padding
    const int b = blockIdx.x;
    const int W = M + 1;
    const uint8_t* ca = codes_a + (size_t)b * M;
    const uint8_t* cb = codes_b + (size_t)b * N;
    uint8_t* db = dec + (size_t)b * (size_t)(M + N + 1) * W;
    const int ma = lens_a[b];
    const int d_final = ma + lens_b[b];

    for (int k = threadIdx.x; k < 36; k += blockDim.x) {
        const int r = k / 6, c = k % 6;
        sub6[k] = (r < 5 && c < 5) ? subst[r * 5 + c] : 0.0f;
    }
    // H rows 0..2, E rows 3..4, F rows 5..6.  Diagonal 0: H = [0, NEG, ...]
    // in row 0; the "diagonal -1" H row (row 2) and E/F (rows 3, 5) are NEG.
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        rows[i] = (i == 0) ? 0.0f : kNeg;
        rows[2 * W + i] = kNeg;
        rows[3 * W + i] = kNeg;
        rows[5 * W + i] = kNeg;
        db[i] = 0;
    }
    if (threadIdx.x == 0 && d_final == 0) scores[b] = 0.0f;
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
        for (int i = threadIdx.x; i < W; i += blockDim.x) {
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
                if (j >= 1 && j <= N) {
                    s = sub6[min((int)ca[i - 1], 5) * 6 + min((int)cb[j - 1], 5)];
                }
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
            if (i == ma && d == d_final) scores[b] = best;
        }
        __syncthreads();
        r_prev2 = r_prev;
        r_prev = r_cur;
        r_cur = (r_cur + 1) % 3;
    }
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
