// A CPU stand-in for the few CUDA features csrc/gotoh.cu and csrc/extend.cu
// use, so that their kernels' schedules (the forward kernels' strips,
// phases, shuffles and shared buffers; the traceback's tiles and op ring;
// the extension's paired walks and word reads) can run under g++ in
// tests/test_torch_gotoh_emulated.py and tests/test_torch_extend.py.  One
// std::thread per CUDA thread, blocks one after another; std::barrier
// implements __syncthreads, __syncwarp and both halves of __shfl_up_sync and
// __shfl_xor_sync (every lane writes, all wait, every lane reads, all
// wait).  The word and byte intrinsics are plain bit arithmetic.  Shared memory is one
// buffer per block.  Arithmetic is plain IEEE f32 (build with
// -ffp-contract=off).  The traceback's reads of dec (dec_copy16, dec_byte)
// are plain copies that record, per slab, the lowest and highest byte
// offset read (emu_dec_read_range).  It checks logic, not speed or the
// GPU's compiler.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define CUDA_CPU_EMULATION

struct EmuDim { unsigned x, y, z; };
inline thread_local EmuDim threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
// an H100's opt-in limit
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 232448; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error (CPU emulation)"; }
using std::max;
using std::min;

struct EmuWarp {
    std::barrier<> bar{32};
    float val[32];
    long long wide[32];
};

struct EmuBlock {
    std::barrier<> bar;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    alignas(16) unsigned char static_smem[1024];
    std::vector<unsigned char> dynamic_smem;
    EmuBlock(int threads, size_t smem) : bar(threads), dynamic_smem(smem + 16) {
        for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new EmuWarp);
    }
};

inline thread_local EmuBlock* emu_block;
inline unsigned char* emu_dynamic_smem() { return emu_block->dynamic_smem.data(); }
inline unsigned char* emu_static_smem() { return emu_block->static_smem; }
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void __syncwarp() { emu_block->warps[threadIdx.x / 32]->bar.arrive_and_wait(); }

inline float __shfl_up_sync(unsigned, float v, int delta) {
    EmuWarp& w = *emu_block->warps[threadIdx.x / 32];
    const int lane = threadIdx.x & 31;
    w.val[lane] = v;
    w.bar.arrive_and_wait();
    const float r = lane >= delta ? w.val[lane - delta] : v;
    w.bar.arrive_and_wait();
    return r;
}

inline long long __shfl_xor_sync(unsigned, long long v, int mask) {
    EmuWarp& w = *emu_block->warps[threadIdx.x / 32];
    const int lane = threadIdx.x & 31;
    w.wide[lane] = v;
    w.bar.arrive_and_wait();
    const long long r = w.wide[lane ^ mask];
    w.bar.arrive_and_wait();
    return r;
}

template <class T> inline T __ldg(const T* p) { T v; std::memcpy(&v, p, sizeof v); return v; }
// the low 32 bits of {hi, lo} >> (shift & 31)
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
    return (unsigned)((((unsigned long long)hi << 32) | lo) >> (shift & 31));
}
// 1-based index of the lowest set bit, 0 if none
inline int __ffs(int x) { return __builtin_ffs(x); }
// per byte: 0xff where the condition holds, else 0
template <class P> inline unsigned emu_bytewise(unsigned a, unsigned b, P pred) {
    unsigned r = 0;
    for (int k = 0; k < 4; ++k)
        if (pred((a >> (8 * k)) & 0xff, (b >> (8 * k)) & 0xff)) r |= 0xffu << (8 * k);
    return r;
}
inline unsigned __vcmpeq4(unsigned a, unsigned b) {
    return emu_bytewise(a, b, [](unsigned x, unsigned y) { return x == y; });
}
inline unsigned __vcmpltu4(unsigned a, unsigned b) {
    return emu_bytewise(a, b, [](unsigned x, unsigned y) { return x < y; });
}

struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }

// Reads of a problem's decision slab, by slab address: [lowest, highest]
// byte offset.
inline std::mutex emu_reads_mutex;
inline std::map<const void*, std::pair<long long, long long>> emu_reads;

inline void emu_record_read(const uint8_t* slab, long long lo, long long hi) {
    std::lock_guard<std::mutex> g(emu_reads_mutex);
    auto it = emu_reads.find(slab);
    if (it == emu_reads.end()) emu_reads[slab] = {lo, hi};
    else it->second = {std::min(it->second.first, lo), std::max(it->second.second, hi)};
}

inline void dec_copy16(uint8_t* dst, const uint8_t* slab, long long off) {
    // cp.async of 16 bytes faults unless both addresses are 16-byte aligned
    if (((uintptr_t)dst | (uintptr_t)(slab + off)) & 15) std::abort();
    emu_record_read(slab, off, off + 15);
    std::memcpy(dst, slab + off, 16);
}
inline uint8_t dec_byte(const uint8_t* slab, long long off) {
    emu_record_read(slab, off, off);
    return slab[off];
}
inline void dec_copy_wait() {}

extern "C" void emu_dec_reads_clear() {
    std::lock_guard<std::mutex> g(emu_reads_mutex);
    emu_reads.clear();
}
// 1 and the range read from `slab`, or 0 if nothing was read there.
extern "C" int emu_dec_read_range(const void* slab, long long* lo, long long* hi) {
    std::lock_guard<std::mutex> g(emu_reads_mutex);
    auto it = emu_reads.find(slab);
    if (it == emu_reads.end()) return 0;
    *lo = it->second.first;
    *hi = it->second.second;
    return 1;
}

// byte n of the result is byte (s >> 4n) & 7 of the pair {y, x} (x low)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const unsigned long long v = (unsigned long long)y << 32 | x;
    unsigned r = 0;
    for (int k = 0; k < 4; ++k) r |= (unsigned)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xff) << (8 * k);
    return r;
}

inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }

// kernel<<<grid, threads, smem, stream>>>(args) is rewritten as
// EmuLaunch(grid, threads, smem).run(kernel, args).
struct EmuLaunch {
    int grid, threads;
    size_t smem;
    EmuLaunch(int g, int t, size_t s) : grid(g), threads(t), smem(s) {}
    template <class F, class... A> void run(F kernel, A... args) {
        for (int b = 0; b < grid; ++b) {
            EmuBlock block(threads, smem);
            std::vector<std::thread> pool;
            for (int x = 0; x < threads; ++x) {
                pool.emplace_back([&, x] {
                    threadIdx = {(unsigned)x, 0, 0};
                    blockIdx = {(unsigned)b, 0, 0};
                    blockDim = {(unsigned)threads, 1, 1};
                    emu_block = &block;
                    kernel(args...);
                });
            }
            for (auto& t : pool) t.join();
        }
    }
};
