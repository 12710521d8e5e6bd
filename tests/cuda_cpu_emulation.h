// A CPU stand-in for the few CUDA features csrc/gotoh.cu uses, so that its
// forward kernels' schedule (strips, phases, shuffles, shared buffers) can
// run under g++ in tests/test_torch_gotoh_emulated.py.  One std::thread per
// CUDA thread, blocks one after another; std::barrier implements
// __syncthreads, __syncwarp and both halves of __shfl_up_sync (every lane
// writes, all wait, every lane reads, all wait).  Shared memory is one
// buffer per block.  Arithmetic is plain IEEE f32 (build with
// -ffp-contract=off).  It checks logic, not speed or the GPU's compiler.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct EmuDim { unsigned x, y, z; };
inline thread_local EmuDim threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error (CPU emulation)"; }
using std::max;
using std::min;

struct EmuWarp {
    std::barrier<> bar{32};
    float val[32];
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
