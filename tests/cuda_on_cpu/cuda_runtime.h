// A stand-in for <cuda_runtime.h> that lets a host compiler build
// csrc/block_chol.cuh and run it with one OS thread per CUDA thread:
// __syncthreads() and __syncwarp() are std::barriers, so a missing barrier
// shows as a wrong result or, under a thread sanitizer, as a data race.
// Used by tests/test_torch_kernel_on_cpu.py only.
#pragma once
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>

#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__

struct float4 {
  float x, y, z, w;
} __attribute__((aligned(16)));
struct uchar2 {
  unsigned char x, y;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline uchar2 make_uchar2(unsigned char x, unsigned char y) { return uchar2{x, y}; }

struct Index {
  int x;
};
extern thread_local Index threadIdx;
constexpr Index blockIdx{0};  // the harness runs one block at a time
extern std::barrier<>* block_barrier;
extern std::barrier<>* warp_barrier[32];

inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp() { warp_barrier[threadIdx.x / 32]->arrive_and_wait(); }
inline float4 __ldg(const float4* p) { return *p; }
using std::isfinite;
inline long long clock64() {  // for -DBLOCK_CHOL_CLOCKS: nanoseconds
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
