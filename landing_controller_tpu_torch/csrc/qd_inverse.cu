// Batched inverse of quasi-definite KKT blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_qd_inverse_kernel`
// (landing_controller_tpu/ops/pallas_blocks.py:111, wrapper `qd_inverse`
// :154).  For each instance S = [[P, B'], [B, -D]] (P: np x np, D: nd x nd,
// both positive definite) it computes
//     Sinv = [[Pinv - E W E', E W], [W E', -W]],  E = Pinv B',  W = (D + B E)^-1
// and the inertia flag ok = min(pivots of P and of D + B E) > 0, where a
// non-finite pivot counts as a failure.  Pivots follow the TPU kernel's
// rule: rsqrt(max(d, 1e-30)), continuing past bad pivots, so every output is
// written even when ok is false.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): an instance reads and writes 8 bs^2 bytes and does about bs^3
// operations, so at (np, nd) = (48, 36), m = 5120 the card needs 0.086 ms for
// the bytes and 0.05 ms for the operations, and at (36, 24), m = 1280 0.011
// ms: bound by bytes.  Five of the six launches of a cyclic-reduction
// factorization are a single wave of blocks and are bound by the latency of
// one instance: its chain of dependent steps, not its arithmetic.
//
// Design: one thread block per instance, the batch is the grid; the whole
// computation is the device function of block_chol.cuh (its note has the
// steps): a signed Cholesky of S by panels of 8 columns whose diagonal tiles
// one warp factors and inverts in registers, every other step a small
// product on register tiles with float4 shared-memory reads, L^-1 formed in
// place, and the lower triangle of Sinv = L^-T J L^-1 stored with its mirror
// image.  Shared memory holds S once (plus an 8 x bs scratch): 16.6 KB at
// (36, 24) and 31.4 KB at (48, 36); 7 blocks of 128 threads stay on an SM,
// limited by their 72 registers a thread.  The sizes the solver paths run, (36,
// 24), (48, 36) and (36, 40), are compile-time instances; any other size up
// to 84 wide goes through the instance with run-time sizes (scalar loads and
// stores where the width is no multiple of 4).  Each instance is built for
// f32 and for f64 (the same steps on 8-byte words, with twice the shared
// memory: 32.9 KB at (36, 24), 62.3 KB at (48, 36), above the default 48 KB
// limit, which block_chol::allow_smem raises once per device).  In f64 an instance
// reads and writes 16 bs^2 bytes, so its byte bound is twice the f32 one.
//
// Plain C interface (bound from Python with ctypes): the wrapper passes
// device pointers and the CUDA stream, and raises on a nonzero return.

#include <cuda_runtime.h>

#include "block_chol.cuh"

namespace {

template <typename T, int NP_T, int ND_T>
__global__ void __launch_bounds__(block_chol::kThreads, block_chol::kMinBlocks)
    qd_inverse_kernel(const T* __restrict__ S_all, T* __restrict__ out_all,
                      unsigned char* __restrict__ ok_all, int np_, int nd) {
  extern __shared__ float4 smem4[];
  const int bs = (NP_T + ND_T) ? NP_T + ND_T : np_ + nd;
  const size_t offset = (size_t)blockIdx.x * bs * bs;
  block_chol::inverse_block<NP_T + ND_T, NP_T>(S_all + offset, out_all + offset,
                                               ok_all + blockIdx.x, bs, np_,
                                               reinterpret_cast<T*>(smem4));
}

// The sizes the solver paths run are compile-time instances, any other size
// up to 84 wide goes to the run-time one.
template <typename T>
int blocks_per_sm(int np_, int nd) {
  const size_t smem = block_chol::smem_bytes<T>(np_ + nd);
  if (np_ == 36 && nd == 24)
    return block_chol::blocks_per_sm<T, qd_inverse_kernel<T, 36, 24>>(smem);
  if (np_ == 48 && nd == 36)
    return block_chol::blocks_per_sm<T, qd_inverse_kernel<T, 48, 36>>(smem);
  if (np_ == 36 && nd == 40)
    return block_chol::blocks_per_sm<T, qd_inverse_kernel<T, 36, 40>>(smem);
  return block_chol::blocks_per_sm<T, qd_inverse_kernel<T, 0, 0>>(smem);
}

template <typename T>
int launch(const T* S, T* out, unsigned char* ok, int m, int np_, int nd, void* stream) {
  if (m <= 0) return 0;
  if (np_ < 1 || nd < 0 || np_ + nd > block_chol::kMaxBlock) return (int)cudaErrorInvalidValue;
  const size_t smem = block_chol::smem_bytes<T>(np_ + nd);
  if (np_ == 36 && nd == 24)
    return block_chol::launch<T, qd_inverse_kernel<T, 36, 24>>(
        m, smem, stream, S, out, ok, np_, nd);
  if (np_ == 48 && nd == 36)
    return block_chol::launch<T, qd_inverse_kernel<T, 48, 36>>(
        m, smem, stream, S, out, ok, np_, nd);
  if (np_ == 36 && nd == 40)
    return block_chol::launch<T, qd_inverse_kernel<T, 36, 40>>(
        m, smem, stream, S, out, ok, np_, nd);
  return block_chol::launch<T, qd_inverse_kernel<T, 0, 0>>(m, smem, stream, S, out, ok, np_, nd);
}

}  // namespace

// Dynamic shared memory of one block of the f32 / f64 instance for (np, nd).
extern "C" size_t qd_inverse_smem_bytes(int np_, int nd) {
  return block_chol::smem_bytes<float>(np_ + nd);
}
extern "C" size_t qd_inverse_smem_bytes_f64(int np_, int nd) {
  return block_chol::smem_bytes<double>(np_ + nd);
}

// Blocks of the instance for (np, nd) that one SM holds at a time, or the
// negated cudaError_t.
extern "C" int qd_inverse_blocks_per_sm(int np_, int nd) { return blocks_per_sm<float>(np_, nd); }
extern "C" int qd_inverse_blocks_per_sm_f64(int np_, int nd) {
  return blocks_per_sm<double>(np_, nd);
}

// S: (m, bs, bs), out: (m, bs, bs), both f32 (f64 for the _f64 entry),
// ok: (m,) bool; all on the device, S and out 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int qd_inverse_launch(const float* S, float* out, unsigned char* ok, int m, int np_,
                                 int nd, void* stream) {
  return launch<float>(S, out, ok, m, np_, nd, stream);
}
extern "C" int qd_inverse_launch_f64(const double* S, double* out, unsigned char* ok, int m,
                                     int np_, int nd, void* stream) {
  return launch<double>(S, out, ok, m, np_, nd, stream);
}

#ifdef BLOCK_CHOL_CLOCKS
// The 2 x kClockSlots cycle counters of block_chol.cuh to the host / back to
// zero.
extern "C" int qd_inverse_read_clocks(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, block_chol::g_clocks, sizeof(block_chol::g_clocks));
}
extern "C" int qd_inverse_zero_clocks() {
  const long long zeros[2 * block_chol::kClockSlots] = {};
  return (int)cudaMemcpyToSymbol(block_chol::g_clocks, zeros, sizeof(zeros));
}
#endif
