// Batched inverse of symmetric positive definite blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chol_inverse_kernel`
// (landing_controller_tpu/ops/pallas_blocks.py:137, wrapper `chol_inverse`
// :272).  For each instance A (n x n, symmetric positive definite; only the
// lower triangle is read) it computes A = L L', A^-1 = L^-T L^-1 and the
// flag ok = min(pivots) > 0, where a non-finite pivot counts as a failure.
// Pivots follow the TPU kernel's rule: rsqrt(max(d, 1e-30)), continuing past
// bad pivots, so the output is written even when ok is false, and a positive
// pivot below the clamp passes the test while the clamped factor overflows.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): an instance reads and writes 8 n^2 bytes and does about n^3
// operations (n^3/3 each for the factor, its inverse and the product).  At
// n = 48, m = 5120: 94 MB (0.028 ms) against 0.57 GFLOP (0.008 ms): bound by
// bytes; a single wave of blocks is bound by the latency of one instance.
//
// Design: one thread block per instance, the batch is the grid; the
// computation is the device function of block_chol.cuh, shared with
// qd_inverse.cu, with every column positive: Cholesky by panels of 8 columns
// (diagonal tiles factored and inverted by one warp in registers), L^-1
// formed in place by small products, and the lower triangle of L^-T L^-1
// stored with its mirror image, so the output is symmetric bit for bit.
// Shared memory holds A once (plus an 8 x n scratch): 11.7 KB at n = 48; 7
// blocks of 128 threads stay on an SM, limited by their registers.
// n = 36 and n = 48 are compile-time instances; any other n up to 84 goes
// through the instance with a run-time size.  Each is built for f32 and for
// f64 (twice the shared memory, 23.2 KB at n = 48; twice the byte bound).
//
// Plain C interface (bound from Python with ctypes): the wrapper passes
// device pointers and the CUDA stream, and raises on a nonzero return.

#include <cuda_runtime.h>

#include "block_chol.cuh"

namespace {

template <typename T, int N_T>
__global__ void __launch_bounds__(block_chol::kThreads, block_chol::kMinBlocks)
    chol_inverse_kernel(const T* __restrict__ A_all, T* __restrict__ out_all,
                        unsigned char* __restrict__ ok_all, int n_rt) {
  extern __shared__ float4 smem4[];
  const int n = N_T ? N_T : n_rt;
  const size_t offset = (size_t)blockIdx.x * n * n;
  // every column positive: np covers the padding too
  block_chol::inverse_block<N_T, block_chol::padded_size(N_T)>(
      A_all + offset, out_all + offset, ok_all + blockIdx.x, n, block_chol::padded_size(n),
      reinterpret_cast<T*>(smem4));
}

template <typename T>
int blocks_per_sm(int n) {
  const size_t smem = block_chol::smem_bytes<T>(n);
  if (n == 36) return block_chol::blocks_per_sm<T, chol_inverse_kernel<T, 36>>(smem);
  if (n == 48) return block_chol::blocks_per_sm<T, chol_inverse_kernel<T, 48>>(smem);
  return block_chol::blocks_per_sm<T, chol_inverse_kernel<T, 0>>(smem);
}

template <typename T>
int launch(const T* A, T* out, unsigned char* ok, int m, int n, void* stream) {
  if (m <= 0) return 0;
  if (n < 1 || n > block_chol::kMaxBlock) return (int)cudaErrorInvalidValue;
  const size_t smem = block_chol::smem_bytes<T>(n);
  if (n == 36)
    return block_chol::launch<T, chol_inverse_kernel<T, 36>>(
        m, smem, stream, A, out, ok, n);
  if (n == 48)
    return block_chol::launch<T, chol_inverse_kernel<T, 48>>(
        m, smem, stream, A, out, ok, n);
  return block_chol::launch<T, chol_inverse_kernel<T, 0>>(m, smem, stream, A, out, ok, n);
}

}  // namespace

// Dynamic shared memory of one block of the f32 / f64 instance for n.
extern "C" size_t chol_inverse_smem_bytes(int n) { return block_chol::smem_bytes<float>(n); }
extern "C" size_t chol_inverse_smem_bytes_f64(int n) { return block_chol::smem_bytes<double>(n); }

// Blocks of the instance for n that one SM holds at a time, or the negated
// cudaError_t.
extern "C" int chol_inverse_blocks_per_sm(int n) { return blocks_per_sm<float>(n); }
extern "C" int chol_inverse_blocks_per_sm_f64(int n) { return blocks_per_sm<double>(n); }

// A: (m, n, n), out: (m, n, n), both f32 (f64 for the _f64 entry), ok: (m,)
// bool; all on the device, A and out 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int chol_inverse_launch(const float* A, float* out, unsigned char* ok, int m, int n,
                                   void* stream) {
  return launch<float>(A, out, ok, m, n, stream);
}
extern "C" int chol_inverse_launch_f64(const double* A, double* out, unsigned char* ok, int m,
                                       int n, void* stream) {
  return launch<double>(A, out, ok, m, n, stream);
}
