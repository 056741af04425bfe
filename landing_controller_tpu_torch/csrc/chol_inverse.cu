// Batched inverse of symmetric positive definite blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chol_inverse_kernel`
// (landing_controller_tpu/ops/pallas_blocks.py:137, wrapper `chol_inverse`
// :272).  For each instance A (n x n, symmetric positive definite; only the
// lower triangle is read) it computes A = L L' by a right-looking Cholesky,
// A^-1 = L^-T L^-1 from the factor, and the flag ok = min(pivots) > 0, where
// a non-finite pivot counts as a failure.  Pivots follow the TPU kernel's
// rule: rsqrt(max(d, 1e-30)), continuing past bad pivots, so the output is
// computed even when ok is false, and a positive pivot below the clamp
// passes the test while the clamped factor overflows.
//
// Design: one thread block per instance.  A is loaded into shared memory
// once (coalesced: each instance is a contiguous n*n run), factored in
// place, inverted column by column into a second shared buffer, and the
// full symmetric inverse is written once.  The factorization and the
// inverse-from-factor are the device functions of block_chol.cuh, shared
// with qd_inverse.cu.  The TPU version's 128-lane batch layout and its
// identity padding are not carried over: the batch is the grid.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor cores): an
// instance reads and writes 2 * 4 n^2 bytes and does ~n^3 operations
// (n^3/3 for the factor, 2 n^3/3 for the inverse).  At n = 48, m = 5120:
// 94 MB (0.028 ms) against 0.57 GFLOP (0.008 ms): bound by bytes.  This
// first version is simple: the column solves use one thread per column
// (at most n of the block's 128 threads) and the Cholesky synchronizes the
// block three times per column.
//
// Plain C interface (bound from Python with ctypes): the wrapper passes
// device pointers and the CUDA stream, and raises on a nonzero return.

#include <cuda_runtime.h>
#include <math.h>

#include "block_chol.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void chol_inverse_kernel(const float* __restrict__ A_all, float* __restrict__ out_all,
                                    unsigned char* __restrict__ ok_all, int n) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const long long inst = blockIdx.x;
  const float* A_g = A_all + inst * n * n;
  float* out = out_all + inst * n * n;

  float* A = smem;      // n*n: the block; its lower triangle becomes L
  float* X = A + n * n; // n*n: the inverse, column by column
  __shared__ float min_piv;
  __shared__ int bad;

  for (int e = tid; e < n * n; e += blockDim.x) A[e] = A_g[e];
  if (tid == 0) {
    min_piv = INFINITY;
    bad = 0;
  }
  __syncthreads();

  block_chol::chol_inplace(A, n, n, &min_piv, &bad);
  block_chol::chol_to_inverse(A, n, n, X);

  // the column solves agree across the diagonal up to rounding: write the
  // symmetric mean
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    out[e] = 0.5f * (X[i * n + j] + X[j * n + i]);
  }
  if (tid == 0) ok_all[inst] = (!bad && min_piv > 0.0f) ? 1 : 0;
}

}  // namespace

extern "C" size_t chol_inverse_smem_bytes(int n) { return sizeof(float) * (size_t)(2 * n * n); }

// A: (m, n, n) f32, out: (m, n, n) f32, ok: (m,) bool; all on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chol_inverse_launch(const float* A, float* out, unsigned char* ok, int m, int n,
                                   void* stream) {
  if (m <= 0) return 0;
  const size_t smem = chol_inverse_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  chol_inverse_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(A, out, ok, n);
  return (int)cudaGetLastError();
}
