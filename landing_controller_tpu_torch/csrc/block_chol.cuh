// Block-wide Cholesky factorization and inverse-from-factor in shared memory.
//
// Device functions shared by the port's block-inverse kernels
// (qd_inverse.cu, chol_inverse.cu).  Every thread of the block calls them
// together; they synchronize the block themselves.  Pivots follow the TPU
// kernels' rule (landing_controller_tpu/ops/pallas_blocks.py:83-90):
// rsqrt(max(d, 1e-30)), continuing past bad pivots, with the least pivot and
// a non-finite-pivot flag folded into shared variables for the caller's
// inertia test.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace block_chol {

// In-place right-looking Cholesky of the n x n lower triangle of A (row
// stride ld).  Thread 0 folds each pivot into *min_piv / *bad.
__device__ inline void chol_inplace(float* A, int n, int ld, float* min_piv, int* bad) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    const float d = A[j * ld + j];
    if (tid == 0) {
      if (!isfinite(d)) *bad = 1;
      *min_piv = fminf(*min_piv, d);
    }
    const float inv_sq = rsqrtf(fmaxf(d, 1e-30f));
    __syncthreads();
    for (int i = j + tid; i < n; i += blockDim.x) A[i * ld + j] *= inv_sq;
    __syncthreads();
    const int r = n - j - 1;
    for (int e = tid; e < r * r; e += blockDim.x) {
      const int i = j + 1 + e / r;
      const int k = j + 1 + e % r;
      if (k <= i) A[i * ld + k] -= A[i * ld + j] * A[k * ld + j];
    }
  }
  __syncthreads();
}

// X = (L L')^-1 from the lower factor L (stride ld) into X (n x n, stride
// n): thread c solves L y = e_c then L' x = y in column c of X.
__device__ inline void chol_to_inverse(const float* L, int n, int ld, float* X) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    for (int i = 0; i < n; ++i) {
      float s = (i == c) ? 1.0f : 0.0f;
      for (int k = c; k < i; ++k) s -= L[i * ld + k] * X[k * n + c];
      X[i * n + c] = (i < c) ? 0.0f : s / L[i * ld + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = X[i * n + c];
      for (int k = i + 1; k < n; ++k) s -= L[k * ld + i] * X[k * n + c];
      X[i * n + c] = s / L[i * ld + i];
    }
  }
  __syncthreads();
}

}  // namespace block_chol
