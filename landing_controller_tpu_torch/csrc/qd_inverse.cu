// Batched inverse of quasi-definite KKT blocks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_qd_inverse_kernel`
// (landing_controller_tpu/ops/pallas_blocks.py:111, wrapper `qd_inverse`
// :154).  For each instance S = [[P, B'], [B, -D]] (P: np x np, D: nd x nd,
// both positive definite) it computes, by two Choleskys and a Schur
// complement,
//     Pinv = P^-1,  E = Pinv B',  W = (D + B E)^-1,
//     Sinv = [[Pinv - E W E', E W], [W E', -W]],
// and the inertia flag ok = min(pivots of P and of D + B E) > 0, where a
// non-finite pivot counts as a failure.  Pivots follow the TPU kernel's
// rule: rsqrt(max(d, 1e-30)), continuing past bad pivots, so every output is
// computed even when ok is false.
//
// Design: one thread block per instance.  S is loaded into shared memory
// once (coalesced: each instance is a contiguous bs*bs run), every
// intermediate (L_P, Pinv, E, L_Dt, W, E W) stays in shared memory, and
// Sinv is written once.  The TPU version's 128-lane batch layout and its
// identity padding are not carried over: the batch is the grid.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor cores): at
// (np, nd) = (36, 24) an instance reads 14.4 KB and writes 14.4 KB and does
// ~0.27 MFLOP, so the largest level of the srbm_lcp bench path (m = 1280)
// moves ~37 MB (~11 us) against ~0.34 GFLOP (~5 us): bound by bytes.  The
// smaller levels (m = 640 .. 128) are bound by launch latency.  This first
// version is simple: triangular solves use one thread per column and the
// Choleskys synchronize the block three times per column.
//
// Plain C interface (bound from Python with ctypes): the wrapper passes
// device pointers and the CUDA stream, and raises on a nonzero return.

#include <cuda_runtime.h>
#include <math.h>

#include "block_chol.cuh"

namespace {

using block_chol::chol_inplace;
using block_chol::chol_to_inverse;

constexpr int kThreads = 128;

__global__ void qd_inverse_kernel(const float* __restrict__ S_all, float* __restrict__ out_all,
                                  unsigned char* __restrict__ ok_all, int np_, int nd) {
  extern __shared__ float smem[];
  const int bs = np_ + nd;
  const int tid = threadIdx.x;
  const long long inst = blockIdx.x;
  const float* S_g = S_all + inst * bs * bs;
  float* out = out_all + inst * bs * bs;

  float* S = smem;                  // bs*bs: the block; P's triangle becomes L_P
  float* Pinv = S + bs * bs;        // np*np
  float* E = Pinv + np_ * np_;      // np*nd
  float* Dt = E + np_ * nd;         // nd*nd: D + B E, then L_Dt
  float* W = Dt + nd * nd;          // nd*nd
  float* EW = W + nd * nd;          // np*nd
  __shared__ float min_piv;
  __shared__ int bad;

  for (int e = tid; e < bs * bs; e += blockDim.x) S[e] = S_g[e];
  if (tid == 0) {
    min_piv = INFINITY;
    bad = 0;
  }
  __syncthreads();

  // P = L_P L_P' in place, Pinv from the factor
  chol_inplace(S, np_, bs, &min_piv, &bad);
  chol_to_inverse(S, np_, bs, Pinv);

  // E = Pinv B'  (B is rows np.. of S, columns 0..np)
  for (int e = tid; e < np_ * nd; e += blockDim.x) {
    const int i = e / nd, j = e % nd;
    const float* brow = S + (np_ + j) * bs;
    float s = 0.0f;
    for (int k = 0; k < np_; ++k) s += Pinv[i * np_ + k] * brow[k];
    E[e] = s;
  }
  __syncthreads();

  // Dt = D + B E with D = -S[np:, np:]
  for (int e = tid; e < nd * nd; e += blockDim.x) {
    const int i = e / nd, j = e % nd;
    const float* brow = S + (np_ + i) * bs;
    float s = -S[(np_ + i) * bs + np_ + j];
    for (int k = 0; k < np_; ++k) s += brow[k] * E[k * nd + j];
    Dt[e] = s;
  }
  chol_inplace(Dt, nd, nd, &min_piv, &bad);
  chol_to_inverse(Dt, nd, nd, W);

  // EW = E W
  for (int e = tid; e < np_ * nd; e += blockDim.x) {
    const int i = e / nd, j = e % nd;
    float s = 0.0f;
    for (int k = 0; k < nd; ++k) s += E[i * nd + k] * W[k * nd + j];
    EW[e] = s;
  }
  __syncthreads();

  // Sinv = [[Pinv - EW E', EW], [EW', -W]]
  for (int e = tid; e < bs * bs; e += blockDim.x) {
    const int i = e / bs, j = e % bs;
    float v;
    if (i < np_ && j < np_) {
      float s = Pinv[i * np_ + j];
      for (int k = 0; k < nd; ++k) s -= EW[i * nd + k] * E[j * nd + k];
      v = s;
    } else if (i < np_) {
      v = EW[i * nd + (j - np_)];
    } else if (j < np_) {
      v = EW[j * nd + (i - np_)];
    } else {
      v = -W[(i - np_) * nd + (j - np_)];
    }
    out[e] = v;
  }
  if (tid == 0) ok_all[inst] = (!bad && min_piv > 0.0f) ? 1 : 0;
}

}  // namespace

extern "C" size_t qd_inverse_smem_bytes(int np_, int nd) {
  const int bs = np_ + nd;
  return sizeof(float) * (size_t)(bs * bs + np_ * np_ + 2 * np_ * nd + 2 * nd * nd);
}

// S: (m, bs, bs) f32, out: (m, bs, bs) f32, ok: (m,) bool; all on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int qd_inverse_launch(const float* S, float* out, unsigned char* ok, int m, int np_,
                                 int nd, void* stream) {
  if (m <= 0) return 0;
  const size_t smem = qd_inverse_smem_bytes(np_, nd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qd_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  qd_inverse_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(S, out, ok, np_, nd);
  return (int)cudaGetLastError();
}
