// Inverse of one quasi-definite (or positive definite) matrix by one thread
// block, in shared memory: the design shared by qd_inverse.cu and
// chol_inverse.cu.
//
// A block S = [[P, B'], [B, -D]] (P: np x np, D: nd x nd, both positive
// definite) is factored as S = L J L' with J = diag(+1 (np times), -1 (nd
// times)): a Cholesky whose pivot d_j = J_j * (trailing diagonal) is positive
// in both parts.  The columns below np are exactly the Cholesky of the Schur
// complement D + B P^-1 B', so the pivots are those of the two-Cholesky
// scheme, and with M = L^-1
//     S^-1 = M' J M = [[Pinv - E W E', E W], [W E', -W]].
// A positive definite matrix is the case nd = 0.  Only the lower triangle of
// S is read.  Pivots follow the TPU kernels' rule
// (landing_controller_tpu/ops/pallas_blocks.py:83-90): rsqrt(max(d, 1e-30)),
// carrying on past a bad pivot, the least pivot and a non-finite flag folded
// for the caller's test ok = (least pivot > 0 and all finite).
//
// Steps (n = the size rounded up to a multiple of 4, identity padding):
//  1. load: 16-byte accesses when the row length is a multiple of 4;
//  2. factor by panels of kPanel = 8 columns (the last may be 4 wide):
//     a. warp 0 takes the diagonal tile: every lane reads its lower triangle
//        into registers and factors it alone (36 values; no shuffle and no
//        barrier inside the pivot chain, one rsqrt instruction per pivot),
//        lane c then solves for column c of the inverse X, which goes in the
//        tile's place with zeros above the diagonal;
//     b. every thread takes one row r below the tile: L21[r] = A21[r] X' J
//        goes transposed into a kPanel x n scratch for the update, and
//        T21[r] = L21[r] X goes in the place of A21[r], because step 3 needs
//        L21 only as that product;
//     c. the trailing lower triangle takes the rank-8 update, one 4x4
//        register tile per thread from float4 reads of the scratch (two
//        loads feed sixteen FMAs); warp 0 updates only the next diagonal
//        tile (one element per lane) and goes on to step a for it while the
//        other warps update the rest, so the longest serial chain of the
//        kernel runs beside its widest product;
//  3. M = L^-1 in place, panels from the last to the first: M21 = -M22 T21,
//     one 1x4 strip per thread from float4 reads, held in registers over a
//     barrier and then written;
//  4. the lower triangle of M' J M, one 4x4 register tile per thread from
//     float4 reads of M's rows, written to device memory with its mirror
//     image by 16-byte stores: the output is symmetric bit for bit.
// Two barriers per panel in step 2 and two in step 3 (42 in all at 84 wide,
// where a column-at-a-time factorization took 252), no atomics, no reduction
// whose order depends on timing.
//
// Shared-memory banks: a row stride that is a multiple of 4 and leaves 4
// modulo 8 (60, 76, 84 as they are, 36, 52 for 48) puts the float4 accesses
// of 8 consecutive rows (a quarter warp) into 8 distinct groups of 4 banks,
// which steps 2b and 3 need; steps 2c and 4 read one row at a time, where
// the lanes of a quarter warp share the first operand's address and take
// consecutive float4 of the second.
//
// The scalar type T is float or double; the float instance is the design
// above, and the double instance runs the same steps on 8-byte words.  Its
// four-value accesses are 32 bytes, moved as two 16-byte halves, and the
// pivots take a correctly rounded 1 / sqrt and division in place of the
// one-instruction approximations, with the same 1e-30 clamp and ok rule.  It
// gives up the bank argument: a row of ld doubles spans 2 ld banks, which
// leaves 8 modulo 16, so the 16-byte halves of 8 consecutive rows fall into
// 4 distinct groups of 4 banks, a two-way conflict in steps 2b and 3.  Its
// shared memory is twice the float instance's (smem_bytes<double>): above
// 48 KB at 84 wide, where block_chol::allow_smem raises the kernel's limit
// once per device.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifdef __CUDACC__
#include <atomic>
#endif

namespace block_chol {

constexpr int kPanel = 8;      // columns per panel
constexpr int kMaxBlock = 84;  // widest matrix
// Threads per block: 128, chosen by `python tests/probe_block_kernels.py`
// (which builds this header with other values of the two macros below) on an
// NVIDIA H100 80GB HBM3 (700 W), qd_inverse, CUDA events, median of 25, two
// turns:
//   threads   (36, 24) m = 128 (one wave)   (48, 36) m = 5120 (many waves)
//      64        0.0196 / 0.0195 ms            0.3233 / 0.3218 ms
//     128        0.0170 / 0.0169 ms            0.2712 / 0.2705 ms
//     256        0.0169 / 0.0167 ms            0.3216 / 0.3212 ms
// (64 threads are 8% faster at (36, 24), m = 1280 only: 13 blocks per SM hold
// that launch in one wave.)  The compiler gives 128 threads 72 registers, so
// 7 blocks per SM: registers, not shared memory, limit them.
#ifndef BLOCK_CHOL_THREADS
#define BLOCK_CHOL_THREADS 128
#endif
constexpr int kThreads = BLOCK_CHOL_THREADS;
// Blocks per SM that the compiler sizes the registers for (__launch_bounds__).
// 1 = no limit.  The same probe: 8 (64 registers) changes no time by more than
// 2%, 10 (48 registers, spills) costs 15% at (48, 36), m = 5120.
#ifndef BLOCK_CHOL_MIN_BLOCKS
#define BLOCK_CHOL_MIN_BLOCKS 1
#endif
constexpr int kMinBlocks = BLOCK_CHOL_MIN_BLOCKS;

// With -DBLOCK_CHOL_CLOCKS, threads 0 (warp 0) and 32 of block 0 add the
// clock cycles they spend in each phase of inverse_block, and before each of
// its barriers, into g_clocks[thread / 32][slot]: what a profiler cannot say
// of the inside of a kernel (`python tests/probe_block_kernels.py --clocks`
// prints them; tests/test_torch_kernel_on_cpu.py builds this variant too).
constexpr int kClockSlots = 13;  // BLOCK_CHOL_STAMP(0) ... (12)
#ifdef BLOCK_CHOL_CLOCKS
__device__ long long g_clocks[2][kClockSlots];
#define BLOCK_CHOL_STAMP(slot)                                      \
  do {                                                              \
    if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 32)) { \
      const long long now_ = clock64();                             \
      g_clocks[threadIdx.x / 32][slot] += now_ - stamp_;            \
      stamp_ = now_;                                                \
    }                                                               \
  } while (0)
#else
#define BLOCK_CHOL_STAMP(slot)
#endif
static_assert(kThreads >= 64 && kThreads % 32 == 0, "warp 0 and at least one more warp");

__host__ __device__ constexpr int padded_size(int bs) { return (bs + 3) / 4 * 4; }
__host__ __device__ constexpr int row_stride(int bs) {
  return padded_size(bs) % 8 == 0 ? padded_size(bs) + 4 : padded_size(bs);
}
__host__ __device__ constexpr int num_tiles(int bs) {
  return (padded_size(bs) / 4) * (padded_size(bs) / 4 + 1) / 2;
}
// entries of the table of lower-triangle positions: one per 4x4 tile, and at
// least one per element of a diagonal tile's lower triangle
__host__ __device__ constexpr int table_entries(int bs) {
  return num_tiles(bs) > kPanel * (kPanel + 1) / 2 ? num_tiles(bs) : kPanel * (kPanel + 1) / 2;
}
// the matrix, the kPanel x n scratch (T: float or double), the table
template <typename T = float>
__host__ __device__ constexpr size_t smem_bytes(int bs) {
  return sizeof(T) * (size_t)(padded_size(bs) * row_stride(bs) + kPanel * padded_size(bs)) +
         (size_t)((2 * table_entries(bs) + 15) / 16 * 16);
}

// Four consecutive values of a row: float4 for float; for double a 32-byte
// struct at 16-byte alignment, which the compiler moves as two 16-byte
// accesses.
struct alignas(16) dvec4 {
  double x, y, z, w;
};
template <typename T>
struct Vec4Of;
template <>
struct Vec4Of<float> {
  using type = float4;
};
template <>
struct Vec4Of<double> {
  using type = dvec4;
};
template <typename T>
using vec4 = typename Vec4Of<T>::type;

__device__ __forceinline__ float4 make_vec4(float x, float y, float z, float w) {
  return make_float4(x, y, z, w);
}
__device__ __forceinline__ dvec4 make_vec4(double x, double y, double z, double w) {
  return dvec4{x, y, z, w};
}

template <typename T>
__device__ __forceinline__ vec4<T> ld4(const T* p) {
  return *reinterpret_cast<const vec4<T>*>(p);
}
template <typename T>
__device__ __forceinline__ void st4(T* p, vec4<T> v) {
  *reinterpret_cast<vec4<T>*>(p) = v;
}
// a 16-byte aligned row segment of the instance in device memory
__device__ __forceinline__ float4 ld4_global(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ dvec4 ld4_global(const double* p) { return ld4(p); }

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// Reciprocal square root and reciprocal of a pivot.  float: one instruction
// each (about 1 ulp; inputs below the normal range count as 0, which the
// 1e-30 pivot clamp never is).  double: correctly rounded square root and
// division, no approximate instruction.
__device__ __forceinline__ float pivot_rsqrt(float x) {
#ifdef __CUDACC__
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / sqrtf(x);
#endif
}
__device__ __forceinline__ float pivot_rcp(float x) {
#ifdef __CUDACC__
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / x;
#endif
}
__device__ __forceinline__ double pivot_rsqrt(double x) { return 1.0 / sqrt(x); }
__device__ __forceinline__ double pivot_rcp(double x) { return 1.0 / x; }

// acc (+/-)= a b' for a 4x4 register tile
template <typename T>
__device__ __forceinline__ void outer_add(T (&acc)[4][4], vec4<T> a, vec4<T> b) {
  const T av[4] = {a.x, a.y, a.z, a.w};
  const T bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = madd(av[i], bv[j], acc[i][j]);
}
template <typename T>
__device__ __forceinline__ void outer_sub(T (&acc)[4][4], vec4<T> a, vec4<T> b) {
  outer_add<T>(acc, make_vec4(-a.x, -a.y, -a.z, -a.w), b);
}

// Step 2a, called by warp 0: the KB x KB diagonal tile at (k0, k0) becomes
// the inverse of its signed Cholesky factor; the pivots fold into min_piv and
// bad (the same values in every lane).  Every lane takes the tile's lower
// triangle into registers and factors it alone, so no step of the pivot chain
// waits for a shuffle; lane c then solves for column c of the inverse.
template <int KB, typename T>
__device__ __forceinline__ void diag_tile(T* A, int ld, int k0, int np, T& min_piv, int& bad) {
  const int lane = threadIdx.x & 31;
  T a[KB][KB];  // the lower triangle: a[i][k], k <= i
#pragma unroll
  for (int i = 0; i < KB; ++i)
#pragma unroll
    for (int q = 0; q <= i / 4; ++q) {
      const vec4<T> v = ld4(A + (k0 + i) * ld + k0 + 4 * q);
      a[i][4 * q] = v.x, a[i][4 * q + 1] = v.y, a[i][4 * q + 2] = v.z, a[i][4 * q + 3] = v.w;
    }
  T rinv[KB];  // 1 / L_jj
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const T sg = (k0 + j < np) ? T(1) : T(-1);
    const T d = sg * a[j][j];
    if (!isfinite(d)) bad = 1;
    min_piv = vmin(min_piv, d);
    const T s = pivot_rsqrt(vmax(d, T(1e-30)));
    rinv[j] = pivot_rcp(d * s);
    const T ss = sg * s;
#pragma unroll
    for (int i = j; i < KB; ++i) a[i][j] *= ss;  // L[i][j]
#pragma unroll
    for (int i = j + 1; i < KB; ++i) {
      const T nl = -sg * a[i][j];
#pragma unroll
      for (int k = j + 1; k <= i; ++k) a[i][k] = madd(nl, a[k][j], a[i][k]);
    }
  }
  // lane c solves L x = e_c: column c of X = L^-1
  const int c = lane % KB;  // lanes >= KB repeat columns and store nothing
  T x[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    T acc = (i == c) ? T(1) : T(0);
#pragma unroll
    for (int k = 0; k < i; ++k) acc = madd(-a[i][k], x[k], acc);
    x[i] = (i < c) ? T(0) : acc * rinv[i];
  }
  __syncwarp();  // every lane has read the tile before any lane overwrites it
  if (lane < KB) {
#pragma unroll
    for (int i = 0; i < KB; ++i) A[(k0 + i) * ld + k0 + lane] = x[i];
  }
}

// Step 2c for the next diagonal tile alone, called by warp 0: the lower
// triangle of the KB x KB tile at (r0, r0) takes A -= L21 J L21', one element
// per lane and turn (tri[e] is also the e-th element of a lower triangle).
template <int KB, typename T>
__device__ __forceinline__ void diag_update(T* A, const T* Lt, const uchar2* tri, int ld, int n,
                                            int k0, int r0, int np) {
  for (int e = threadIdx.x & 31; e < KB * (KB + 1) / 2; e += 32) {
    const uchar2 ij = tri[e];
    const T* li = Lt + r0 + ij.x;
    const T* lj = Lt + r0 + ij.y;
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      const T p = li[c * n] * lj[c * n];
      acc += (k0 + c < np) ? p : -p;
    }
    A[(r0 + ij.x) * ld + r0 + ij.y] -= acc;
  }
}

// Step 2b: for every row r >= k0 + KB, L21[r] = A21[r] X' J into
// Lt[c * n + r] and T21[r] = L21[r] X in the place of A21[r].
template <int KB, typename T>
__device__ __forceinline__ void panel_solve(T* A, T* Lt, int ld, int n, int k0, int np) {
  const int r_first = k0 + KB + threadIdx.x;
  if (r_first >= n) return;
  T X[KB][KB];
#pragma unroll
  for (int c = 0; c < KB; ++c)
#pragma unroll
    for (int q = 0; q < KB / 4; ++q) {
      const vec4<T> v = ld4(A + (k0 + c) * ld + k0 + 4 * q);
      X[c][4 * q] = v.x, X[c][4 * q + 1] = v.y, X[c][4 * q + 2] = v.z, X[c][4 * q + 3] = v.w;
    }
  for (int r = r_first; r < n; r += kThreads) {
    T av[KB], l[KB], t[KB];
#pragma unroll
    for (int q = 0; q < KB / 4; ++q) {
      const vec4<T> v = ld4(A + r * ld + k0 + 4 * q);
      av[4 * q] = v.x, av[4 * q + 1] = v.y, av[4 * q + 2] = v.z, av[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k <= c; ++k) acc = madd(av[k], X[c][k], acc);
      l[c] = (k0 + c < np) ? acc : -acc;
      Lt[c * n + r] = l[c];
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      T acc = T(0);
#pragma unroll
      for (int k = c; k < KB; ++k) acc = madd(l[k], X[k][c], acc);
      t[c] = acc;
    }
#pragma unroll
    for (int q = 0; q < KB / 4; ++q)
      st4(A + r * ld + k0 + 4 * q, make_vec4(t[4 * q], t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]));
  }
}

// Step 2c: A22 -= L21 J L21' on the lower triangle from row r0 = k0 + KB,
// the tiles t_first, t_first + t_step, ... of that triangle.
template <int KB, typename T>
__device__ __forceinline__ void trailing_update(T* A, const T* Lt, const uchar2* tri, int ld, int n,
                                                int k0, int np, int t_first, int t_step) {
  const int t0 = (k0 + KB) / 4;
  const int nt = n / 4 - t0;
  const int count = nt * (nt + 1) / 2;
  for (int t = t_first; t < count; t += t_step) {
    const uchar2 ij = tri[t];
    const int i0 = 4 * (t0 + ij.x), j0 = 4 * (t0 + ij.y);
    T acc[4][4] = {};
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      const vec4<T> a = ld4(Lt + c * n + i0);
      const vec4<T> b = ld4(Lt + c * n + j0);
      if (k0 + c < np) outer_add<T>(acc, a, b);
      else outer_sub<T>(acc, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T* p = A + (i0 + i) * ld + j0;
      vec4<T> v = ld4(p);
      v.x -= acc[i][0], v.y -= acc[i][1], v.z -= acc[i][2], v.w -= acc[i][3];
      st4(p, v);
    }
  }
}

// Inverse of the instance S_g (bs x bs, contiguous) into out, its flag into
// *ok.  BS_T > 0 fixes bs = BS_T and np = NP_T at compile time; BS_T = 0
// takes them at run time.  np: the number of leading positive columns (at
// least the padded size for a positive definite matrix).  Called by every
// thread of a block of kThreads threads with smem_bytes<T>(bs) of 16-byte
// aligned shared memory.
template <int BS_T, int NP_T, typename T>
__device__ __forceinline__ void inverse_block(const T* __restrict__ S_g, T* __restrict__ out,
                                              unsigned char* __restrict__ ok, int bs_rt,
                                              int np_rt, T* smem) {
  const int bs = BS_T ? BS_T : bs_rt;
  const int np = BS_T ? NP_T : np_rt;
  const int n = padded_size(bs);
  const int ld = row_stride(bs);
  const int nt = n / 4;
  const int tid = threadIdx.x;
  constexpr int kMaxN = BS_T ? padded_size(BS_T) : kMaxBlock;
  // 1x4 strips of the widest M21 (kMaxN - kPanel rows) per thread in step 3
  constexpr int kStrips = (2 * (kMaxN - kPanel) + kThreads - 1) / kThreads;

#ifdef BLOCK_CHOL_CLOCKS
  long long stamp_ = clock64();
#endif
  T* A = smem;
  T* Lt = A + n * ld;
  uchar2* tri = reinterpret_cast<uchar2*>(Lt + kPanel * n);

  // ---- 1. load; table: entry t is the t-th (row, column) of a lower
  // triangle counted row by row, the same for every triangle size
  if (bs % 4 == 0) {
    const int q = bs / 4;
    for (int e = tid; e < bs * q; e += kThreads) {
      const int r = e / q, c = e - r * q;
      st4(A + r * ld + 4 * c, ld4_global(S_g + 4 * e));
    }
  } else {
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = e / n, c = e - r * n;
      T v = (r == c) ? ((r < np) ? T(1) : T(-1)) : T(0);  // identity padding
      if (r < bs && c < bs) v = S_g[r * bs + c];
      A[r * ld + c] = v;
    }
  }
  for (int t = tid; t < table_entries(bs); t += kThreads) {
    int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
    while ((i + 1) * (i + 2) / 2 <= t) ++i;
    while (i * (i + 1) / 2 > t) --i;
    tri[t] = make_uchar2((unsigned char)i, (unsigned char)(t - i * (i + 1) / 2));
  }
  BLOCK_CHOL_STAMP(0);  // load
  __syncthreads();
  BLOCK_CHOL_STAMP(1);

  // ---- 2. signed Cholesky by panels.  Warp 0 owns the diagonal tiles: in
  // step c it updates only the next diagonal tile (which the first three 4x4
  // tiles of the trailing triangle cover; the other warps start at the
  // fourth), then factors and inverts it while they update the rest.
  T min_piv = INFINITY;
  int bad = 0;
  const bool warp0 = tid < 32;
  if (warp0) {
    if (n >= kPanel) diag_tile<8>(A, ld, 0, np, min_piv, bad);
    else diag_tile<4>(A, ld, 0, np, min_piv, bad);
  }
  BLOCK_CHOL_STAMP(2);  // first diagonal tile
  __syncthreads();
  BLOCK_CHOL_STAMP(3);
  for (int k0 = 0; k0 + kPanel < n; k0 += kPanel) {
    panel_solve<8>(A, Lt, ld, n, k0, np);
    BLOCK_CHOL_STAMP(4);  // panels
    __syncthreads();
    BLOCK_CHOL_STAMP(5);
    if (warp0) {
      const int r0 = k0 + kPanel;
      if (n - r0 >= kPanel) {
        diag_update<8>(A, Lt, tri, ld, n, k0, r0, np);
        __syncwarp();
        diag_tile<8>(A, ld, r0, np, min_piv, bad);
      } else {
        diag_update<4>(A, Lt, tri, ld, n, k0, r0, np);
        __syncwarp();
        diag_tile<4>(A, ld, r0, np, min_piv, bad);
      }
    } else {
      trailing_update<8>(A, Lt, tri, ld, n, k0, np, 3 + tid - 32, kThreads - 32);
    }
    BLOCK_CHOL_STAMP(6);  // next diagonal tile (warp 0) / trailing update
    __syncthreads();
    BLOCK_CHOL_STAMP(7);
  }

  // ---- 3. M = L^-1: M21 = -M22 T21, panels from the last to the first.
  // Row i of M22 ends at column i; the four values that hold it end inside the
  // diagonal tile, where step 2a stored zeros above the diagonal.
  const int k_last = (n - 1) / kPanel * kPanel;
  for (int k0 = k_last - kPanel; k0 >= 0; k0 -= kPanel) {
    const int r0 = k0 + kPanel;
    const int count = 2 * (n - r0);
    vec4<T> res[kStrips];
#pragma unroll
    for (int it = 0; it < kStrips; ++it) {
      const int e = tid + it * kThreads;
      vec4<T> acc = make_vec4(T(0), T(0), T(0), T(0));
      if (e < count) {
        const int i = r0 + (e >> 1);
        const T* tcol = A + k0 + 4 * (e & 1);
        const T* mrow = A + i * ld;
#pragma unroll 2
        for (int k = r0; k <= i; k += 4) {
          const vec4<T> m = ld4(mrow + k);
          const vec4<T> t0 = ld4(tcol + k * ld), t1 = ld4(tcol + (k + 1) * ld);
          const vec4<T> t2 = ld4(tcol + (k + 2) * ld), t3 = ld4(tcol + (k + 3) * ld);
          acc.x -= m.x * t0.x + m.y * t1.x + m.z * t2.x + m.w * t3.x;
          acc.y -= m.x * t0.y + m.y * t1.y + m.z * t2.y + m.w * t3.y;
          acc.z -= m.x * t0.z + m.y * t1.z + m.z * t2.z + m.w * t3.z;
          acc.w -= m.x * t0.w + m.y * t1.w + m.z * t2.w + m.w * t3.w;
        }
      }
      res[it] = acc;
    }
    BLOCK_CHOL_STAMP(8);  // M21 products
    __syncthreads();
    BLOCK_CHOL_STAMP(9);
#pragma unroll
    for (int it = 0; it < kStrips; ++it) {
      const int e = tid + it * kThreads;
      if (e < count) st4(A + (r0 + (e >> 1)) * ld + k0 + 4 * (e & 1), res[it]);
    }
    BLOCK_CHOL_STAMP(10);  // M21 stores
    __syncthreads();
    BLOCK_CHOL_STAMP(11);
  }

  // ---- 4. the lower triangle of M' J M, written with its mirror image
  const int k_neg = np < n ? np : n;  // first negative column
  for (int t = tid; t < nt * (nt + 1) / 2; t += kThreads) {
    const uchar2 ij = tri[t];
    const int i0 = 4 * ij.x, j0 = 4 * ij.y;  // i0 >= j0
    T acc[4][4] = {};
    const int k_mid = i0 > k_neg ? i0 : k_neg;
#pragma unroll 4
    for (int k = i0; k < k_mid; ++k) outer_add<T>(acc, ld4(A + k * ld + i0), ld4(A + k * ld + j0));
#pragma unroll 4
    for (int k = k_mid; k < n; ++k) outer_sub<T>(acc, ld4(A + k * ld + i0), ld4(A + k * ld + j0));
    if (i0 == j0) {  // one value for both sides of the diagonal
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = i + 1; j < 4; ++j) acc[i][j] = acc[j][i];
    }
    if (bs % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(out + (i0 + i) * bs + j0, make_vec4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      if (i0 != j0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st4(out + (j0 + j) * bs + i0, make_vec4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i0 + i < bs && j0 + j < bs) {
            out[(i0 + i) * bs + j0 + j] = acc[i][j];
            out[(j0 + j) * bs + i0 + i] = acc[i][j];
          }
    }
  }
  BLOCK_CHOL_STAMP(12);  // product and stores
  if (tid == 0) *ok = (!bad && min_piv > T(0)) ? 1 : 0;
}

#ifdef __CUDACC__
// Host side of the launchers in qd_inverse.cu and chol_inverse.cu, for one
// kernel instance `kernel` whose scalar type is T.

constexpr int kMaxDevices = 64;

// Lets `kernel` take the shared memory of the widest block,
// smem_bytes<T>(kMaxBlock), where that is above the default 48 KB (the
// double instances): set at the first call on each device and remembered.
template <typename T, auto kernel>
cudaError_t allow_smem() {
  constexpr size_t kMax = smem_bytes<T>(kMaxBlock);
  if constexpr (kMax <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static std::atomic<bool> raised[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (raised[dev].load()) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMax);
    if (err == cudaSuccess) raised[dev].store(true);
    return err;
  }
}

// Blocks of `kernel` that one SM holds at a time with `smem` bytes each, or
// the negated cudaError_t.
template <typename T, auto kernel>
int blocks_per_sm(size_t smem) {
  cudaError_t err = allow_smem<T, kernel>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches `kernel` on m blocks of kThreads threads with `smem` bytes each;
// returns the cudaError_t of the launch.
template <typename T, auto kernel, typename... Args>
int launch(int m, size_t smem, void* stream, Args... args) {
  cudaError_t err = allow_smem<T, kernel>();
  if (err != cudaSuccess) return (int)err;
  kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace block_chol
