// Runs block_chol::inverse_block on the CPU, one OS thread per CUDA thread:
//   harness <m> <bs> <np> <compile-time instance: 0|1> <in.bin> <out.bin> [4|8]
// in.bin: m*bs*bs values of 4 bytes (f32, the default) or 8 (f64); out.bin:
// m*bs*bs values of the same type, then m flag bytes.  Built with
// -DBLOCK_CHOL_CLOCKS it also prints thread 0's counter of every phase.
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local Index threadIdx;
std::barrier<>* block_barrier;
std::barrier<>* warp_barrier[32];

#include "block_chol.cuh"

using namespace block_chol;

template <int BS_T, int NP_T, typename T>
void run(const T* S, T* out, unsigned char* ok, int m, int bs, int np) {
  std::vector<float4> smem(smem_bytes<T>(bs) / sizeof(float4));  // exact size: overruns show
  for (int inst = 0; inst < m; ++inst) {
    const size_t offset = (size_t)inst * bs * bs;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        inverse_block<BS_T, NP_T>(S + offset, out + offset, ok + inst, bs, np,
                                  reinterpret_cast<T*>(smem.data()));
      });
    for (auto& thread : threads) thread.join();
  }
}

template <typename T>
int run_file(int m, int bs, int np, int fixed, const char* in, const char* out_path) {
  std::vector<T> S((size_t)m * bs * bs), out(S.size(), T(-777));
  std::vector<unsigned char> ok(m);
  FILE* f = fopen(in, "rb");
  if (!f || fread(S.data(), sizeof(T), S.size(), f) != S.size()) return 3;
  fclose(f);
  if (!fixed) run<0, 0>(S.data(), out.data(), ok.data(), m, bs, np);
  else if (bs == 60 && np == 36) run<60, 36>(S.data(), out.data(), ok.data(), m, bs, np);
  else if (bs == 84 && np == 48) run<84, 48>(S.data(), out.data(), ok.data(), m, bs, np);
  else if (bs == 76 && np == 36) run<76, 36>(S.data(), out.data(), ok.data(), m, bs, np);
  else if (bs == 36 && np == 36) run<36, 36>(S.data(), out.data(), ok.data(), m, bs, np);
  else if (bs == 48 && np == 48) run<48, 48>(S.data(), out.data(), ok.data(), m, bs, np);
  else return 4;
  f = fopen(out_path, "wb");
  if (!f) return 5;
  fwrite(out.data(), sizeof(T), out.size(), f);
  fwrite(ok.data(), 1, ok.size(), f);
  fclose(f);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 7 && argc != 8) return 2;
  const int m = atoi(argv[1]), bs = atoi(argv[2]), np = atoi(argv[3]), fixed = atoi(argv[4]);
  const int itemsize = argc == 8 ? atoi(argv[7]) : 4;
  block_barrier = new std::barrier<>(kThreads);
  for (int w = 0; w < kThreads / 32; ++w) warp_barrier[w] = new std::barrier<>(32);
  int rc = itemsize == 8   ? run_file<double>(m, bs, np, fixed, argv[5], argv[6])
           : itemsize == 4 ? run_file<float>(m, bs, np, fixed, argv[5], argv[6])
                           : 2;
  if (rc != 0) return rc;
#ifdef BLOCK_CHOL_CLOCKS
  for (long long c : g_clocks[0]) printf("%lld\n", c);
#endif
  return 0;
}
