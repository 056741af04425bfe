// Native host-side runtime: scenario sampling pool + binary result log.
//
// The port's own copy of the scenario pool of the JAX package; the code
// below the includes is the same, so both builds draw the same scenarios
// from the same seed.  The device path is PyTorch/CUDA; this is the host
// runtime beside it: a multi-threaded scenario generator that keeps device
// batches fed without Python-side RNG overhead, and an append-only binary
// result log with CRC32 framing (the durable artifact store replacing the
// reference's -V7.3 .mat appends, generate_training_data_automated.m:219).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Sampling rule (generate_training_data_automated.m:44-60 /
// landing_optimization.m:207-218): roll, yaw ~ U(+-0.25), pitch ~ U(+-pi/3),
// omega ~ U(+-0.5)^3, v_xy ~ U(+-1)^2, v_z ~ -(0.5 + 4.5 U(0,1)), and
// z0 = 0.35 + |min_leg hip_world_z| + |dt0 * v_z|.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kDt0 = 0.05;         // first production knot (landing_optimization.m:28)
constexpr double kTdNom = 0.35;       // nominal touchdown height
constexpr double kHipX = 0.19, kHipY = 0.10;

// xoshiro256++ - fast, high-quality host RNG
struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 init
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
};

void sample_one(Xoshiro& rng, float* q, float* qd) {
  double roll = rng.uniform(-0.25, 0.25);
  double pitch = rng.uniform(-kPi / 3.0, kPi / 3.0);
  double yaw = rng.uniform(-0.25, 0.25);
  double wx = rng.uniform(-0.5, 0.5), wy = rng.uniform(-0.5, 0.5), wz = rng.uniform(-0.5, 0.5);
  double vx = rng.uniform(-1.0, 1.0), vy = rng.uniform(-1.0, 1.0);
  double vz = -(0.5 + 4.5 * rng.uniform());

  // hip-clearance initial height: rotate the 4 SRBM hip offsets by
  // R = rx(r)' ry(p)' rz(y)' and take |min z| (landing_optimization.m:210-216)
  double cr = std::cos(roll), sr = std::sin(roll);
  double cp = std::cos(pitch), sp = std::sin(pitch);
  double cy = std::cos(yaw), sy = std::sin(yaw);
  // body-to-world rotation, XYZ convention (row for z-component only)
  // R = Rx' * Ry' * Rz'; z-row of R applied to hip offsets:
  //   z = (cp*... ) derive: R31..R33 of rx'*ry'*rz'
  double R31 = -sp * cy * cr + sr * sy;  // careful derivation below
  // Compute full R = rx(r)^T * ry(p)^T * rz(y)^T numerically instead:
  double Rx[9] = {1, 0, 0, 0, cr, -sr, 0, sr, cr};        // rx(r)^T
  double Ry[9] = {cp, 0, sp, 0, 1, 0, -sp, 0, cp};        // ry(p)^T
  double Rz[9] = {cy, -sy, 0, sy, cy, 0, 0, 0, 1};        // rz(y)^T
  double T1[9], R[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T1[3 * i + j] = 0;
      for (int k = 0; k < 3; ++k) T1[3 * i + j] += Rx[3 * i + k] * Ry[3 * k + j];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      R[3 * i + j] = 0;
      for (int k = 0; k < 3; ++k) R[3 * i + j] += T1[3 * i + k] * Rz[3 * k + j];
    }
  (void)R31;
  double hips[4][3] = {{kHipX, -kHipY, 0}, {kHipX, kHipY, 0}, {-kHipX, -kHipY, 0}, {-kHipX, kHipY, 0}};
  double min_z = 1e30;
  for (auto& h : hips) {
    double z = R[6] * h[0] + R[7] * h[1] + R[8] * h[2];
    if (z < min_z) min_z = z;
  }
  double z0 = kTdNom + std::fabs(min_z) + std::fabs(kDt0 * vz);

  q[0] = 0.f; q[1] = 0.f; q[2] = (float)z0;
  q[3] = (float)roll; q[4] = (float)pitch; q[5] = (float)yaw;
  qd[0] = (float)wx; qd[1] = (float)wy; qd[2] = (float)wz;
  qd[3] = (float)vx; qd[4] = (float)vy; qd[5] = (float)vz;
}

struct Batch {
  std::vector<float> q;   // (B, 6)
  std::vector<float> qd;  // (B, 6)
};

struct Pool {
  int batch;
  int depth;
  std::vector<std::thread> workers;
  std::queue<Batch> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  uint64_t seed;
  std::atomic<uint64_t> counter{0};

  Pool(int b, int d, int nthreads, uint64_t s) : batch(b), depth(d), seed(s) {
    for (int t = 0; t < nthreads; ++t) {
      workers.emplace_back([this, t] { run(t); });
    }
  }
  ~Pool() {
    stop = true;
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& w : workers) w.join();
  }
  void run(int tid) {
    while (!stop) {
      uint64_t n = counter.fetch_add(1);
      Xoshiro rng(seed ^ (0x9e3779b97f4a7c15ULL * (n + 1)) ^ ((uint64_t)tid << 32));
      Batch b;
      b.q.resize(batch * 6);
      b.qd.resize(batch * 6);
      for (int i = 0; i < batch; ++i) sample_one(rng, &b.q[6 * i], &b.qd[6 * i]);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [this] { return stop || (int)ready.size() < depth; });
      if (stop) return;
      ready.push(std::move(b));
      cv_ready.notify_one();
    }
  }
  bool next(float* q_out, float* qd_out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [this] { return stop || !ready.empty(); });
    if (ready.empty()) return false;
    Batch b = std::move(ready.front());
    ready.pop();
    cv_space.notify_one();
    lk.unlock();
    std::memcpy(q_out, b.q.data(), b.q.size() * sizeof(float));
    std::memcpy(qd_out, b.qd.data(), b.qd.size() * sizeof(float));
    return true;
  }
};

// CRC32 (IEEE) for result-log framing
uint32_t crc32(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < len; ++i) c = table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

struct Logger {
  FILE* f;
  std::mutex mu;
  explicit Logger(const char* path) { f = std::fopen(path, "ab"); }
  ~Logger() {
    if (f) std::fclose(f);
  }
  // record: [u32 magic][u32 payload_len][payload][u32 crc]
  bool append(const uint8_t* payload, uint32_t len) {
    if (!f) return false;
    std::lock_guard<std::mutex> lk(mu);
    uint32_t magic = 0x4c43544bu;  // "LCTK"
    uint32_t crc = crc32(payload, len);
    if (std::fwrite(&magic, 4, 1, f) != 1) return false;
    if (std::fwrite(&len, 4, 1, f) != 1) return false;
    if (len && std::fwrite(payload, 1, len, f) != len) return false;
    if (std::fwrite(&crc, 4, 1, f) != 1) return false;
    std::fflush(f);
    return true;
  }
};

}  // namespace

extern "C" {

void* lctpu_pool_create(int batch, int depth, int nthreads, uint64_t seed) {
  return new Pool(batch, depth, nthreads, seed);
}
void lctpu_pool_destroy(void* p) { delete static_cast<Pool*>(p); }
int lctpu_pool_next(void* p, float* q_out, float* qd_out) {
  return static_cast<Pool*>(p)->next(q_out, qd_out) ? 1 : 0;
}
void lctpu_sample(uint64_t seed, int n, float* q_out, float* qd_out) {
  Xoshiro rng(seed);
  for (int i = 0; i < n; ++i) sample_one(rng, q_out + 6 * i, qd_out + 6 * i);
}

void* lctpu_log_open(const char* path) { return new Logger(path); }
void lctpu_log_close(void* l) { delete static_cast<Logger*>(l); }
int lctpu_log_append(void* l, const uint8_t* payload, uint32_t len) {
  return static_cast<Logger*>(l)->append(payload, len) ? 1 : 0;
}
uint32_t lctpu_crc32(const uint8_t* data, uint64_t len) { return crc32(data, len); }

}  // extern "C"
