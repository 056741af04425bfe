"""Threads per block of the block-inverse kernels, measured.

    python tests/probe_block_kernels.py

Builds ``csrc/qd_inverse.cu`` once for each candidate pair of
``BLOCK_CHOL_THREADS`` and ``BLOCK_CHOL_MIN_BLOCKS`` (``csrc/block_chol.cuh``:
threads per block, and the blocks per SM that the compiler sizes the registers
for) into ``build/kernels/threads_probe/``, and times each build at one wave
of blocks (latency: m = 128 at (36, 24), m = 512 at (48, 36)) and at many
waves (throughput: m = 1280 and m = 5120) with CUDA events, median of 25, in
turns over the candidates.  Prints one line per candidate and shape with the
card's name and power limit.  Needs an NVIDIA GPU and nvcc.

    python tests/probe_block_kernels.py --clocks

builds the kernel as it ships with ``-DBLOCK_CHOL_CLOCKS`` and prints, for
three shapes, the clock cycles that threads 0 and 32 of block 0 spend in each
phase of one instance and before each barrier (mean of 10 launches): what a
profiler would say of the inside of the kernel.

Not a test.  tests/test_torch_kernel_on_cpu.py builds the same variants of the
header for the CPU and holds PHASES to the header's slots.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from landing_controller_tpu_torch.ops import _build  # noqa: E402

CANDIDATES = ((64, 1), (128, 1), (128, 8), (128, 10), (256, 1), (256, 4))
SHAPES = ((36, 24, 128), (36, 24, 1280), (48, 36, 512), (48, 36, 5120))


# the slots of block_chol.cuh's BLOCK_CHOL_STAMP, in order
PHASES = ("load", "wait", "first diagonal tile", "wait", "panels (all steps)", "wait",
          "next diagonal tile (thread 0) / trailing update (thread 32)", "wait", "M21 products",
          "wait", "M21 stores", "wait", "product M' J M and stores")


def build(threads: int, min_blocks: int, clocks: bool = False) -> ctypes.CDLL:
    out_dir = os.path.join(_build.BUILD_DIR, "threads_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libqd_inverse_t{threads}_b{min_blocks}_c{int(clocks)}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DBLOCK_CHOL_THREADS={threads}",
           f"-DBLOCK_CHOL_MIN_BLOCKS={min_blocks}", *(["-DBLOCK_CHOL_CLOCKS"] if clocks else []),
           "-o", lib, os.path.join(_build.CSRC_DIR, "qd_inverse.cu")]
    done = subprocess.run(cmd, check=True, capture_output=True, text=True)
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[threads] build threads={threads} min_blocks={min_blocks}: {line.strip()}")
    cdll = ctypes.CDLL(lib)
    cdll.qd_inverse_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    cdll.qd_inverse_launch.restype = ctypes.c_int
    cdll.qd_inverse_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    cdll.qd_inverse_blocks_per_sm.restype = ctypes.c_int
    return cdll


def median_ms(fn, reps=25):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def random_blocks(rng, m, np_, nd):
    """Quasi-definite blocks on the card, with their output buffers."""
    bs = np_ + nd
    P = rng.standard_normal((m, bs, bs)).astype(np.float32)
    S = P @ P.transpose(0, 2, 1) / bs + 0.5 * np.eye(bs, dtype=np.float32)
    S[:, np_:, np_:] *= -1.0  # only the lower triangle is read: P, B, -D
    S = torch.as_tensor(S, device="cuda")
    return S, torch.empty_like(S), torch.empty(m, dtype=torch.bool, device="cuda")


def print_clocks(smi: str) -> None:
    lib = build(128, 1, clocks=True)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    reps = 10
    for np_, nd, m in ((36, 24, 128), (48, 36, 512), (48, 36, 5120)):
        S, out, ok = random_blocks(rng, m, np_, nd)
        for i in range(3 + reps):
            if i == 3:  # after the warm-up launches
                torch.cuda.synchronize()
                lib.qd_inverse_zero_clocks()
            lib.qd_inverse_launch(S.data_ptr(), out.data_ptr(), ok.data_ptr(), m, np_, nd, stream)
        torch.cuda.synchronize()
        counters = (ctypes.c_longlong * (2 * len(PHASES)))()
        lib.qd_inverse_read_clocks(counters)
        cycles = np.array(list(counters)).reshape(2, len(PHASES)) / reps
        print(f"[clocks] qd_inverse ({np_},{nd}) m={m}, block 0, cycles per launch of thread 0 | "
              f"thread 32: {cycles[0].sum():.0f} | {cycles[1].sum():.0f} ({smi})")
        for name, c0, c32 in zip(PHASES, cycles[0], cycles[1]):
            print(f"[clocks]   {name:60s} {c0:8.0f} | {c32:8.0f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_block_kernels: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if sys.argv[1:] == ["--clocks"]:
        print_clocks(smi)
        return 0
    libs = {t: build(*t) for t in CANDIDATES}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for np_, nd, m in SHAPES:
        S, out, ok = random_blocks(rng, m, np_, nd)
        times = {t: [] for t in CANDIDATES}
        for order in (CANDIDATES, CANDIDATES[::-1]):  # in turns
            for t in order:
                def launch(lib=libs[t]):
                    rc = lib.qd_inverse_launch(S.data_ptr(), out.data_ptr(), ok.data_ptr(), m, np_,
                                               nd, stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: cudaError {rc}")
                times[t].append(median_ms(launch))
        for t in CANDIDATES:
            print(f"[threads] qd_inverse ({np_},{nd}) m={m} threads={t[0]} min_blocks={t[1]}: "
                  f"{times[t][0]:.4f} / {times[t][1]:.4f} ms, blocks per SM "
                  f"{libs[t].qd_inverse_blocks_per_sm(np_, nd)} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
