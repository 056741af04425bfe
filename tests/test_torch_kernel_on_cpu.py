"""The CUDA source of the block-inverse kernels, run on the CPU.

``csrc/block_chol.cuh`` holds the whole computation of both kernels as one
device function.  ``tests/cuda_on_cpu/`` has a stand-in for
``<cuda_runtime.h>`` and a small harness that let a host compiler build that
header as it is and run it with one OS thread per CUDA thread
(``__syncthreads`` / ``__syncwarp`` as ``std::barrier``), under the address
sanitizer where the compiler has one, with the shared memory sized exactly by
the header's own ``smem_bytes``.  So the kernel's indexing, its barriers and
its arithmetic are held against the plain versions here, where there is no
card: compile-time instances and the run-time instance, widths that are no
multiple of 4, an indefinite block, the pivot clamp, non-finite blocks.
Tolerance 2e-4 as on the card (tests/test_torch_cuda.py).  The double
instance of the same header is held to the plain versions in f64 at 1e-10
(an f64 factorization in another summation order than LAPACK's, on blocks
whose condition numbers stay below 1e3).  The header's
build-time variants (other numbers of threads per block, the clock stamps
that tests/probe_block_kernels.py reads on the card) are built and held to
the same results.  Skipped where no g++ with C++20 is installed.
"""

import importlib.util
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch.ops import _build
from landing_controller_tpu_torch.ops.pallas_blocks import (chol_inverse_ref, padded_size,
                                                           qd_inverse_ref)

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_on_cpu")


def build_harness(tmp_path_factory, *defines):
    """Path of a harness binary built with the given -D flags."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA header for the CPU")
    exe = str(tmp_path_factory.mktemp("cuda_on_cpu") / "harness")
    base = [gxx, "-std=c++20", "-O1", "-g", "-Wno-unknown-pragmas", *defines, "-I", HERE, "-I",
            _build.CSRC_DIR, os.path.join(HERE, "harness.cpp"), "-o", exe, "-lpthread"]
    done = subprocess.run(base + ["-fsanitize=address"], capture_output=True, text=True)
    if done.returncode != 0 and "asan" in done.stderr.lower():
        done = subprocess.run(base, capture_output=True, text=True)  # no sanitizer runtime
    if done.returncode != 0 and "c++20" in done.stderr:
        pytest.skip("needs a g++ with C++20 (std::barrier)")
    assert done.returncode == 0, done.stderr
    return exe


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness of the header as it ships, built once per test process."""
    return build_harness(tmp_path_factory)


def run_on_cpu(harness, tmp_path, S, np_, fixed, stdout=None, dtype=np.float32):
    """(m, bs, bs) -> (inverse, ok) through the harness's instance for
    ``dtype`` (f32 or f64); its standard output's lines are appended to the
    list ``stdout``."""
    m, bs, _ = S.shape
    size = np.dtype(dtype).itemsize
    src, dst = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    np.ascontiguousarray(S, dtype).tofile(src)
    done = subprocess.run([harness, str(m), str(bs), str(np_), str(int(fixed)), src, dst,
                           str(size)], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    if stdout is not None:
        stdout += done.stdout.splitlines()
    raw = np.fromfile(dst, np.uint8)
    out = raw[:size * m * bs * bs].view(dtype).reshape(m, bs, bs)
    return out, raw[size * m * bs * bs:].astype(bool)


def _random_qd_blocks(rng, m, np_, nd):
    bs = np_ + nd
    P = rng.standard_normal((m, np_, np_))
    P = P @ P.transpose(0, 2, 1) / np_ + np.eye(np_)[None] * 0.5
    D = rng.standard_normal((m, nd, nd))
    D = D @ D.transpose(0, 2, 1) / nd + np.eye(nd)[None] * 0.5
    B = 0.5 * rng.standard_normal((m, nd, np_))
    S = np.zeros((m, bs, bs))
    S[:, :np_, :np_] = P
    S[:, np_:, :np_] = B
    S[:, :np_, np_:] = B.transpose(0, 2, 1)
    S[:, np_:, np_:] = -D
    return S.astype(np.float32)


def _random_spd(rng, m, n):
    A = rng.standard_normal((m, n, n))
    return (A @ A.transpose(0, 2, 1) / n + np.eye(n)[None] * 0.5).astype(np.float32)


def _check(out, ok, ref, ok_ref, want_ok, tol=2e-4):
    assert ok.tolist() == ok_ref.tolist() == want_ok
    assert not (out == -777.0).any()  # every entry written, ok or not
    good = np.asarray(want_ok)
    np.testing.assert_allclose(out[good], ref.numpy()[good], rtol=tol, atol=tol)
    assert np.array_equal(out[good], out[good].transpose(0, 2, 1))  # symmetric bit for bit


@pytest.mark.parametrize("np_,nd,fixed", [(36, 24, True), (48, 36, True), (36, 40, True),
                                          (36, 24, False), (30, 20, False), (7, 4, False),
                                          (12, 8, False), (5, 3, False)])
def test_qd_inverse_source_matches_plain(harness, tmp_path, np_, nd, fixed):
    S = _random_qd_blocks(np.random.default_rng(np_ + nd), 3, np_, nd)
    S[1, 0, 0] = -5.0  # indefinite
    out, ok = run_on_cpu(harness, tmp_path, S, np_, fixed)
    ref, ok_ref = qd_inverse_ref(torch.as_tensor(S), np_, nd)
    _check(out, ok, ref, ok_ref, [True, False, True])


@pytest.mark.parametrize("n,fixed", [(36, True), (48, True), (48, False), (5, False), (24, False),
                                     (81, False), (84, False)])
def test_chol_inverse_source_matches_plain(harness, tmp_path, n, fixed):
    A = _random_spd(np.random.default_rng(n), 3, n)
    A[1, 0, 0] = -5.0
    out, ok = run_on_cpu(harness, tmp_path, A, padded_size(n), fixed)  # every column positive
    ref, ok_ref = chol_inverse_ref(torch.as_tensor(A))
    _check(out, ok, ref, ok_ref, [True, False, True])


# the double instance: the paths' compile-time shapes, the run-time instance
# at (30, 20) and chol n = 48, against the plain versions in f64
@pytest.mark.parametrize("np_,nd,fixed", [(36, 24, True), (48, 36, True), (30, 20, False),
                                          (7, 4, False)])
def test_qd_inverse_f64_source_matches_plain(harness, tmp_path, np_, nd, fixed):
    S = _random_qd_blocks(np.random.default_rng(np_ * nd), 3, np_, nd).astype(np.float64)
    S[1, 0, 0] = -5.0
    out, ok = run_on_cpu(harness, tmp_path, S, np_, fixed, dtype=np.float64)
    assert out.dtype == np.float64
    ref, ok_ref = qd_inverse_ref(torch.as_tensor(S), np_, nd)
    _check(out, ok, ref, ok_ref, [True, False, True], tol=1e-10)


@pytest.mark.parametrize("n,fixed", [(48, True), (48, False), (84, False)])
def test_chol_inverse_f64_source_matches_plain(harness, tmp_path, n, fixed):
    A = _random_spd(np.random.default_rng(n + 1), 3, n).astype(np.float64)
    A[1, 0, 0] = -5.0
    out, ok = run_on_cpu(harness, tmp_path, A, padded_size(n), fixed, dtype=np.float64)
    ref, ok_ref = chol_inverse_ref(torch.as_tensor(A))
    _check(out, ok, ref, ok_ref, [True, False, True], tol=1e-10)


def test_f64_source_follows_the_pivot_clamp(harness, tmp_path):
    """The double instance keeps the f32 rule: a positive pivot d below 1e-30
    passes, and its factor is d / sqrt(1e-30), so the inverse holds
    1 / (d^2 1e30) (f32 overflows there; f64 does not at d = 1e-37); a NaN
    fails; a pivot of 1e-29, above the clamp, is inverted exactly."""
    A = np.eye(8)[None].repeat(3, 0)
    A[0, 0, 0] = 1e-37
    A[1, 2, 2] = np.nan
    A[2, 0, 0] = 1e-29
    out, ok = run_on_cpu(harness, tmp_path, A, 8, False, dtype=np.float64)
    assert ok.tolist() == [True, False, True]
    np.testing.assert_allclose(out[0], np.diag([1e44] + [1.0] * 7), rtol=1e-15)
    np.testing.assert_allclose(out[2], np.diag([1e29] + [1.0] * 7), rtol=1e-15)


def test_source_follows_the_pivot_clamp_and_fails_non_finite_blocks(harness, tmp_path):
    """The cases of tests/test_torch_cuda.py: a positive pivot below the 1e-30
    clamp passes and overflows; a NaN or an infinity fails."""
    np_, nd = 12, 8
    S = np.zeros((1, np_ + nd, np_ + nd), np.float32)
    S[0, :np_, :np_] = np.eye(np_)
    S[0, np_:, np_:] = -np.eye(nd)
    S[0, np_, np_] = -1e-37
    out, ok = run_on_cpu(harness, tmp_path, S, np_, False)
    assert bool(ok[0]) and not np.isfinite(out).all()
    A = np.eye(8, dtype=np.float32)[None].copy()
    A[0, 0, 0] = 1e-37
    out, ok = run_on_cpu(harness, tmp_path, A, 8, False)
    assert bool(ok[0]) and not np.isfinite(out).all()
    S = _random_qd_blocks(np.random.default_rng(9), 5, 12, 8)
    S[1, 3, 3] = np.nan
    S[2, 14, 2] = S[2, 2, 14] = np.inf
    S[3, 15, 15] = np.nan
    assert run_on_cpu(harness, tmp_path, S, 12, False)[1].tolist() == [True, False, False, False,
                                                                      True]
    A = _random_spd(np.random.default_rng(3), 4, 9)
    A[1, 2, 2] = np.nan
    A[2, 5, 1] = A[2, 1, 5] = np.inf
    assert run_on_cpu(harness, tmp_path, A, 12, False)[1].tolist() == [True, False, False, True]


@pytest.mark.parametrize("threads,min_blocks", [(64, 8), (256, 4)])
def test_source_with_other_threads_per_block(tmp_path_factory, tmp_path, threads, min_blocks):
    """The candidates of tests/probe_block_kernels.py: the header built for
    another number of threads gives the results of the plain version too."""
    exe = build_harness(tmp_path_factory, f"-DBLOCK_CHOL_THREADS={threads}",
                        f"-DBLOCK_CHOL_MIN_BLOCKS={min_blocks}")
    for np_, nd, fixed in ((48, 36, True), (7, 4, False)):
        S = _random_qd_blocks(np.random.default_rng(threads + np_), 3, np_, nd)
        S[1, 0, 0] = -5.0
        out, ok = run_on_cpu(exe, tmp_path, S, np_, fixed)
        ref, ok_ref = qd_inverse_ref(torch.as_tensor(S), np_, nd)
        _check(out, ok, ref, ok_ref, [True, False, True])


def test_source_with_clock_stamps(tmp_path_factory, tmp_path):
    """-DBLOCK_CHOL_CLOCKS builds, changes no result, and stamps one counter
    for each phase name that tests/probe_block_kernels.py prints."""
    spec = importlib.util.spec_from_file_location(
        "probe_block_kernels", os.path.join(os.path.dirname(HERE), "probe_block_kernels.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    with open(os.path.join(_build.CSRC_DIR, "block_chol.cuh")) as f:
        header = f.read()
    slots = [int(k) for k in re.findall(r"^\s*BLOCK_CHOL_STAMP\((\d+)\);", header, re.MULTILINE)]
    assert slots == list(range(len(probe.PHASES)))
    assert int(re.search(r"kClockSlots = (\d+);", header).group(1)) == len(probe.PHASES)
    exe = build_harness(tmp_path_factory, "-DBLOCK_CHOL_CLOCKS")
    S = _random_qd_blocks(np.random.default_rng(1), 3, 36, 24)
    S[1, 0, 0] = -5.0
    printed = []
    out, ok = run_on_cpu(exe, tmp_path, S, 36, True, stdout=printed)
    ref, ok_ref = qd_inverse_ref(torch.as_tensor(S), 36, 24)
    _check(out, ok, ref, ok_ref, [True, False, True])
    counters = [int(line) for line in printed]
    assert len(counters) == len(probe.PHASES) and min(counters) >= 0 and sum(counters) > 0
