"""The port's SPD block inverse against the JAX package.

landing_controller_tpu_torch.ops.chol_inverse on the CPU (its plain
version), held against the Pallas kernel of
landing_controller_tpu.ops.pallas_blocks in interpret mode and against
numpy on the same numpy-seeded inputs.  The CUDA kernel itself is checked
on the card (tests/test_torch_cuda.py and chip_smoke.py).  Also: the build
helper's source hash covers the headers a kernel source includes.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.ops.pallas_blocks import chol_inverse as j_chol_inverse
from landing_controller_tpu_torch.ops import _build, chol_inverse, chol_inverse_ref

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _random_spd(rng, m, n, dtype=np.float32):
    """Random SPD blocks (the recipe of tests/test_pallas_blocks.py)."""
    A = rng.standard_normal((m, n, n))
    return (A @ A.transpose(0, 2, 1) / n + np.eye(n)[None] * 0.5).astype(dtype)


# rtol=atol=2e-4: f32 with another summation order (the JAX package's own
# Pallas-vs-reference tolerance, tests/test_pallas_blocks.py:77)
@pytest.mark.parametrize("n", [10, 36])
def test_plain_chol_inverse_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    A = _random_spd(rng, 7, n)
    A[4, 1, 1] = -3.0  # one indefinite block
    Ainv_p, ok_p = j_chol_inverse(jnp.asarray(A), interpret=True)
    Ainv_t, ok_t = chol_inverse(torch.as_tensor(A))
    ok_p = np.asarray(ok_p)
    np.testing.assert_array_equal(ok_t.numpy(), ok_p)
    assert not ok_p[4] and ok_p.sum() == 6
    np.testing.assert_allclose(Ainv_t.numpy()[ok_p], np.asarray(Ainv_p)[ok_p], rtol=2e-4, atol=2e-4)
    # the plain version follows a library Cholesky: a failed factorization gives NaNs
    assert np.isnan(Ainv_t.numpy()[4]).all()


@pytest.mark.parametrize("n", [5, 48, 84])
def test_plain_chol_inverse_f64_matches_numpy(n):
    rng = np.random.default_rng(100 + n)
    A = _random_spd(rng, 4, n, np.float64)
    Ainv, ok = chol_inverse(torch.as_tensor(A))
    assert bool(ok.all()) and Ainv.shape == (4, n, n)
    np.testing.assert_allclose(Ainv.numpy(), np.linalg.inv(A), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Ainv.numpy(), Ainv.numpy().transpose(0, 2, 1), rtol=0, atol=1e-12)


def test_ok_flags_on_definite_and_indefinite_blocks():
    rng = np.random.default_rng(2)
    A = _random_spd(rng, 6, 12)
    A[1] = -A[1]  # negative definite
    A[3, 11, 11] = 0.0  # singular last pivot region
    A[3, 11, :11] = 0.0
    A[3, :11, 11] = 0.0
    Ainv, ok = chol_inverse_ref(torch.as_tensor(A))
    _, ok_p = j_chol_inverse(jnp.asarray(A), interpret=True)
    assert ok.tolist() == [True, False, True, False, True, True]
    np.testing.assert_array_equal(np.asarray(ok_p), ok.numpy())
    assert torch.isfinite(Ainv[ok]).all()


def test_non_finite_blocks_fail_in_every_version():
    A = _random_spd(np.random.default_rng(3), 4, 9)
    A[1, 2, 2] = np.nan
    A[2, 5, 1] = A[2, 1, 5] = np.inf
    want = [True, False, False, True]
    assert np.asarray(j_chol_inverse(jnp.asarray(A), interpret=True)[1]).tolist() == want
    Ainv, ok = chol_inverse(torch.as_tensor(A))
    assert ok.tolist() == want and bool(torch.isfinite(Ainv[ok]).all())


def test_pivot_clamp_pallas_overflows_plain_inverts():
    """The TPU kernel's pivot rule, which the CUDA kernel follows: a positive
    pivot below the 1e-30 clamp passes the test while the clamped factor
    overflows.  The plain version factors diag(1e-37, 1, ..., 1) exactly."""
    A = np.eye(8, dtype=np.float32)[None].copy()
    A[0, 0, 0] = 1e-37
    Ainv_p, ok_p = j_chol_inverse(jnp.asarray(A), interpret=True)
    assert bool(ok_p[0]) and not np.isfinite(np.asarray(Ainv_p)).all()
    Ainv_t, ok_t = chol_inverse(torch.as_tensor(A))
    assert bool(ok_t[0]) and bool(torch.isfinite(Ainv_t).all())
    assert float(Ainv_t[0, 0, 0]) == pytest.approx(1e37, rel=1e-6)


def test_chol_inverse_rejects_other_devices_and_counts_no_cpu_launch():
    before = chol_inverse.launches
    chol_inverse(torch.eye(3)[None])
    assert chol_inverse.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        chol_inverse(torch.zeros((1, 8, 8), device="meta"))


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Both kernel sources include block_chol.cuh; editing the header changes
    the library name of both, so a stale library is never loaded."""
    for name in _build.KERNELS:
        files = [os.path.basename(p) for p in _build.source_files(name)]
        assert files == [f"{name}.cu", "block_chol.cuh"]
    shutil.copytree(_build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path / "csrc"))
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    assert before == {name: _build.library_path(name) for name in _build.KERNELS}
    with open(tmp_path / "csrc" / "block_chol.cuh", "a") as f:
        f.write("// edited\n")
    for name in _build.KERNELS:
        assert _build.library_path(name) != before[name]
    with open(tmp_path / "csrc" / "chol_inverse.cu", "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    with open(tmp_path / "csrc" / "qd_inverse.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("chol_inverse") == after["chol_inverse"]
    assert _build.library_path("qd_inverse") != after["qd_inverse"]
