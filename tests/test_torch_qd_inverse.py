"""The port's block inverse against the JAX package.

landing_controller_tpu_torch.ops.pallas_blocks.qd_inverse on the CPU (its
plain version), held against landing_controller_tpu.ops.pallas_blocks on
the same numpy-seeded inputs.  The CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from landing_controller_tpu.ops.pallas_blocks import qd_inverse as j_qd_inverse
from landing_controller_tpu.ops.pallas_blocks import qd_inverse_ref as j_qd_inverse_ref
from landing_controller_tpu_torch.ops import make_qd_inverse, qd_inverse
from landing_controller_tpu_torch.tracing import counters

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _random_qd_blocks(rng, m, np_, nd, dtype=np.float32):
    """Random quasi-definite blocks [[P, B'], [B, -D]], equilibrated-ish
    (the recipe of tests/test_pallas_blocks.py)."""
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
    return S.astype(dtype)


# tolerances: f64 agrees to rounding (1e-10); f32 to a few ulps of the
# block's condition (2e-4, the JAX package's own Pallas-vs-ref tolerance)
@pytest.mark.parametrize(
    "np_,nd,dtype,tol",
    [(7, 4, np.float64, 1e-10), (36, 24, np.float64, 1e-10),
     (7, 4, np.float32, 2e-4), (36, 24, np.float32, 2e-4)],
)
def test_plain_qd_inverse_matches_jax_ref(np_, nd, dtype, tol):
    rng = np.random.default_rng(11)
    S = _random_qd_blocks(rng, 6, np_, nd, dtype)
    S[3, 0, 0] = -5.0  # one indefinite P block
    Sinv_j, ok_j = j_qd_inverse_ref(jnp.asarray(S), np_, nd)
    Sinv_t, ok_t = qd_inverse(torch.as_tensor(S), np_, nd)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert not ok_j[3] and ok_j.sum() == 5
    np.testing.assert_allclose(Sinv_t.numpy()[ok_j], np.asarray(Sinv_j)[ok_j], rtol=tol, atol=tol)
    # the plain version follows qd_inverse_ref: a failed Cholesky gives NaNs
    assert np.isnan(Sinv_t.numpy()[3]).all()


def test_plain_qd_inverse_matches_pallas_interpret():
    """Against the Pallas kernel itself (interpret mode) at (12, 8), f32,
    rtol=atol=2e-4; ok must agree on every block, one of them indefinite."""
    rng = np.random.default_rng(1)
    S = _random_qd_blocks(rng, 9, 12, 8, np.float32)
    S[5, 2, 2] = -4.0
    Sinv_p, ok_p = j_qd_inverse(jnp.asarray(S), 12, 8, interpret=True)
    Sinv_t, ok_t = qd_inverse(torch.as_tensor(S), 12, 8)
    ok_p = np.asarray(ok_p)
    np.testing.assert_array_equal(ok_t.numpy(), ok_p)
    assert not ok_p[5] and ok_p.sum() == 8
    np.testing.assert_allclose(Sinv_t.numpy()[ok_p], np.asarray(Sinv_p)[ok_p], rtol=2e-4, atol=2e-4)


def test_pivot_clamp_pallas_overflows_plain_inverts():
    """The TPU kernel's pivot rule, which the CUDA kernel follows: a positive
    pivot below the 1e-30 clamp passes the inertia test, but the clamped
    factor overflows, so the Pallas kernel (interpret mode) returns ok with
    non-finite values.  The plain version factors the same block exactly.
    The block: P = I, B = 0, D = diag(1e-37, 1, ..., 1)."""
    S = np.zeros((1, 20, 20), np.float32)
    S[0, :12, :12] = np.eye(12)
    S[0, 12:, 12:] = -np.eye(8)
    S[0, 12, 12] = -1e-37
    Sinv_p, ok_p = j_qd_inverse(jnp.asarray(S), 12, 8, interpret=True)
    assert bool(ok_p[0]) and not np.isfinite(np.asarray(Sinv_p)).all()
    Sinv_t, ok_t = qd_inverse(torch.as_tensor(S), 12, 8)
    assert bool(ok_t[0]) and bool(torch.isfinite(Sinv_t).all())
    assert float(Sinv_t[0, 12, 12]) == pytest.approx(-1e37, rel=1e-6)


def test_non_finite_blocks_fail_in_every_version():
    """A block with a NaN or an infinity (the reduced block of a failed
    ladder candidate) is not ok: in the JAX reference, in the Pallas kernel
    (interpret mode) and in the port's plain version, whose LAPACK call may
    report success on it."""
    rng = np.random.default_rng(9)
    S = _random_qd_blocks(rng, 5, 12, 8, np.float32)
    S[1, 3, 3] = np.nan
    S[2, 14, 2] = S[2, 2, 14] = np.inf
    S[3, 15, 15] = np.nan
    want = [True, False, False, False, True]
    assert np.asarray(j_qd_inverse_ref(jnp.asarray(S), 12, 8)[1]).tolist() == want
    assert np.asarray(j_qd_inverse(jnp.asarray(S), 12, 8, interpret=True)[1]).tolist() == want
    Sinv, ok = qd_inverse(torch.as_tensor(S), 12, 8)
    assert ok.tolist() == want
    assert torch.isfinite(Sinv[ok]).all()


def test_make_qd_inverse_folds_leading_dims():
    rng = np.random.default_rng(4)
    S = _random_qd_blocks(rng, 2 * 3 * 4, 5, 3, np.float64)
    St = torch.as_tensor(S)
    fn = make_qd_inverse(5, 3)
    out, ok = fn(St.reshape(2, 3, 4, 8, 8))
    out_d, ok_d = qd_inverse(St, 5, 3)
    assert ok.shape == (2, 3, 4)
    torch.testing.assert_close(out.reshape(24, 8, 8), out_d, rtol=0, atol=0)
    assert bool(ok.all()) and bool(ok_d.all())


def test_qd_inverse_rejects_other_devices():
    S = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        qd_inverse(S, 5, 3)


@pytest.mark.parametrize("op", ["qd_inverse", "chol_inverse"])
def test_kernels_are_custom_ops_with_fake_implementations(op):
    """Both block inverses are registered custom ops (torch.library.opcheck
    holds the schema, the fake implementation and the CPU implementation
    against one another); a fake-tensor trace records one node that names
    the op, and launches nothing."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from landing_controller_tpu_torch.ops import chol_inverse

    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(3), 4, 5, 3))
    if op == "qd_inverse":
        fn, args = qd_inverse, (S, 5, 3)
    else:
        fn, args = chol_inverse, (S[:, :5, :5].contiguous(),)
    torch.library.opcheck(getattr(torch.ops.landing_controller_tpu_torch, op).default, args)
    launches = counters()[f"{op}.launches"]
    gm = make_fx(lambda *a: fn(*a), tracing_mode="fake")(*args)
    calls = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert calls.count(f"landing_controller_tpu_torch.{op}.default") == 1
    out, ok = getattr(torch.ops.landing_controller_tpu_torch, op)(*args)
    assert out.shape == args[0].shape and ok.shape == (4,) and ok.dtype == torch.bool
    assert counters()[f"{op}.launches"] == launches
