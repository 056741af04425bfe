"""The port's inverse-based block cyclic reduction against the JAX package.

landing_controller_tpu_torch.ops.cr_inverse on the CPU (plain block
inverse), held against landing_controller_tpu.ops.cr_inverse on the same
numpy-seeded block-tridiagonal systems, at f64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from landing_controller_tpu.ops.cr_inverse import cri_factor as j_cri_factor
from landing_controller_tpu.ops.cr_inverse import cri_solve as j_cri_solve
from landing_controller_tpu.ops.pallas_blocks import make_qd_inverse as j_make_qd_inverse
from landing_controller_tpu_torch.ops import cri_factor, cri_solve, make_qd_inverse
from test_torch_qd_inverse import _random_qd_blocks

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _tridiag(rng, nb, np_, nd):
    bs = np_ + nd
    A = _random_qd_blocks(rng, nb, np_, nd, np.float64)
    C = 0.1 * rng.standard_normal((max(nb - 1, 0), bs, bs))
    b = rng.standard_normal((nb, bs))
    return A, C, b


# 16, 18, 21, 41: the block counts of the contact-scheduled, sliding,
# kinodynamic/srbm_lcp and ccc horizons
@pytest.mark.parametrize("nb", [1, 2, 5, 16, 18, 21, 41])
def test_cri_factor_solve_match_jax(nb):
    rng = np.random.default_rng(5)
    np_, nd = 6, 4
    A, C, b = _tridiag(rng, nb, np_, nd)
    fac_j = j_cri_factor(jnp.asarray(A), jnp.asarray(C), j_make_qd_inverse(np_, nd, force="ref"))
    x_j = np.asarray(j_cri_solve(fac_j, jnp.asarray(b)))
    fac_t = cri_factor(torch.as_tensor(A), torch.as_tensor(C), make_qd_inverse(np_, nd))
    x_t = cri_solve(fac_t, torch.as_tensor(b)).numpy()
    assert bool(fac_t.ok) == bool(fac_j.ok) is True
    assert len(fac_t.levels) == len(fac_j.levels)
    assert [lt.Sinv.shape[0] for lt in fac_t.levels] == [lj.Sinv.shape[0] for lj in fac_j.levels]
    for lt, lj in zip(fac_t.levels, fac_j.levels):
        np.testing.assert_allclose(lt.Sinv.numpy(), np.asarray(lj.Sinv), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-10, atol=1e-10)


def test_cri_batched_leading_dims_match_per_system():
    """Leading (lane, ladder) dims: one factor of a (2, 3, NB) stack equals
    the six separate factors."""
    rng = np.random.default_rng(6)
    np_, nd, nb = 6, 4, 7
    systems = [_tridiag(rng, nb, np_, nd) for _ in range(6)]
    A = torch.as_tensor(np.stack([s[0] for s in systems])).reshape(2, 3, nb, 10, 10)
    C = torch.as_tensor(np.stack([s[1] for s in systems])).reshape(2, 3, nb - 1, 10, 10)
    b = torch.as_tensor(np.stack([s[2] for s in systems])).reshape(2, 3, nb, 10)
    fn = make_qd_inverse(np_, nd)
    x = cri_solve(cri_factor(A, C, fn), b).reshape(6, nb, 10)
    for i, (Ai, Ci, bi) in enumerate(systems):
        xi = cri_solve(cri_factor(torch.as_tensor(Ai), torch.as_tensor(Ci), fn), torch.as_tensor(bi))
        torch.testing.assert_close(x[i], xi, rtol=1e-12, atol=1e-12)
