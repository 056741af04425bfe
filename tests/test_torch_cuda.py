"""The hand-written CUDA kernel against its plain version, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with the CUDA toolkit and
skip where ``torch.cuda.is_available()`` is False.  On the card run them
with ``python -m pytest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch.ops import cri_factor, cri_solve, make_qd_inverse
from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse, qd_inverse_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


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


# rtol=atol=2e-4: f32 with a different summation order than the plain
# version (the JAX package's own kernel-vs-reference tolerance)
@pytest.mark.parametrize("np_,nd,m", [(7, 4, 5), (36, 24, 1280), (48, 36, 64), (36, 40, 64)])
def test_kernel_matches_plain(dev, np_, nd, m):
    S = _random_qd_blocks(np.random.default_rng(m), m, np_, nd)
    S[1, 0, 0] = -5.0  # indefinite: ok must be False
    S = torch.as_tensor(S, device=dev)
    out_k, ok_k = qd_inverse(S, np_, nd)
    out_p, ok_p = qd_inverse_ref(S, np_, nd)
    torch.cuda.synchronize()
    assert torch.equal(ok_k, ok_p) and not bool(ok_k[1]) and int(ok_k.sum()) == m - 1
    assert torch.isfinite(out_k[ok_k]).all()
    torch.testing.assert_close(out_k[ok_k], out_p[ok_k], rtol=2e-4, atol=2e-4)


def test_kernel_follows_pallas_pivot_clamp(dev):
    """P = I, B = 0, D = diag(1e-37, 1, ...): a positive pivot below the
    1e-30 clamp.  Like the Pallas kernel (tests/test_torch_qd_inverse.py),
    the kernel flags the block ok and its values overflow; the plain
    version inverts it."""
    np_, nd = 12, 8
    S = np.zeros((1, np_ + nd, np_ + nd), np.float32)
    S[0, :np_, :np_] = np.eye(np_)
    S[0, np_:, np_:] = -np.eye(nd)
    S[0, np_, np_] = -1e-37
    S = torch.as_tensor(S, device=dev)
    out_k, ok_k = qd_inverse(S, np_, nd)
    out_p, ok_p = qd_inverse_ref(S, np_, nd)
    assert bool(ok_k[0]) and bool(ok_p[0])
    assert not bool(torch.isfinite(out_k).all()) and bool(torch.isfinite(out_p).all())


def test_kernel_counts_launches_and_checks_inputs(dev):
    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(0), 3, 6, 4), device=dev)
    before = qd_inverse.launches
    qd_inverse(S, 6, 4)
    qd_inverse(S.cpu(), 6, 4)  # the plain version: not a launch
    assert qd_inverse.launches == before + 1
    with pytest.raises(TypeError):
        qd_inverse(S.double(), 6, 4)
    with pytest.raises(ValueError):
        qd_inverse(S, 5, 4)
    # a non-contiguous view is accepted (the wrapper makes it contiguous)
    St = S.transpose(1, 2)
    torch.testing.assert_close(qd_inverse(St, 6, 4)[0], qd_inverse_ref(St.contiguous(), 6, 4)[0],
                               rtol=2e-4, atol=2e-4)


def test_cri_solve_through_kernel(dev):
    rng = np.random.default_rng(5)
    np_, nd, nb = 36, 24, 21
    A = _random_qd_blocks(rng, 2 * nb, np_, nd).reshape(2, nb, 60, 60)
    C = (0.01 * rng.standard_normal((2, nb - 1, 60, 60))).astype(np.float32)
    b = rng.standard_normal((2, nb, 60)).astype(np.float32)
    fn = make_qd_inverse(np_, nd)
    fac = cri_factor(torch.as_tensor(A, device=dev), torch.as_tensor(C, device=dev), fn)
    assert bool(fac.ok.all())
    x = cri_solve(fac, torch.as_tensor(b, device=dev))
    x64 = cri_solve(cri_factor(torch.as_tensor(A, dtype=torch.float64),
                               torch.as_tensor(C, dtype=torch.float64), fn),
                    torch.as_tensor(b, dtype=torch.float64))
    torch.testing.assert_close(x.cpu().double(), x64, rtol=1e-3, atol=1e-3)
