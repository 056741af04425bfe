"""The blocked scheme of the CUDA block-inverse kernels, in plain torch.

``csrc/block_chol.cuh`` inverts a quasi-definite block S = [[P, B'], [B, -D]]
as S = L J L' with J = diag(+1 (np times), -1 (nd times)): a signed Cholesky
by panels of ``PANEL`` columns (the diagonal tile factored column by column
with the clamped pivot rule and inverted, the panel below it multiplied by
that inverse, a rank-``PANEL`` update of the trailing lower triangle), then
M = L^-1 panel by panel from the last to the first, then the lower triangle of
Sinv = M' J M, mirrored.  An SPD block is the case nd = 0.  The kernel cannot
run without a card, so the same steps are written here once, batched, and held
against the plain versions ``qd_inverse_ref`` / ``chol_inverse_ref``: f64 to
1e-10, f32 to 2e-4 (the kernel-vs-plain tolerance of tests/test_torch_cuda.py),
with equal ok flags on an indefinite and on a non-finite block.  Also here:
the shared-memory layout's Python mirror against hand-worked sizes.
"""

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch.ops import pallas_blocks
from landing_controller_tpu_torch.ops.pallas_blocks import (PANEL, chol_inverse_ref,
                                                           chol_inverse_smem_bytes, padded_size,
                                                           qd_inverse_ref, qd_inverse_smem_bytes,
                                                           row_stride)

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def blocked_signed_inverse(S, np_):
    """(m, bs, bs), leading np_ columns positive -> (Sinv, ok), by the
    kernel's steps.  Reads the lower triangle of S only."""
    m, bs, _ = S.shape
    n = padded_size(bs)
    sign = torch.where(torch.arange(n) < np_, 1.0, -1.0).to(S.dtype)
    A = torch.diag(sign).repeat(m, 1, 1)  # identity padding, signed
    A[:, :bs, :bs] = S
    A = torch.tril(A)
    min_piv = torch.full((m,), float("inf"), dtype=S.dtype)
    bad = torch.zeros(m, dtype=torch.bool)
    for k0 in range(0, n, PANEL):
        kb = min(PANEL, n - k0)
        r0 = k0 + kb
        sg = sign[k0:r0]
        # the diagonal tile: signed Cholesky column by column, clamped pivots
        T = A[:, k0:r0, k0:r0].clone()
        L = torch.zeros_like(T)
        for j in range(kb):
            d = sg[j] * T[:, j, j]
            bad |= ~torch.isfinite(d)
            min_piv = torch.where(d < min_piv, d, min_piv)  # fminf: a NaN never wins
            s = torch.rsqrt(torch.clamp(d, min=1e-30))
            v = sg[j] * T[:, :, j] * s[:, None]
            v[:, :j] = 0.0
            L[:, :, j] = v
            T = T - sg[j] * v[:, :, None] * v[:, None, :]
        # its inverse X by forward substitution, a division by L_ii per row
        X = torch.zeros_like(L)
        eye = torch.eye(kb, dtype=S.dtype)
        for i in range(kb):
            acc = eye[i][None, :] - (L[:, i, :i, None] * X[:, :i, :]).sum(1)
            X[:, i, :] = acc / L[:, i, i, None]
        X = torch.tril(X)
        A[:, k0:r0, k0:r0] = X
        if r0 < n:
            # panel: L21 = A21 X' J; kept for the update, T21 = L21 X stored in place
            L21 = (A[:, r0:, k0:r0] @ X.transpose(1, 2)) * sg[None, None, :]
            A[:, r0:, k0:r0] = L21 @ X
            upd = (L21 * sg[None, None, :]) @ L21.transpose(1, 2)
            A[:, r0:, r0:] = A[:, r0:, r0:] - torch.tril(upd)
    # M = L^-1: M21 = -M22 T21, panels from the last to the first
    last = (n - 1) // PANEL * PANEL
    for k0 in range(last - PANEL, -1, -PANEL):
        r0 = k0 + PANEL
        A[:, r0:, k0:r0] = -(A[:, r0:, r0:] @ A[:, r0:, k0:r0])
    # Sinv = M' J M: the lower triangle, mirrored
    C = torch.tril(A.transpose(1, 2) @ (sign[None, :, None] * A))
    C = C + torch.tril(C, -1).transpose(1, 2)
    return C[:, :bs, :bs], ~bad & (min_piv > 0)


def _random_qd_blocks(rng, m, np_, nd, dtype):
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
    return torch.as_tensor(S.astype(dtype))


def _random_spd(rng, m, n, dtype):
    A = rng.standard_normal((m, n, n))
    return torch.as_tensor((A @ A.transpose(0, 2, 1) / n + np.eye(n)[None] * 0.5).astype(dtype))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 2e-4)])
@pytest.mark.parametrize("np_,nd", [(36, 24), (48, 36), (7, 4)])
def test_blocked_scheme_matches_plain_qd_inverse(np_, nd, dtype, tol):
    S = _random_qd_blocks(np.random.default_rng(np_), 6, np_, nd, dtype)
    out, ok = blocked_signed_inverse(S, np_)
    ref, ok_ref = qd_inverse_ref(S, np_, nd)
    assert bool(ok.all()) and bool(ok_ref.all())
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    assert torch.equal(out, out.transpose(1, 2))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 2e-4)])
@pytest.mark.parametrize("n", [5, 36, 48, 84])
def test_blocked_scheme_matches_plain_chol_inverse(n, dtype, tol):
    A = _random_spd(np.random.default_rng(n), 4, n, dtype)
    out, ok = blocked_signed_inverse(A, padded_size(n))
    ref, ok_ref = chol_inverse_ref(A)
    assert bool(ok.all()) and bool(ok_ref.all())
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    assert torch.equal(out, out.transpose(1, 2))


@pytest.mark.parametrize("np_,nd", [(36, 24), (7, 4)])
def test_blocked_scheme_flags_indefinite_and_non_finite_blocks(np_, nd):
    """An indefinite P, an indefinite D, a NaN, an infinity in B: not ok in
    the blocked scheme and in the plain version; the scheme carries on past
    the bad pivot and still returns a value for every entry's slot."""
    S = _random_qd_blocks(np.random.default_rng(3), 6, np_, nd, np.float32)
    S[1, 0, 0] = -5.0
    S[2, np_ + 1, np_ + 1] = 5.0
    S[3, 2, 2] = float("nan")
    S[4, np_ + 1, 1] = S[4, 1, np_ + 1] = float("inf")
    out, ok = blocked_signed_inverse(S, np_)
    _, ok_ref = qd_inverse_ref(S, np_, nd)
    want = [True, False, False, False, False, True]
    assert ok.tolist() == want and ok_ref.tolist() == want
    assert out.shape == S.shape and bool(torch.isfinite(out[ok]).all())


def test_blocked_scheme_follows_the_pivot_clamp():
    """diag(1e-37, 1, ...): a positive pivot below the 1e-30 clamp passes the
    test and the clamped factor overflows, as in the TPU kernel."""
    A = torch.eye(8, dtype=torch.float32)[None].clone()
    A[0, 0, 0] = 1e-37
    out, ok = blocked_signed_inverse(A, 8)
    assert bool(ok[0]) and not bool(torch.isfinite(out).all())


# hand-worked: n rows of `row_stride` floats, a PANEL x n scratch, and two
# bytes per 4x4 tile of the lower triangle (at least 36 entries, the elements
# of a diagonal tile's lower triangle) rounded up to 16
@pytest.mark.parametrize("bs,n,ld,want", [
    (60, 60, 60, 4 * (60 * 60 + 8 * 60) + 240),    # 16,560: 15 tile rows, 120 tiles
    (84, 84, 84, 4 * (84 * 84 + 8 * 84) + 464),    # 31,376: 21 tile rows, 231 tiles
    (76, 76, 76, 4 * (76 * 76 + 8 * 76) + 384),    # 25,920: 19 tile rows, 190 tiles
    (48, 48, 52, 4 * (48 * 52 + 8 * 48) + 160),    # 11,680: the stride leaves 0 mod 8
    (36, 36, 36, 4 * (36 * 36 + 8 * 36) + 96),     # 6,432
    (11, 12, 12, 4 * (12 * 12 + 8 * 12) + 80),     # 1,040: padded to a multiple of 4; 36 entries
])
def test_shared_memory_layout(bs, n, ld, want):
    assert padded_size(bs) == n and row_stride(bs) == ld
    assert pallas_blocks.block_smem_bytes(bs) == want
    assert ld % 8 == 4  # float4 rows of consecutive rows fall into distinct banks


def test_shared_memory_of_the_paths_shapes():
    assert qd_inverse_smem_bytes(36, 24) == 16560 < 18 * 1024
    assert qd_inverse_smem_bytes(48, 36) == 31376 < 35 * 1024
    assert qd_inverse_smem_bytes(36, 40) == 25920
    assert chol_inverse_smem_bytes(84) == 31376 < 35 * 1024
    assert chol_inverse_smem_bytes(48) == 11680 and chol_inverse_smem_bytes(36) == 6432
    limit = 227 * 1024
    assert all(pallas_blocks.block_smem_bytes(bs) < limit
               for bs in range(1, pallas_blocks.MAX_BLOCK + 1))


def test_shared_memory_of_the_f64_instances():
    """The double instance: the same layout on 8-byte words (the table stays
    two bytes an entry); above the default 48 KB only past 72 wide, where the
    launcher raises the kernel's limit, and always below the card's 227 KB."""
    assert qd_inverse_smem_bytes(36, 24, torch.float64) == 8 * (60 * 60 + 8 * 60) + 240 == 32880
    assert qd_inverse_smem_bytes(48, 36, torch.float64) == 8 * (84 * 84 + 8 * 84) + 464 == 62288
    assert chol_inverse_smem_bytes(48, torch.float64) == 8 * (48 * 52 + 8 * 48) + 160 == 23200
    over = [bs for bs in range(1, pallas_blocks.MAX_BLOCK + 1)
            if pallas_blocks.block_smem_bytes(bs, torch.float64) > 48 * 1024]
    assert over == list(range(73, pallas_blocks.MAX_BLOCK + 1))
    assert pallas_blocks.block_smem_bytes(pallas_blocks.MAX_BLOCK, torch.float64) < 227 * 1024
