"""Block-tridiagonal quasi-definite KKT factorization (sequential sweep),
batch-first.

Solves K x = b where K is symmetric block-tridiagonal with NB uniform blocks
of size BS = NP + ND (diagonal blocks A, sub-diagonal blocks C, block
(k+1, k)), every diagonal block quasi-definite: its leading NP x NP part
positive definite, its trailing ND x ND part negative definite.  The block
LDL' sweep

    S_0 = A_0,   S_k = A_k - C_{k-1} S_{k-1}^{-1} C_{k-1}'

needs no pivoting: each S_k factors as two Cholesky factorizations
(P = Lp Lp', then D + B P^-1 B' = Ld Ld'), whose failure is the inertia test
that drives the solver's shift ladder (``kkt_backend="scan"``).

The sweep is a Python loop over the NB blocks; every step is batched over
the leading dimensions (scenario lanes, ladder candidates).  A failed
factorization is NaN, as in the JAX package, so a solve with it is NaN.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QDFactor:
    lp: torch.Tensor  # (..., NB, NP, NP) Cholesky of the primal parts
    ld: torch.Tensor  # (..., NB, ND, ND) Cholesky of the dual Schur parts
    bmat: torch.Tensor  # (..., NB, ND, NP) the B sub-blocks of each S_k
    c: torch.Tensor  # (..., NB-1, BS, BS) the off-diagonal blocks (as given)
    ok: torch.Tensor  # (...) bool: every Cholesky factorization succeeded

    def select(self, fn):
        """Factor with fn applied to every tensor (e.g. a ladder gather)."""
        return QDFactor(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def chol_nan(A):
    """Batched Cholesky of A (..., n, n) -> (L, ok (...)); a failed factor
    (LAPACK's info, or a non-finite value) is NaN throughout."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], L, torch.full_like(L, float("nan"))), ok


def _t(M):
    return M.transpose(-1, -2)


def factor_blocks(S, np_: int):
    """Quasi-definite factor of blocks S = [[P, B'], [B, -D]] (..., BS, BS):
    (lp, ld, B, ok)."""
    P = S[..., :np_, :np_]
    B = S[..., np_:, :np_]
    D = -S[..., np_:, np_:]
    lp, ok_p = chol_nan(P)
    pib = torch.cholesky_solve(_t(B), lp)  # P^-1 B'
    ld, ok_d = chol_nan(D + B @ pib)
    return lp, ld, B, ok_p & ok_d


def solve_blocks(lp, ld, B, r, np_: int):
    """Solve [[P, B'], [B, -D]] x = r given the block factor; r (..., BS)
    or (..., BS, k):  a0 = P^-1 r1, b = -Dt^-1 (r2 - B a0), a = P^-1 (r1 - B' b)."""
    vec = r.dim() == lp.dim() - 1
    if vec:
        r = r[..., None]
    r1, r2 = r[..., :np_, :], r[..., np_:, :]
    a0 = torch.cholesky_solve(r1, lp)
    b = -torch.cholesky_solve(r2 - B @ a0, ld)
    a = torch.cholesky_solve(r1 - _t(B) @ b, lp)
    out = torch.cat([a, b], -2)
    return out[..., 0] if vec else out


def qd_block_tridiag_factor(A, C, np_: int, nd: int) -> QDFactor:
    """Factor the block-tridiagonal quasi-definite system.

    A: (..., NB, BS, BS) diagonal blocks; C: (..., NB-1, BS, BS) sub-diagonal
    blocks.  ``ok`` is False where any block Cholesky failed (wrong inertia:
    the caller moves up its shift ladder)."""
    nb = A.shape[-3]
    lp, ld, bm, ok = factor_blocks(A[..., 0, :, :], np_)
    lps, lds, bms = [lp], [ld], [bm]
    for k in range(1, nb):
        Ck = C[..., k - 1, :, :]
        # S_k = A_k - C_{k-1} S_{k-1}^-1 C_{k-1}'
        X = solve_blocks(lp, ld, bm, _t(Ck), np_)
        lp, ld, bm, ok_k = factor_blocks(A[..., k, :, :] - Ck @ X, np_)
        lps.append(lp)
        lds.append(ld)
        bms.append(bm)
        ok = ok & ok_k
    return QDFactor(lp=torch.stack(lps, -3), ld=torch.stack(lds, -3), bmat=torch.stack(bms, -3),
                    c=C, ok=ok)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def qd_block_tridiag_solve(fac: QDFactor, b, np_: int, nd: int):
    """Solve K x = b given the factorization; b (..., NB, BS) -> x (..., NB, BS)."""
    nb = b.shape[-2]

    def blk(k, v):
        return solve_blocks(fac.lp[..., k, :, :], fac.ld[..., k, :, :], fac.bmat[..., k, :, :],
                            v, np_)

    # forward sweep: e_k = b_k - C_{k-1} S_{k-1}^-1 e_{k-1}
    e = [b[..., 0, :]]
    s_prev = blk(0, e[0])
    for k in range(1, nb):
        e.append(b[..., k, :] - _mv(fac.c[..., k - 1, :, :], s_prev))
        s_prev = blk(k, e[k])
    # backward sweep: x_k = S_k^-1 (e_k - C_k' x_{k+1})
    x = [None] * nb
    x[nb - 1] = s_prev
    for k in range(nb - 2, -1, -1):
        x[k] = blk(k, e[k] - _mv(_t(fac.c[..., k, :, :]), x[k + 1]))
    return torch.stack(x, -2)


__all__ = ["QDFactor", "qd_block_tridiag_factor", "qd_block_tridiag_solve"]
