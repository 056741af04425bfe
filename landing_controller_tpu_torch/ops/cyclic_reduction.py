"""Block cyclic reduction for quasi-definite block-tridiagonal KKT systems
(``kkt_backend="cr"``), batch-first.

The system of :mod:`.block_tridiag`, solved by parallel-in-time cyclic
reduction instead of the sequential sweep: at each level the odd blocks are
factored (two Cholesky factorizations each, all at once) and eliminated, and
the even blocks with their new Schur couplings form the next level.
Quasi-definiteness is closed under this Schur complementation (Vanderbei
1995), so every level factors pivot-free, and a failed Cholesky is the
inertia signal.  Leading dimensions (lanes, ladder candidates) are carried
through; the levels are a Python loop (NB is static).
"""

from __future__ import annotations

import dataclasses

import torch

from .block_tridiag import factor_blocks, solve_blocks


@dataclasses.dataclass(frozen=True)
class Level:
    lp: torch.Tensor  # (..., n_odd, NP, NP) primal Cholesky of the odd blocks
    ld: torch.Tensor  # (..., n_odd, ND, ND) dual-Schur Cholesky of the odd blocks
    bm: torch.Tensor  # (..., n_odd, ND, NP) B sub-blocks of the odd blocks
    X: torch.Tensor  # (..., n_odd, BS, BS)  A_odd^{-1} C_left
    Y: torch.Tensor  # (..., n_odd, BS, BS)  A_odd^{-1} C_right' (zero-padded)


@dataclasses.dataclass(frozen=True)
class CRFactor:
    levels: tuple  # tuple[Level, ...]
    root_lp: torch.Tensor
    root_ld: torch.Tensor
    root_bm: torch.Tensor
    ok: torch.Tensor  # (...) bool: every Cholesky succeeded (inertia signal)

    def select(self, fn):
        """Factor with fn applied to every tensor (e.g. a ladder gather)."""
        return CRFactor(
            levels=tuple(Level(*(fn(getattr(lev, f.name)) for f in dataclasses.fields(lev)))
                         for lev in self.levels),
            root_lp=fn(self.root_lp), root_ld=fn(self.root_ld), root_bm=fn(self.root_bm),
            ok=fn(self.ok),
        )


def _t(M):
    return M.transpose(-1, -2)


def cr_factor(A, C, np_: int, nd: int) -> CRFactor:
    """Factor K (A: (..., NB, BS, BS) diagonals, C: (..., NB-1, BS, BS)
    sub-diagonals, block (k+1, k)) by block cyclic reduction.  ``ok`` is
    False where any Cholesky failed."""
    nb, bs = A.shape[-3], A.shape[-1]
    lead = A.shape[:-3]
    levels = []
    ok = torch.ones(lead, dtype=torch.bool, device=A.device)
    zero_blk = A.new_zeros(lead + (1, bs, bs))

    m = nb
    while m > 1:
        n_odd = m // 2
        n_even = (m + 1) // 2
        # pad C so every odd block has a "right" coupling slot (zero if absent)
        C_pad = torch.cat([C, zero_blk], -3) if C.shape[-3] < m else C
        A_odd = A[..., 1::2, :, :]
        C_left = C_pad[..., 0::2, :, :][..., :n_odd, :, :]  # C_{j-1} for odd j
        C_right = C_pad[..., 1::2, :, :][..., :n_odd, :, :]  # C_j for odd j

        lp, ld, bm, ok_l = factor_blocks(A_odd, np_)
        ok = ok & ok_l.all(-1)
        G = solve_blocks(lp, ld, bm, torch.cat([C_left, _t(C_right)], -1), np_)
        X, Y = G[..., :bs], G[..., bs:]
        levels.append(Level(lp=lp, ld=ld, bm=bm, X=X, Y=Y))

        # even blocks, updated by both odd neighbours
        n_right = min(n_odd, n_even - 1)
        A_even = A[..., 0::2, :, :]
        upd = torch.zeros_like(A_even)
        upd[..., :n_odd, :, :] += _t(C_left) @ X
        upd[..., 1 : 1 + n_right, :, :] += (C_right @ Y)[..., :n_right, :, :]
        A = A_even - upd
        # new couplings between even blocks 2i and 2i+2
        C = -(C_right @ X)[..., : n_even - 1, :, :]
        m = n_even

    root_lp, root_ld, root_bm, ok_r = factor_blocks(A[..., :1, :, :], np_)
    return CRFactor(levels=tuple(levels), root_lp=root_lp, root_ld=root_ld, root_bm=root_bm,
                    ok=ok & ok_r.all(-1))


def _mtv(M, v):
    """(..., k, i, j)' x (..., k, i) -> (..., k, j)."""
    return (_t(M) @ v[..., None])[..., 0]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def cr_solve(fac: CRFactor, b, np_: int, nd: int):
    """Solve K x = b given a CRFactor; b (..., NB, BS) -> x (..., NB, BS)."""
    stack = []
    for lev in fac.levels:
        m = b.shape[-2]
        n_odd = m // 2
        n_even = (m + 1) // 2
        n_right = min(n_odd, n_even - 1)
        b_odd = b[..., 1::2, :]
        s_odd = solve_blocks(lev.lp, lev.ld, lev.bm, b_odd, np_)
        b_even = b[..., 0::2, :]
        upd = torch.zeros_like(b_even)
        # b'_{j-1} -= C_{j-1}' A_j^{-1} b_j = X' b_j   (A_j symmetric)
        upd[..., :n_odd, :] += _mtv(lev.X, b_odd)
        # b'_{j+1} -= C_j A_j^{-1} b_j = Y' b_j
        upd[..., 1 : 1 + n_right, :] += _mtv(lev.Y[..., :n_right, :, :], b_odd[..., :n_right, :])
        stack.append((s_odd, m))
        b = b_even - upd

    x = solve_blocks(fac.root_lp, fac.root_ld, fac.root_bm, b, np_)

    # backward expansion: x_odd = s_odd - X x_left - Y x_right
    for lev, (s_odd, m) in zip(reversed(fac.levels), reversed(stack)):
        n_odd = m // 2
        x_even = x
        x_left = x_even[..., :n_odd, :]
        x_right = torch.cat([x_even[..., 1:, :], torch.zeros_like(x_even[..., :1, :])],
                            -2)[..., :n_odd, :]
        x_odd = s_odd - _mv(lev.X, x_left) - _mv(lev.Y, x_right)
        x = x.new_zeros(x.shape[:-2] + (m, x.shape[-1]))
        x[..., 0::2, :] = x_even
        x[..., 1::2, :] = x_odd
    return x


__all__ = ["CRFactor", "cr_factor", "cr_solve"]
