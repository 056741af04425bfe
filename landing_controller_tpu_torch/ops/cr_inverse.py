"""Block cyclic reduction with explicit block inverses, batch-first.

Factor and solve a quasi-definite block-tridiagonal system K (diagonal
blocks A, sub-diagonal blocks C, block (k+1, k)) by inverse-based block
cyclic reduction: at every level the odd blocks are inverted explicitly by
``qd_inverse`` (one kernel launch per level over every leading batch
dimension and every odd block), and every sweep operation is a batched
matmul.  Leading dimensions (scenario lanes, ladder candidates) are carried
through all of it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LevelInv:
    Sinv: torch.Tensor  # (..., n_odd, BS, BS) inverses of the odd blocks
    X: torch.Tensor  # (..., n_odd, BS, BS)  S_odd^{-1} C_left
    Y: torch.Tensor  # (..., n_odd, BS, BS)  S_odd^{-1} C_right' (zero-padded)


@dataclasses.dataclass(frozen=True)
class CRInvFactor:
    levels: tuple  # tuple[LevelInv, ...]
    root_Sinv: torch.Tensor  # (..., 1, BS, BS)
    ok: torch.Tensor  # (...) bool: positive-pivot inertia test at all levels

    def select(self, fn):
        """Factor with fn applied to every tensor (e.g. a ladder gather)."""
        return CRInvFactor(
            levels=tuple(LevelInv(fn(l.Sinv), fn(l.X), fn(l.Y)) for l in self.levels),
            root_Sinv=fn(self.root_Sinv),
            ok=fn(self.ok),
        )


def _t(M):
    return M.transpose(-1, -2)


def cri_factor(A, C, qd_inverse_fn) -> CRInvFactor:
    """Factor K given A (..., NB, BS, BS) and C (..., NB-1, BS, BS).

    qd_inverse_fn: (..., k, BS, BS) -> (Sinv, ok (..., k)), e.g.
    ``ops.pallas_blocks.make_qd_inverse(np_, nd)``."""
    nb, bs = A.shape[-3], A.shape[-1]
    lead = A.shape[:-3]
    levels = []
    ok = torch.ones(lead, dtype=torch.bool, device=A.device)
    zero_blk = A.new_zeros(lead + (1, bs, bs))

    m = nb
    while m > 1:
        n_odd = m // 2
        n_even = (m + 1) // 2
        C_pad = torch.cat([C, zero_blk], -3) if C.shape[-3] < m else C
        A_odd = A[..., 1::2, :, :]
        C_left = C_pad[..., 0::2, :, :][..., :n_odd, :, :]  # C_{j-1} for odd j
        C_right = C_pad[..., 1::2, :, :][..., :n_odd, :, :]  # C_j for odd j

        Sinv, okv = qd_inverse_fn(A_odd)
        ok = ok & okv.all(-1)
        X = Sinv @ C_left
        Y = Sinv @ _t(C_right)
        levels.append(LevelInv(Sinv=Sinv, X=X, Y=Y))

        n_right = min(n_odd, n_even - 1)
        A_even = A[..., 0::2, :, :]
        upd = torch.zeros_like(A_even)
        upd[..., :n_odd, :, :] += _t(C_left) @ X
        upd[..., 1 : 1 + n_right, :, :] += (C_right @ Y)[..., :n_right, :, :]
        A = A_even - upd
        C = -(C_right @ X)[..., : n_even - 1, :, :]
        m = n_even

    root_Sinv, ok_root = qd_inverse_fn(A[..., :1, :, :])
    ok = ok & ok_root.all(-1)
    return CRInvFactor(levels=tuple(levels), root_Sinv=root_Sinv, ok=ok)


def _mv(M, v):
    """(..., k, i, j) x (..., k, j) -> (..., k, i)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """(..., k, i, j)' x (..., k, i) -> (..., k, j)."""
    return (_t(M) @ v[..., None])[..., 0]


def cri_solve(fac: CRInvFactor, b):
    """Solve K x = b given a CRInvFactor.  b: (..., NB, BS) -> x (..., NB, BS)."""
    stack = []
    for lev in fac.levels:
        m = b.shape[-2]
        n_odd = m // 2
        n_even = (m + 1) // 2
        n_right = min(n_odd, n_even - 1)
        b_odd = b[..., 1::2, :]
        s_odd = _mv(lev.Sinv, b_odd)
        b_even = b[..., 0::2, :]
        upd = torch.zeros_like(b_even)
        upd[..., :n_odd, :] += _mtv(lev.X, b_odd)
        upd[..., 1 : 1 + n_right, :] += _mtv(
            lev.Y[..., :n_right, :, :], b_odd[..., :n_right, :]
        )
        stack.append((s_odd, m))
        b = b_even - upd

    x = _mv(fac.root_Sinv, b)

    for lev, (s_odd, m) in zip(reversed(fac.levels), reversed(stack)):
        n_odd = m // 2
        x_even = x
        x_left = x_even[..., :n_odd, :]
        x_right_full = torch.cat(
            [x_even[..., 1:, :], torch.zeros_like(x_even[..., :1, :])], -2
        )[..., :n_odd, :]
        x_odd = s_odd - _mv(lev.X, x_left) - _mv(lev.Y, x_right_full)
        x = x.new_zeros(x.shape[:-2] + (m, x.shape[-1]))
        x[..., 0::2, :] = x_even
        x[..., 1::2, :] = x_odd
    return x
