"""Branch-induced-sparsity factorization of kinematic-tree mass matrices,
batch-first.

The spatial_v2 sparsity kit (spatial_v2/sparsity/{LTL,LTDL,mpyL,mpyLt,mpyLi,
mpyLit,expandLambda,mpyH}.m; Featherstone, RBDA ch. 6): the joint-space
inertia matrix H of a kinematic tree is filled only on ancestor pairs, so it
factors as H = L' L (LTL) or H = L' D L (LTDL) with L of the same tree
sparsity: no fill-in, no pivoting.

The tree (``lam``, the parent array) is static Python data, so the ancestor
loops unroll into elementwise operations on the entries of a batch of
matrices ``(..., n, n)`` and vectors ``(..., n)``: for the 18-body tree a few
hundred of them, with no dense factorization.

Convention: ``lam[i]`` is the parent of variable i, -1 at roots (multi-DoF
joints pre-expanded by :func:`expand_lambda`).
"""

from __future__ import annotations

import numpy as np
import torch


def expand_lambda(lam, nf):
    """Expand a per-joint parent array for multi-DoF joints
    (spatial_v2/sparsity/expandLambda.m).

    lam: (n,) parent indices (-1 root); nf: (n,) DoF counts per joint.
    Returns the (sum(nf),) parent array over individual variables."""
    lam = np.asarray(lam, dtype=np.int64)
    nf = np.asarray(nf, dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(nf)[:-1]])  # first variable of joint i
    out = []
    for i in range(lam.shape[0]):
        for k in range(nf[i]):
            if k == 0:
                p = lam[i]
                out.append(start[p] + nf[p] - 1 if p >= 0 else -1)
            else:
                out.append(start[i] + k - 1)
    return np.asarray(out, dtype=np.int64)


def _ancestors(lam, k):
    """Proper ancestors of k, innermost first."""
    out = []
    i = int(lam[k])
    while i >= 0:
        out.append(i)
        i = int(lam[i])
    return out


def _entries(M):
    n = M.shape[-1]
    return [[M[..., i, j] for j in range(n)] for i in range(n)]


def ltdl(H, lam):
    """Factor H = L' D L with unit lower triangular tree-sparse L
    (spatial_v2/sparsity/LTDL.m).  Returns (L (..., n, n), d (..., n)), d the
    diagonal of D.

    Variables are eliminated from the leaves (n - 1) to the roots; each
    column touches only its ancestor chain, so nothing fills in outside the
    tree's pattern."""
    n = H.shape[-1]
    h = _entries(H)
    for k in range(n - 1, -1, -1):
        for i in _ancestors(lam, k):
            a = h[k][i] / h[k][k]
            # subtract a * (row k restricted to the ancestors of i, and i)
            for j in [i] + _ancestors(lam, i):
                h[i][j] = h[i][j] - a * h[k][j]
            h[k][i] = a
    d = torch.stack([h[i][i] for i in range(n)], -1)
    zero, one = torch.zeros_like(h[0][0]), torch.ones_like(h[0][0])
    rows = []
    for k in range(n):
        anc = _ancestors(lam, k)
        rows.append([one if c == k else (h[k][c] if c in anc else zero) for c in range(n)])
    L = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return L, d


def ltl(H, lam):
    """Factor H = L' L with tree-sparse lower triangular L
    (spatial_v2/sparsity/LTL.m)."""
    L, d = ltdl(H, lam)
    return L * torch.sqrt(d)[..., :, None]


def mpy_l(L, lam, x):
    """y = L x using the tree sparsity (spatial_v2/sparsity/mpyL.m)."""
    n = L.shape[-1]
    ys = []
    for k in range(n):
        y = L[..., k, k] * x[..., k]
        for i in _ancestors(lam, k):
            y = y + L[..., k, i] * x[..., i]
        ys.append(y)
    return torch.stack(ys, -1)


def mpy_lt(L, lam, x):
    """y = L' x using the tree sparsity (spatial_v2/sparsity/mpyLt.m)."""
    n = L.shape[-1]
    y = [L[..., k, k] * x[..., k] for k in range(n)]
    for k in range(n):
        for i in _ancestors(lam, k):
            y[i] = y[i] + L[..., k, i] * x[..., k]
    return torch.stack(y, -1)


def solve_l(L, lam, b):
    """x = L^-1 b: forward substitution along ancestor chains
    (spatial_v2/sparsity/mpyLi.m).  Rows ascend, so every ancestor i < k of
    row k is known when row k is reached."""
    n = L.shape[-1]
    x = [b[..., k] for k in range(n)]
    for k in range(n):
        for i in _ancestors(lam, k):
            x[k] = x[k] - L[..., k, i] * x[i]
        x[k] = x[k] / L[..., k, k]
    return torch.stack(x, -1)


def solve_lt(L, lam, b):
    """x = L'^-1 b: back substitution along descendant chains
    (spatial_v2/sparsity/mpyLit.m); once x[k] is fixed its share is removed
    from every ancestor's row."""
    n = L.shape[-1]
    x = [b[..., k] for k in range(n)]
    for k in range(n - 1, -1, -1):
        x[k] = x[k] / L[..., k, k]
        for i in _ancestors(lam, k):
            x[i] = x[i] - L[..., k, i] * x[k]
    return torch.stack(x, -1)


def solve_ltl(H_factor_L, lam, b):
    """Solve H x = b given L from :func:`ltl` (H = L' L): two sweeps."""
    return solve_l(H_factor_L, lam, solve_lt(H_factor_L, lam, b))


def mpy_h(L, d, lam, x):
    """y = H x from the LTDL factors without forming H
    (spatial_v2/sparsity/mpyH.m): y = L' (d * (L x))."""
    return mpy_lt(L, lam, d * mpy_l(L, lam, x))
