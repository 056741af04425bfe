"""Problem scaling for the interior-point solver (batch-first).

IPOPT-style gradient-based scaling (the reference tunes
``nlp_scaling_max_gradient=50``, quadruped_SRBM_NLP.m:263):

- static per-variable scales d (z = d * z_tilde), chosen by the problem, and
- row scales for f, E, g computed once at z0 per lane:
  ``s_row = min(1, g_max / ||row grad||_inf)`` in scaled variables.

:class:`ScaledNLP` holds the problem (any object with ``cost``, ``eq`` and
``ineq`` over (z, theta): a landing problem, the eeParam problem), its
parameters (a dataclass of tensors with leading B) and the scales of B lanes.  Its ``cost``/``eq``/``ineq`` take z of shape (B*k, n) for any k >= 1:
rows are lane-major (row r belongs to lane r // k), which is how the line
search evaluates k candidate steps of every lane in one call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vjp, vmap

from .._tree import tree_map


@dataclasses.dataclass(frozen=True)
class ScaledNLP:
    problem: object
    theta: object  # dataclass of tensors, leading dimension B
    z_scale: torch.Tensor  # (B, n)  d: z = d * z_tilde
    f_scale: torch.Tensor  # (B,)
    eq_scale: torch.Tensor  # (B, me)
    ineq_scale: torch.Tensor  # (B, mi)

    @property
    def batch(self) -> int:
        return self.f_scale.shape[0]

    def _rep(self, rows: int):
        k = rows // self.batch
        if k == 1:
            return self
        return tree_map(lambda t: t.repeat_interleave(k, 0), self)

    def cost(self, zt):
        s = self._rep(zt.shape[0])
        return self.problem.cost(zt * s.z_scale, s.theta) * s.f_scale

    def eq(self, zt):
        s = self._rep(zt.shape[0])
        return self.problem.eq(zt * s.z_scale, s.theta) * s.eq_scale

    def ineq(self, zt):
        s = self._rep(zt.shape[0])
        return self.problem.ineq(zt * s.z_scale, s.theta) * s.ineq_scale

    def to_scaled(self, z):
        return z / self.z_scale

    def from_scaled(self, z_tilde):
        return z_tilde * self.z_scale

    # multipliers transform with the row/objective scales: lam = lam_s * S_g
    # / s_f, y = y_s * S_e / s_f; slacks s = s_s / S_g
    def duals_from_scaled(self, lam_s, y_s):
        f = self.f_scale[:, None]
        return lam_s * self.ineq_scale / f, y_s * self.eq_scale / f

    def duals_to_scaled(self, lam, y):
        f = self.f_scale[:, None]
        return lam * f / self.ineq_scale, y * f / self.eq_scale

    def slacks_from_scaled(self, s_s):
        return s_s / self.ineq_scale

    def slacks_to_scaled(self, s):
        return s * self.ineq_scale


def _row_inf_norms(fn, z0, d, chunk=256):
    """|J diag(d)|_inf per row of fn at z0, per lane: (B, m).

    Chunked vector-Jacobian rows (one-hot cotangents, vmapped), so live
    memory is chunk x B x n instead of a dense (B, m, n) Jacobian."""
    out, vjp_fn = vjp(fn, z0)
    B, m = out.shape
    eye = torch.eye(m, dtype=z0.dtype, device=z0.device)
    norms = []
    for c0 in range(0, m, chunk):
        cot = eye[c0 : c0 + chunk, None, :].expand(-1, B, m)
        rows = vmap(vjp_fn)(cot)[0]  # (chunk, B, n)
        norms.append((rows.abs() * d).amax(-1))
    return torch.cat(norms).T


def scale_problem(problem, theta, z0, z_scale=None,
                  g_max: float = 50.0) -> ScaledNLP:
    """Build the scaled NLP of B lanes at their reference points z0 (B, n)."""
    B, n = z0.shape
    d = (torch.ones_like(z0) if z_scale is None
         else torch.as_tensor(z_scale, dtype=z0.dtype, device=z0.device).expand(B, n))

    def cost(z):
        return problem.cost(z, theta)

    def eq(z):
        return problem.eq(z, theta)

    def ineq(z):
        return problem.ineq(z, theta)

    _, vjp_cost = vjp(cost, z0)
    gf = vjp_cost(torch.ones(B, dtype=z0.dtype, device=z0.device))[0] * d
    f_scale = torch.clamp(g_max / torch.clamp(gf.abs().amax(-1), min=1e-8), max=1.0)
    eq_scale = torch.clamp(g_max / torch.clamp(_row_inf_norms(eq, z0, d), min=1e-8), max=1.0)
    ineq_scale = torch.clamp(g_max / torch.clamp(_row_inf_norms(ineq, z0, d), min=1e-8), max=1.0)
    return ScaledNLP(problem=problem, theta=theta, z_scale=d.contiguous(), f_scale=f_scale,
                     eq_scale=eq_scale, ineq_scale=ineq_scale)


def landing_z_scale(problem) -> np.ndarray:
    """Static per-variable scales for the landing decision layout
    [X(:); jpos(:); U(:)]: X rows positions/orientation O(1), rates O(5);
    joint angles O(1); U foot positions O(1), GRFs O(f_max/4 ~ 50 N)."""
    n = problem.config.n_knots
    x_row = np.array([1, 1, 1, 1, 1, 1, 5, 5, 5, 5, 5, 5], dtype=np.float64)
    u_row = np.concatenate([np.ones(12), 50.0 * np.ones(12)])
    jpos = np.ones(problem.config.n_joints * (n - 1))
    return np.concatenate([np.tile(x_row, n), jpos, np.tile(u_row, n - 1)])
