"""The SRBM-LCP landing NLP transcription, batch-first.

The srbm_lcp member of the reference's NLP family
(generate_solver/generate_landingCtrller_IPOPT_warmstart.m:41-170): SRBM
Euler dynamics defects with the legacy ZYX rotation, fixed symmetric
kinematic box, f_max bound, state boxes every knot, relaxed LCP and no-slip
complementarity (eps 1e-2), terminal quadratic cost and terminal state box.

Layout: the flat decision vector is the reference's ``[X(:); U(:)]``
(knot-major).  Every function takes a leading batch dimension: z (B, n),
and every field of :class:`LandingParams` carries the same leading B.  The
per-knot row functions (``_knot_ineq_srbm`` and friends) take any leading
dimensions, so the solver can also call them on one knot at a time under
``torch.func.vmap`` for per-knot Jacobians.

Inequalities are canonical ``g(z) >= 0``; equalities ``E(z) = 0``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dynamics.rotations import rpy_to_rot_zyx
from ..dynamics.srbm import srbm_xdot_zyx as _srbm_xdot_zyx

__all__ = [
    "LandingParams",
    "LandingVars",
    "LandingConfig",
    "LandingProblem",
    "srbm_lcp_problem",
    "knot_params",
]


@dataclasses.dataclass(frozen=True)
class LandingParams:
    """Runtime problem parameters, one field per reference ``opti.parameter``
    (generate_landingCtrller_IPOPT_warmstart.m:50-76), each with a leading
    batch dimension B."""

    x_ref: torch.Tensor  # (B, N, 12) state reference
    u_ref: torch.Tensor  # (B, N-1, 24) control reference
    dt: torch.Tensor  # (B, N-1)
    q_init: torch.Tensor  # (B, 6)
    qd_init: torch.Tensor  # (B, 6)
    c_init: torch.Tensor  # (B, 12) (unused by srbm_lcp)
    q_min: torch.Tensor  # (B, 6)
    q_max: torch.Tensor
    qd_min: torch.Tensor
    qd_max: torch.Tensor
    q_term_min: torch.Tensor
    q_term_max: torch.Tensor
    qd_term_min: torch.Tensor
    qd_term_max: torch.Tensor
    qn: torch.Tensor  # (B, 12) terminal weight diagonal
    jpos_min: torch.Tensor  # (B, 12)
    jpos_max: torch.Tensor
    kin_box: torch.Tensor  # (B, 2)
    mu: torch.Tensor  # (B,)
    l_leg_max: torch.Tensor  # (B,)
    f_max: torch.Tensor  # (B,)
    mass: torch.Tensor  # (B,)
    ib: torch.Tensor  # (B, 3) body inertia diagonal
    ib_inv: torch.Tensor  # (B, 3)

    @property
    def batch(self) -> int:
        return self.x_ref.shape[0]


@dataclasses.dataclass(frozen=True)
class LandingVars:
    """Structured decision variables (leading batch dimension)."""

    X: torch.Tensor  # (B, N, 12)
    jpos: torch.Tensor  # (B, N-1, 0) for srbm_lcp
    U: torch.Tensor  # (B, N-1, 24)


@dataclasses.dataclass(frozen=True)
class LandingConfig:
    """Static problem configuration: the JAX package's fields that the
    srbm_lcp arm reads (the port transcribes that arm only)."""

    n_knots: int = 21
    kinodynamic: bool = False
    lcp_eps: float = 1e-3  # f_z * c_z <= eps
    noslip_eps: float = 1e-2  # |f_z * dc| <= eps
    friction_pyramid_factor: float = 0.71  # landing_optimization.m:175-178
    # fixed kinematic box (generate_landingCtrller_IPOPT_warmstart.m:152-159)
    srbm_kin_box_x: float = 0.15
    srbm_kin_box_y: float = 0.15
    srbm_kin_box_z: float = 0.30
    srbm_kin_box_z_offset: float = 0.05
    hip_srbm_location: tuple = ((0.19, -0.1, 0.0), (0.19, 0.1, 0.0), (-0.19, -0.1, 0.0), (-0.19, 0.1, 0.0))

    # the JAX package's other transcriptions; not ported (raise)
    sliding: bool = False
    contact_scheduled: bool = False
    voltage_limit: bool = False


# per-knot parameter fields the srbm knot rows and dynamics read
_KNOT_FIELDS = ("mu", "f_max", "l_leg_max", "q_min", "q_max", "qd_min", "qd_max",
                "mass", "ib", "ib_inv")


def knot_params(theta: LandingParams, n_knots: int) -> dict:
    """Per-knot parameter dict with leading (B, N-1): the theta fields the
    knot rows read, broadcast over knots, plus ``dt`` and the no-slip mask
    (no-slip is inactive at the last interior knot, landing_optimization.m:140)."""
    B, K = theta.batch, n_knots - 1
    kp = {}
    for name in _KNOT_FIELDS:
        v = getattr(theta, name)
        kp[name] = v[:, None].expand((B, K) + v.shape[1:])
    kp["dt"] = theta.dt
    ns = (torch.arange(K, device=theta.dt.device) < (K - 1)).to(theta.dt.dtype)
    kp["ns_mask"] = ns.expand(B, K)
    return kp


class LandingProblem:
    """Transcribed srbm_lcp landing NLP: cost / eq / ineq over flat z (B, n)."""

    def __init__(self, config: LandingConfig, robot_params):
        if config.kinodynamic or config.sliding or config.contact_scheduled or config.voltage_limit:
            raise NotImplementedError(
                "the PyTorch port transcribes the srbm_lcp problem only"
            )
        self.config = config
        self.robot_params = robot_params
        n = config.n_knots
        self.n_vars = 12 * n + 24 * (n - 1)
        self.n_eq = 12 + 12 * (n - 1)
        self.n_ineq = self._count_ineq()

    # ---------------------------------------------------------------- pack
    def pack(self, v: LandingVars) -> torch.Tensor:
        """Structured -> flat, reference layout [X(:); U(:)]."""
        B = v.X.shape[0]
        return torch.cat([v.X.reshape(B, -1), v.U.reshape(B, -1)], -1)

    def unpack(self, z: torch.Tensor) -> LandingVars:
        n = self.config.n_knots
        B = z.shape[0]
        X = z[:, : 12 * n].reshape(B, n, 12)
        U = z[:, 12 * n :].reshape(B, n - 1, 24)
        return LandingVars(X=X, jpos=z.new_zeros((B, n - 1, 0)), U=U)

    # ---------------------------------------------------------------- cost
    def cost(self, z: torch.Tensor, theta: LandingParams) -> torch.Tensor:
        """Terminal quadratic cost (landing_optimization.m:83-86), (B,)."""
        v = self.unpack(z)
        err = v.X[:, -1] - theta.x_ref[:, -1]
        return (theta.qn * err * err).sum(-1)

    # ------------------------------------------------------------ equality
    def eq(self, z: torch.Tensor, theta: LandingParams) -> torch.Tensor:
        """[x0 - x_init; dynamics defects] = 0, (B, n_eq)."""
        v = self.unpack(z)
        B = z.shape[0]
        x_init = torch.cat([theta.q_init, theta.qd_init], -1)
        xdot = self._xdot(v.X[:, :-1], v.U, theta.mass[:, None], theta.ib[:, None],
                          theta.ib_inv[:, None])
        defects = v.X[:, 1:] - v.X[:, :-1] - xdot * theta.dt[..., None]
        return torch.cat([v.X[:, 0] - x_init, defects.reshape(B, -1)], -1)

    @staticmethod
    def _xdot(x, u, mass, ib, ib_inv):
        return _srbm_xdot_zyx(x, u, mass, ib, ib_inv)

    # ---------------------------------------------------------- inequality
    def _count_ineq(self) -> int:
        n = self.config.n_knots
        per_knot = 4 + 4 + 4 + 4 + 24 + 8 + 8 + 8 + 4 + 16 + 24
        return per_knot * (n - 1) + 24

    def relax_mask(self) -> np.ndarray:
        """Mask of degenerate complementarity rows (LCP + no-slip) for the
        solver's mu-proportional relaxation homotopy."""
        n = self.config.n_knots
        sizes = [4, 4, 4, 4, 12, 12, 24, 4, 16, 24]
        marked = {3, 4, 5}  # lcp, ns_hi, ns_lo
        row = np.concatenate(
            [np.full(sz, 1.0 if i in marked else 0.0) for i, sz in enumerate(sizes)]
        )
        return np.concatenate([np.tile(row, n - 1), np.zeros(24)])

    def ineq(self, z: torch.Tensor, theta: LandingParams) -> torch.Tensor:
        v = self.unpack(z)
        B = z.shape[0]
        n = self.config.n_knots
        kp = knot_params(theta, n)
        c_next = torch.cat([v.U[:, 1:, :12], v.U[:, -1:, :12]], 1)  # last row unused
        rows = self._knot_ineq_srbm(v.X[:, :-1], v.U, c_next, kp["ns_mask"], kp)
        return torch.cat(
            [rows.reshape(B, -1), self._terminal_ineq(v.X[:, -1], theta)], -1
        )

    def _terminal_ineq(self, x_n, theta):
        """Terminal state box (landing_optimization.m:94-97)."""
        q, qd = x_n[..., :6], x_n[..., 6:]
        return torch.cat(
            [
                q - theta.q_term_min,
                theta.q_term_max - q,
                qd - theta.qd_term_min,
                theta.qd_term_max - qd,
            ],
            -1,
        )

    # --- shared pieces (leading dims "...") --------------------------------
    def _contact_core(self, x_k, u_k, c_next, ns_mask, noslip_eps):
        """fz>=0, cz>=0, LCP, masked no-slip."""
        lead = u_k.shape[:-1]
        c = u_k[..., :12].reshape(lead + (4, 3))
        f = u_k[..., 12:].reshape(lead + (4, 3))
        fz = f[..., 2]
        cz = c[..., 2]
        lcp = self.config.lcp_eps - fz * cz
        dc = (c_next.reshape(lead + (4, 3)) - c) * fz[..., None]
        m = ns_mask[..., None, None]
        ns_hi = m * (noslip_eps - dc) + (1.0 - m)
        ns_lo = m * (dc + noslip_eps) + (1.0 - m)
        return fz, cz, lcp, ns_hi.reshape(lead + (12,)), ns_lo.reshape(lead + (12,))

    def _friction(self, u_k, kp):
        """Pyramid |fx|,|fy| <= 0.71 mu fz (landing_optimization.m:175-178)."""
        f = u_k[..., 12:].reshape(u_k.shape[:-1] + (4, 3))
        lim = self.config.friction_pyramid_factor * kp["mu"][..., None] * f[..., 2]
        return torch.cat(
            [lim - f[..., 0], f[..., 0] + lim, lim - f[..., 1], f[..., 1] + lim], -1
        )

    def _p_rel(self, x_k, u_k, R_b2w):
        """Foot positions relative to SRBM hips, world frame, (..., 4, 3)."""
        hips = torch.tensor(self.config.hip_srbm_location, dtype=x_k.dtype, device=x_k.device)
        r_hip = x_k[..., None, :3] + hips @ R_b2w.transpose(-1, -2)
        return u_k[..., :12].reshape(u_k.shape[:-1] + (4, 3)) - r_hip

    def _knot_ineq_srbm(self, x_k, u_k, c_next, ns_mask, kp):
        """The 108 inequality rows of one srbm knot (any leading dims)."""
        cfg = self.config
        R_b2w = rpy_to_rot_zyx(x_k[..., 3:6])
        fz, cz, lcp, ns_hi, ns_lo = self._contact_core(
            x_k, u_k, c_next, ns_mask, cfg.noslip_eps
        )
        fmax_rows = kp["f_max"][..., None] - fz
        p_rel = self._p_rel(x_k, u_k, R_b2w)
        px, py, pz = p_rel[..., 0], p_rel[..., 1], p_rel[..., 2]
        box = torch.cat(
            [
                cfg.srbm_kin_box_x - px,
                px + cfg.srbm_kin_box_x,
                cfg.srbm_kin_box_y - py,
                py + cfg.srbm_kin_box_y,
                -(pz + cfg.srbm_kin_box_z_offset),
                (pz + cfg.srbm_kin_box_z_offset) + cfg.srbm_kin_box_z,
            ],
            -1,
        )
        leg_len = kp["l_leg_max"][..., None] ** 2 - (p_rel * p_rel).sum(-1)
        fric = self._friction(u_k, kp)
        q, qd = x_k[..., :6], x_k[..., 6:]
        state_box = torch.cat(
            [q - kp["q_min"], kp["q_max"] - q, qd - kp["qd_min"], kp["qd_max"] - qd], -1
        )
        return torch.cat(
            [fz, fmax_rows, cz, lcp, ns_hi, ns_lo, box, leg_len, fric, state_box], -1
        )


def srbm_lcp_problem(robot_params, n_knots: int = 21) -> LandingProblem:
    """The SRBM-LCP warm-start NLP (generate_landingCtrller_IPOPT_warmstart.m)."""
    return LandingProblem(LandingConfig(n_knots=n_knots), robot_params)
