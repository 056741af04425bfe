"""Landing NLP transcriptions, batch-first: kinodynamic (production) and
the SRBM-LCP family.

- **kinodynamic**: the production landing problem
  (main_scripts/landing_optimization.m:39-201): decision vars X (12xN),
  jpos (12x(N-1)), U (24x(N-1)); XYZ rotation convention; velocity-scaled
  asymmetric kinematic box; Jacobian-transpose torque limits; FK-consistency
  band; relaxed LCP + no-slip complementarity (eps = 1e-3).  Its
  **kinodynamic_voltage** variant adds the motor back-EMF voltage rows
  (test_finalOptimization_voltageLimits.m:178-187), which couple adjacent
  knots' joint angles.
- **srbm_lcp**: the IPOPT warm-start problem
  (generate_solver/generate_landingCtrller_IPOPT_warmstart.m:41-170): no
  joint variables, legacy ZYX rotation, fixed symmetric kinematic box, f_max
  bound, state boxes every knot, no-slip eps = 1e-2.  Its variants:
  **sliding** (kinetic-friction complementarity in place of no-slip),
  **ccc** (tighter box, running GRF cost, N=41) and **contact_scheduled**
  (contact schedule as a parameter, equality ground/no-slip contacts).

All share the SRBM Euler dynamics defects and the terminal quadratic cost.

Layout: the flat decision vector is the reference's ``[X(:); jpos(:); U(:)]``
(knot-major).  Every function takes a leading batch dimension: z (B, n),
and every field of :class:`LandingParams` carries the same leading B.  The
per-knot row functions (``_knot_ineq_srbm`` and friends) take any leading
dimensions and read per-knot parameters from a dict (:func:`knot_params`),
so the solver can also call them on one knot at a time under
``torch.func.vmap`` for per-knot Jacobians.

Inequalities are canonical ``g(z) >= 0``; equalities ``E(z) = 0``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dynamics import legs
from ..dynamics.rotations import rpy_to_rot_xyz, rpy_to_rot_zyx
from ..dynamics.srbm import srbm_xdot
from ..dynamics.srbm import srbm_xdot_zyx as _srbm_xdot_zyx

__all__ = [
    "LandingParams",
    "LandingVars",
    "LandingConfig",
    "LandingProblem",
    "kinodynamic_problem",
    "kinodynamic_voltage_problem",
    "srbm_lcp_problem",
    "sliding_problem",
    "ccc_problem",
    "contact_scheduled_problem",
    "knot_params",
]


@dataclasses.dataclass(frozen=True)
class LandingParams:
    """Runtime problem parameters, one field per reference ``opti.parameter``
    (landing_optimization.m:50-83; generate_landingCtrller_IPOPT_warmstart.m:50-76),
    each with a leading batch dimension B."""

    x_ref: torch.Tensor  # (B, N, 12) state reference
    u_ref: torch.Tensor  # (B, N-1, 24) control reference
    dt: torch.Tensor  # (B, N-1)
    q_init: torch.Tensor  # (B, 6)
    qd_init: torch.Tensor  # (B, 6)
    c_init: torch.Tensor  # (B, 12) initial foot positions (head equality rows)
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
    # running-cost weights (contact-scheduled / CCC variants,
    # quadruped_SRBM_NLP.m:82-91); None for terminal-cost-only problems
    qx: torch.Tensor | None = None  # (B, 12)
    qc: torch.Tensor | None = None  # (B, 3)
    qf: torch.Tensor | None = None  # (B, 3)
    cs: torch.Tensor | None = None  # (B, N-1, 4) contact schedule parameter

    @property
    def batch(self) -> int:
        return self.x_ref.shape[0]


@dataclasses.dataclass(frozen=True)
class LandingVars:
    """Structured decision variables (leading batch dimension)."""

    X: torch.Tensor  # (B, N, 12)
    jpos: torch.Tensor  # (B, N-1, 12); (B, N-1, 0) for the srbm family
    U: torch.Tensor  # (B, N-1, 24)


@dataclasses.dataclass(frozen=True)
class LandingConfig:
    """Static problem configuration (the JAX package's fields and defaults)."""

    n_knots: int = 21
    kinodynamic: bool = True
    rotation: str = "xyz"  # "xyz" (production) or "zyx" (warm-start NLP)
    lcp_eps: float = 1e-3  # f_z * c_z <= eps  (landing_optimization.m:139)
    noslip_eps: float = 1e-3  # |f_z * dc| <= eps (kino 1e-3; srbm 1e-2)
    friction_pyramid_factor: float = 0.71  # landing_optimization.m:175-178
    # kinematic box (kinodynamic variant, landing_optimization.m:149-163)
    kin_box_x0: float = 0.125
    kin_box_y0: float = 0.10
    kin_box_z_upper: float = -0.075
    kin_box_z_lower: float = -0.4
    kin_box_y_inner: float = 0.05
    # srbm variant fixed box (generate_landingCtrller_IPOPT_warmstart.m:152-159)
    srbm_kin_box_x: float = 0.15
    srbm_kin_box_y: float = 0.15
    srbm_kin_box_z: float = 0.30
    srbm_kin_box_z_offset: float = 0.05
    hip_srbm_location: tuple = ((0.19, -0.1, 0.0), (0.19, 0.1, 0.0), (-0.19, -0.1, 0.0), (-0.19, 0.1, 0.0))
    side_sign: tuple = (-1.0, 1.0, -1.0, 1.0)
    tau_max: tuple = (18.0, 18.0, 28.0)
    # variant switches
    sliding: bool = False  # kinetic-friction sliding complementarity
    contact_scheduled: bool = False  # cs parameter, equality contacts
    running_cost: bool = False  # QX/Qc/Qf running terms
    terminal_box: bool = True  # terminal state box rows
    init_foot_eq: bool = False  # c_0 == c_init equality
    lcp_rows: bool = True  # complementarity rows (off for scheduled)
    voltage_limit: bool = False  # motor back-EMF voltage rows (dense KKT path only)
    # cost p_hip nominal offsets (quadruped_SRBM_NLP.m:78-80)
    p_hip_cost: tuple = (
        (0.19, -0.1, -0.2), (0.19, 0.1, -0.2), (-0.19, -0.1, -0.2), (-0.19, 0.1, -0.2)
    )

    @property
    def n_states(self) -> int:
        return 12

    @property
    def n_controls(self) -> int:
        return 24

    @property
    def n_joints(self) -> int:
        return 12 if self.kinodynamic else 0


# per-knot parameter fields the knot rows, the running cost and the dynamics
# read (the optional ones only where the parameter set carries them)
_KNOT_FIELDS = ("mu", "f_max", "l_leg_max", "q_min", "q_max", "qd_min", "qd_max",
                "mass", "ib", "ib_inv", "kin_box", "jpos_min", "jpos_max", "qx", "qc", "qf")


def knot_params(theta: LandingParams, n_knots: int) -> dict:
    """Per-knot parameter dict with leading (B, N-1): the theta fields the
    knot rows read, broadcast over knots, plus ``dt``, the references of
    knots 0..N-2, the contact schedule ``cs`` where there is one, and the
    no-slip mask (no-slip is inactive at the last interior knot,
    landing_optimization.m:140)."""
    B, K = theta.batch, n_knots - 1
    kp = {}
    for name in _KNOT_FIELDS:
        v = getattr(theta, name)
        if v is not None:
            kp[name] = v[:, None].expand((B, K) + v.shape[1:])
    kp["dt"] = theta.dt
    kp["x_ref"] = theta.x_ref[:, :-1]
    kp["u_ref"] = theta.u_ref
    if theta.cs is not None:
        kp["cs"] = theta.cs
    ns = (torch.arange(K, device=theta.dt.device) < (K - 1)).to(theta.dt.dtype)
    kp["ns_mask"] = ns.expand(B, K)
    return kp


def _tile4(v):
    """(..., 3) -> (..., 12): the per-axis weights repeated for the 4 legs."""
    return torch.cat([v, v, v, v], -1)


class LandingProblem:
    """Transcribed landing NLP: cost / eq / ineq over flat z (B, n)."""

    def __init__(self, config: LandingConfig, robot_params):
        self.config = config
        self.robot_params = robot_params
        n = config.n_knots
        self.n_vars = 12 * n + config.n_joints * (n - 1) + 24 * (n - 1)
        head = 12 + (12 if (config.kinodynamic or config.init_foot_eq) else 0)
        contact_eq = (4 + 12) * (n - 1) if config.contact_scheduled else 0
        self.n_eq = head + 12 * (n - 1) + contact_eq
        self.n_ineq = self._count_ineq()

    # ---------------------------------------------------------------- pack
    def pack(self, v: LandingVars) -> torch.Tensor:
        """Structured -> flat, reference layout [X(:); jpos(:); U(:)]."""
        B = v.X.shape[0]
        parts = [v.X.reshape(B, -1)]
        if self.config.kinodynamic:
            parts.append(v.jpos.reshape(B, -1))
        parts.append(v.U.reshape(B, -1))
        return torch.cat(parts, -1)

    def unpack(self, z: torch.Tensor) -> LandingVars:
        n = self.config.n_knots
        nj = self.config.n_joints
        B = z.shape[0]
        nx = 12 * n
        X = z[:, :nx].reshape(B, n, 12)
        jpos = z[:, nx : nx + nj * (n - 1)].reshape(B, n - 1, nj)
        U = z[:, nx + nj * (n - 1) :].reshape(B, n - 1, 24)
        return LandingVars(X=X, jpos=jpos, U=U)

    # ---------------------------------------------------------------- cost
    def _stage_cost(self, x, u, kp):
        """Running QX/Qc/Qf cost of one knot (quadruped_SRBM_NLP.m:82-91),
        any leading dims."""
        p_hip = torch.tensor(self.config.p_hip_cost, dtype=x.dtype, device=x.device).reshape(12)
        x_err = x - kp["x_ref"]
        pf_err = _tile4(x[..., 0:3]) + p_hip - u[..., :12]
        f_err = u[..., 12:] - kp["u_ref"][..., 12:]
        return (
            (kp["qx"] * x_err * x_err).sum(-1)
            + (_tile4(kp["qc"]) * pf_err * pf_err).sum(-1)
            + (_tile4(kp["qf"]) * f_err * f_err).sum(-1)
        ) * kp["dt"]

    def cost(self, z: torch.Tensor, theta: LandingParams) -> torch.Tensor:
        """Terminal quadratic cost (landing_optimization.m:83-86), plus the
        running QX/Qc/Qf terms for the scheduled/CCC variants; (B,)."""
        v = self.unpack(z)
        err = v.X[:, -1] - theta.x_ref[:, -1]
        total = (theta.qn * err * err).sum(-1)
        if self.config.running_cost:
            kp = knot_params(theta, self.config.n_knots)
            total = total + self._stage_cost(v.X[:, :-1], v.U, kp).sum(-1)
        return total

    # ------------------------------------------------------------ equality
    def eq(self, z: torch.Tensor, theta: LandingParams) -> torch.Tensor:
        """[x0 - x_init; (c0 - c_init); dynamics defects; (scheduled contact
        equalities)] = 0, (B, n_eq)."""
        cfg = self.config
        v = self.unpack(z)
        B = z.shape[0]
        n = cfg.n_knots
        x_init = torch.cat([theta.q_init, theta.qd_init], -1)
        parts = [v.X[:, 0] - x_init]
        if cfg.kinodynamic or cfg.init_foot_eq:
            parts.append(v.U[:, 0, :12] - theta.c_init)
        xdot = self._xdot(v.X[:, :-1], v.U, theta.mass[:, None], theta.ib[:, None],
                          theta.ib_inv[:, None])
        defects = v.X[:, 1:] - v.X[:, :-1] - xdot * theta.dt[..., None]
        parts.append(defects.reshape(B, -1))
        if cfg.contact_scheduled:
            # cs_leg * c_z = 0 (foot pinned to ground while in contact) and
            # cs_leg * (c_{k+1} - c_k) = 0 (no slip), quadruped_SRBM_NLP.m:158-163.
            # The z no-slip row is linearly dependent on consecutive ground
            # rows whenever both knots are in stance; it is kept only across
            # liftoff transitions (cs_k=1, cs_{k+1}=0), the only case where it
            # adds information.
            cz = v.U[:, :, 2:12:3]  # (B, N-1, 4)
            ground = (theta.cs * cz).reshape(B, -1)
            c_next = torch.cat([v.U[:, 1:, :12], v.U[:, -1:, :12]], 1)
            dc = (c_next - v.U[..., :12]).reshape(B, n - 1, 4, 3)
            parts += [ground, (self.noslip_weights(theta.cs) * dc).reshape(B, -1)]
        return torch.cat(parts, -1)

    @staticmethod
    def noslip_weights(cs):
        """(B, N-1, 4, 3) weights of the scheduled no-slip rows
        cs_leg * (c_{k+1} - c_k): x and y while in stance, z only across a
        liftoff (cs_k = 1, cs_{k+1} = 0); none at the last interior knot."""
        K = cs.shape[1]
        cs_next = torch.cat([cs[:, 1:], cs[:, -1:]], 1)
        ns_mask = (torch.arange(K, device=cs.device) < (K - 1)).to(cs.dtype)
        return torch.stack([cs, cs, cs * (1.0 - cs_next)], -1) * ns_mask[:, None, None]

    def _xdot(self, x, u, mass, ib, ib_inv):
        if self.config.rotation == "xyz":
            return srbm_xdot(x, u, mass, ib, ib_inv)
        # legacy ZYX variant (generate_landingCtrller_IPOPT_warmstart.m:116-130)
        return _srbm_xdot_zyx(x, u, mass, ib, ib_inv)

    # ---------------------------------------------------------- inequality
    def _row_groups(self):
        """(label, size) of the per-knot inequality row groups, in order, and
        the labels on the solver's mu-proportional relaxation homotopy."""
        c = self.config
        if c.contact_scheduled:
            # flight legs pinch 0 <= fz <= cs*f_max to a point; without a
            # mu-proportional interior both multipliers blow up (~mu/br) and
            # the complementarity error deadlocks the barrier schedule
            return ([("fz", 4), ("fz_sched", 4), ("kinbox", 24), ("leglen", 4),
                     ("fric", 16), ("statebox", 24)], {"fz", "fz_sched"})
        if c.kinodynamic:
            return ([("fz", 4), ("cz", 4), ("lcp", 4), ("ns_hi", 12), ("ns_lo", 12),
                     ("kinbox", 24), ("leglen", 4), ("torque", 24), ("fric", 16),
                     ("z_bound", 1), ("fk_band", 24), ("jlim", 24)],
                    {"lcp", "ns_hi", "ns_lo", "fk_band"})
        if c.sliding:
            # slide: residual + dissipativity rows
            return ([("fz", 4), ("fmax", 4), ("cz", 4), ("lcp", 4), ("slide", 24),
                     ("kinbox", 24), ("leglen", 4), ("fric", 16), ("statebox", 24)],
                    {"lcp", "slide"})
        return ([("fz", 4), ("fmax", 4), ("cz", 4), ("lcp", 4), ("ns_hi", 12),
                 ("ns_lo", 12), ("kinbox", 24), ("leglen", 4), ("fric", 16),
                 ("statebox", 24)], {"lcp", "ns_hi", "ns_lo"})

    def _count_ineq(self) -> int:
        n = self.config.n_knots
        per_knot = sum(sz for _, sz in self._row_groups()[0])
        n_volt = 24 * (n - 2) if self.config.voltage_limit else 0
        return per_knot * (n - 1) + (24 if self.config.terminal_box else 0) + n_volt

    def ineq_row_labels(self):
        """Human-readable label per inequality row (diagnostics)."""
        groups, _ = self._row_groups()
        labels = []
        for k in range(self.config.n_knots - 1):
            for name, sz in groups:
                labels += [f"k{k}:{name}[{i}]" for i in range(sz)]
        if self.config.terminal_box:
            labels += [f"terminal[{i}]" for i in range(24)]
        if self.config.voltage_limit:
            for k in range(1, self.config.n_knots - 1):
                labels += [f"k{k}:volt[{i}]" for i in range(24)]
        return labels

    def relax_mask(self) -> np.ndarray:
        """Mask of degenerate complementarity rows for the solver's
        mu-proportional relaxation homotopy."""
        groups, marked = self._row_groups()
        row = np.concatenate(
            [np.full(sz, 1.0 if name in marked else 0.0) for name, sz in groups]
        )
        tail = np.zeros(24 if self.config.terminal_box else 0)
        volt = np.zeros(24 * (self.config.n_knots - 2) if self.config.voltage_limit else 0)
        return np.concatenate([np.tile(row, self.config.n_knots - 1), tail, volt])

    def knot_ineq(self, x_k, u_k, jpos_k, c_next, kp):
        """The inequality rows of one knot for this problem's kind (any
        leading dims); ``kp``: the per-knot parameters of :func:`knot_params`."""
        if self.config.contact_scheduled:
            return self._knot_ineq_scheduled(x_k, u_k, kp["cs"], kp)
        if self.config.kinodynamic:
            return self._knot_ineq_kino(x_k, u_k, jpos_k, c_next, kp["ns_mask"], kp)
        return self._knot_ineq_srbm(x_k, u_k, c_next, kp["ns_mask"], kp)

    def ineq(self, z: torch.Tensor, theta: LandingParams) -> torch.Tensor:
        v = self.unpack(z)
        B = z.shape[0]
        kp = knot_params(theta, self.config.n_knots)
        c_next = torch.cat([v.U[:, 1:, :12], v.U[:, -1:, :12]], 1)  # last row unused
        parts = [self.knot_ineq(v.X[:, :-1], v.U, v.jpos, c_next, kp).reshape(B, -1)]
        if self.config.terminal_box:
            parts.append(self._terminal_ineq(v.X[:, -1], theta))
        if self.config.voltage_limit:
            parts.append(self._voltage_rows(v, theta))
        return torch.cat(parts, -1)

    def _voltage_rows(self, v, theta):
        """Motor terminal-voltage rows |i R_m + back-EMF| <= V_batt
        (test_finalOptimization_voltageLimits.m:178-187; back-EMF model as
        plot_results.m:23-38): one row pair [V - v, v + V] per joint for knots
        k = 1..N-2, with the joint velocity from the backward difference
        (jpos_k - jpos_{k-1}) / dt(1).  The reference divides by the FIRST dt,
        not dt_k; so does this.  (B, 24 (N-2))."""
        rp = self.robot_params
        X = v.X
        gr = torch.tensor([rp.abad_gear_ratio, rp.hip_gear_ratio, rp.knee_gear_ratio] * 4,
                          dtype=X.dtype, device=X.device)
        tau = legs.leg_torques(rp, v.jpos[:, 1:], X[:, 1:-1, 3:6], v.U[:, 1:, 12:])
        current = (tau / gr) / (1.5 * rp.motor_kt)
        jvel = (v.jpos[:, 1:] - v.jpos[:, :-1]) / theta.dt[:, :1, None]
        volt = current * rp.motor_r + jvel * gr * rp.motor_kt * 2.0
        rows = torch.cat([rp.battery_v - volt, volt + rp.battery_v], -1)
        return rows.reshape(X.shape[0], -1)

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

    def _srbm_box(self, p_rel):
        """The srbm family's fixed kinematic box rows (24)."""
        cfg = self.config
        px, py, pz = p_rel[..., 0], p_rel[..., 1], p_rel[..., 2]
        return torch.cat(
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

    @staticmethod
    def _state_box(x_k, kp):
        q, qd = x_k[..., :6], x_k[..., 6:]
        return torch.cat(
            [q - kp["q_min"], kp["q_max"] - q, qd - kp["qd_min"], kp["qd_max"] - qd], -1
        )

    # --- kinodynamic knot --------------------------------------------------
    def _knot_ineq_kino(self, x_k, u_k, jpos_k, c_next, ns_mask, kp):
        """The 157 inequality rows of one kinodynamic knot (any leading dims)."""
        cfg = self.config
        rpy = x_k[..., 3:6]
        R_b2w = rpy_to_rot_xyz(rpy)
        fz, cz, lcp, ns_hi, ns_lo = self._contact_core(
            x_k, u_k, c_next, ns_mask, cfg.noslip_eps
        )
        p_rel = self._p_rel(x_k, u_k, R_b2w)
        px, py, pz = p_rel[..., 0], p_rel[..., 1], p_rel[..., 2]

        # velocity-scaled kinematic box (landing_optimization.m:149-163)
        kbx = cfg.kin_box_x0 + kp["kin_box"][..., 0:1]
        kby = cfg.kin_box_y0 + kp["kin_box"][..., 1:2]
        right = torch.tensor(cfg.side_sign, dtype=x_k.dtype, device=x_k.device) < 0
        inner = torch.full_like(kby, cfg.kin_box_y_inner)
        y_upper = torch.where(right, inner, kby)
        y_lower = torch.where(right, -kby, -inner)
        box = torch.cat(
            [
                kbx - px,
                px + kbx,
                y_upper - py,
                py - y_lower,
                cfg.kin_box_z_upper - pz,
                pz - cfg.kin_box_z_lower,
            ],
            -1,
        )
        leg_len = kp["l_leg_max"][..., None] ** 2 - (p_rel * p_rel).sum(-1)

        # torque limits tau = J' (-R_w2b f) (landing_optimization.m:167-171)
        tau = legs.leg_torques(self.robot_params, jpos_k, rpy, u_k[..., 12:])
        tau_max = torch.tensor(cfg.tau_max * 4, dtype=x_k.dtype, device=x_k.device)
        torque = torch.cat([tau_max - tau, tau + tau_max], -1)

        fric = self._friction(u_k, kp)
        z_bound = x_k[..., 2:3] - kp["q_min"][..., 2:3]

        # FK consistency band (landing_optimization.m:184-187)
        feet = legs.foot_positions_world(self.robot_params, x_k[..., :6], jpos_k)
        fk_err = u_k[..., :12] - feet.reshape(feet.shape[:-2] + (12,))
        fk_band = torch.cat([0.01 - fk_err, fk_err + 0.01], -1)
        jl = torch.cat([jpos_k - kp["jpos_min"], kp["jpos_max"] - jpos_k], -1)

        return torch.cat(
            [fz, cz, lcp, ns_hi, ns_lo, box, leg_len, torque, fric, z_bound, fk_band, jl], -1
        )

    # --- contact-scheduled knot (quadruped_SRBM_NLP.m:120-186) -------------
    def _knot_ineq_scheduled(self, x_k, u_k, cs_k, kp):
        """The 76 inequality rows of one contact-scheduled knot; cs_k (..., 4)."""
        R_b2w = rpy_to_rot_zyx(x_k[..., 3:6])
        fz = u_k[..., 12:].reshape(u_k.shape[:-1] + (4, 3))[..., 2]
        fz_sched = cs_k * kp["f_max"][..., None] - fz  # flight legs carry no force
        p_rel = self._p_rel(x_k, u_k, R_b2w)
        leg_len = kp["l_leg_max"][..., None] ** 2 - (p_rel * p_rel).sum(-1)
        return torch.cat(
            [fz, fz_sched, self._srbm_box(p_rel), leg_len, self._friction(u_k, kp),
             self._state_box(x_k, kp)], -1
        )

    # --- srbm knot ---------------------------------------------------------
    def _knot_ineq_srbm(self, x_k, u_k, c_next, ns_mask, kp):
        """The 108 inequality rows of one srbm knot (any leading dims)."""
        cfg = self.config
        R_b2w = rpy_to_rot_zyx(x_k[..., 3:6])
        fz, cz, lcp, ns_hi, ns_lo = self._contact_core(
            x_k, u_k, c_next, ns_mask, cfg.noslip_eps
        )
        if cfg.sliding:
            # Kinetic-friction sliding complementarity
            # (main_scripts/landing_optimization_sliding.m:150-165), in the
            # symmetric per-axis form of the JAX package:
            #   (a) slip _|_ cone residual:
            #       fz/f_max * dc_t * (lim^2 - f_t^2)/f_max in [-eps, eps]
            #       (a loaded foot may slip only when |f_t| saturates the
            #       pyramid limit lim = 0.71 mu fz);
            #   (b) dissipativity: fz/f_max * dc_t * f_t/f_max <= eps
            #       (kinetic friction opposes the slip direction).
            # The fz factor keeps unloaded (swing) feet free; the 1/f_max^2
            # normalization keeps the quartic row O(1) for the row scaling.
            # Both groups ride the mu-proportional relaxation homotopy.
            lead = u_k.shape[:-1]
            c = u_k[..., :12].reshape(lead + (4, 3))
            f = u_k[..., 12:].reshape(lead + (4, 3))
            dc = (c_next.reshape(lead + (4, 3)) - c) / kp["dt"][..., None, None]
            lim = cfg.friction_pyramid_factor * kp["mu"][..., None] * f[..., 2]
            eps = cfg.noslip_eps
            w = f[..., 2] / (kp["f_max"] * kp["f_max"])[..., None]
            m = ns_mask[..., None]
            rows = []
            for ax in (0, 1):
                resid = w * dc[..., ax] * (lim * lim - f[..., ax] * f[..., ax])
                rows.append(m * (eps - resid) + (1.0 - m))
                rows.append(m * (resid + eps) + (1.0 - m))
                dissip = w * dc[..., ax] * f[..., ax]
                rows.append(m * (eps - dissip) + (1.0 - m))
            ns_hi, ns_lo = torch.cat(rows, -1), fz[..., :0]
        fmax_rows = kp["f_max"][..., None] - fz
        p_rel = self._p_rel(x_k, u_k, R_b2w)
        leg_len = kp["l_leg_max"][..., None] ** 2 - (p_rel * p_rel).sum(-1)
        return torch.cat(
            [fz, fmax_rows, cz, lcp, ns_hi, ns_lo, self._srbm_box(p_rel), leg_len,
             self._friction(u_k, kp), self._state_box(x_k, kp)], -1
        )


def kinodynamic_problem(robot_params, n_knots: int = 21) -> LandingProblem:
    """The production kinodynamic landing NLP (landing_optimization.m)."""
    cfg = LandingConfig(n_knots=n_knots, kinodynamic=True, rotation="xyz", noslip_eps=1e-3)
    return LandingProblem(cfg, robot_params)


def kinodynamic_voltage_problem(robot_params, n_knots: int = 21) -> LandingProblem:
    """Kinodynamic NLP + motor back-EMF voltage limit rows
    (test_finalOptimization_voltageLimits.m:178-187).  The voltage rows couple
    adjacent knots' joint angles, so the variant runs on the dense KKT path."""
    base = kinodynamic_problem(robot_params, n_knots=n_knots)
    return LandingProblem(dataclasses.replace(base.config, voltage_limit=True), robot_params)


def srbm_lcp_problem(robot_params, n_knots: int = 21) -> LandingProblem:
    """The SRBM-LCP warm-start NLP (generate_landingCtrller_IPOPT_warmstart.m)."""
    cfg = LandingConfig(n_knots=n_knots, kinodynamic=False, rotation="zyx", noslip_eps=1e-2)
    return LandingProblem(cfg, robot_params)


def sliding_problem(robot_params, n_knots: int = 18) -> LandingProblem:
    """Sliding-contact landing NLP, N=18, T=0.6
    (main_scripts/landing_optimization_sliding.m:29-32,150-165): srbm_lcp
    family with kinetic-friction sliding complementarity on the tangential
    foot velocity instead of no-slip."""
    cfg = LandingConfig(
        n_knots=n_knots, kinodynamic=False, rotation="zyx", noslip_eps=1e-3,
        sliding=True,
    )
    return LandingProblem(cfg, robot_params)


def ccc_problem(robot_params, n_knots: int = 41) -> LandingProblem:
    """Contact-implicit CCC envelope NLP, N=41, T=0.6
    (generate_solver/generate_quadruped_SRBM_CCC.m:28-186): srbm_lcp family
    with the tighter 0.05/0.05/0.27 kinematic box and a running GRF cost."""
    cfg = LandingConfig(
        n_knots=n_knots,
        kinodynamic=False,
        rotation="zyx",
        noslip_eps=1e-2,
        srbm_kin_box_x=0.05,
        srbm_kin_box_y=0.05,
        srbm_kin_box_z=0.27,
        running_cost=True,
    )
    return LandingProblem(cfg, robot_params)


def contact_scheduled_problem(robot_params, n_knots: int = 16) -> LandingProblem:
    """Contact-scheduled NLP, N=16, T=0.5 (quadruped_SRBM_NLP.m:29-186):
    contact schedule cs as a parameter, equality ground/no-slip contacts,
    running + terminal cost, no terminal box."""
    cfg = LandingConfig(
        n_knots=n_knots,
        kinodynamic=False,
        rotation="zyx",
        contact_scheduled=True,
        running_cost=True,
        terminal_box=False,
        lcp_rows=False,
        srbm_kin_box_x=0.05,
        srbm_kin_box_y=0.05,
        srbm_kin_box_z=0.27,
    )
    return LandingProblem(cfg, robot_params)
