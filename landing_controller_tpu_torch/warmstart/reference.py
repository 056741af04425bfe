"""Reference trajectories, default parameters and cold-start guesses.

The SRBM-LCP parameter set (generate_landingCtrller_IPOPT_warmstart.m:168-225),
the production dt schedule, and the two non-learned cold-start guesses.
Batch-first: q_init / qd_init are (B, 6) and every returned field carries B.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dynamics.rotations import rpy_to_rot_xyz
from ..models import srbm_constants
from ..problems.landing import LandingParams, LandingVars

# per-leg xyz sign convention for nominal foot offsets
# (landing_optimization.m:205: sideSign = [1 -1 1, 1 1 1, -1 -1 1, -1 1 1])
FOOT_SIGN = np.array(
    [[1, -1, 1], [1, 1, 1], [-1, -1, 1], [-1, 1, 1]], dtype=np.float64
)

# production dt schedule (landing_optimization.m:28)
DT_PRODUCTION = np.array([0.05] + [0.02] * 15 + [0.05, 0.05, 0.1, 0.2])

HIP_SRBM = np.array(
    [[0.19, -0.1, 0.0], [0.19, 0.1, 0.0], [-0.19, -0.1, 0.0], [-0.19, 0.1, 0.0]]
)


def kin_box_limits(v, direction: str):
    """Velocity-scaled kinematic-box widening (kin_box_limits.m:1-21)."""
    v_max = 2.0
    box_max = 0.15 if direction == "x" else 0.25
    return torch.clamp(torch.abs(v) * (box_max / v_max), max=box_max)


def _linspace_refs(q_init, qd_init, q_term_ref, qd_term_ref, n):
    """State reference: per-dim linspace from init to terminal ref
    (landing_optimization.m:263-266), (B, n, 12)."""
    w = torch.linspace(0.0, 1.0, n, dtype=q_init.dtype, device=q_init.device)[:, None]
    q_ref = q_init[:, None, :] * (1 - w) + q_term_ref * w
    qd_ref = qd_init[:, None, :] * (1 - w) + qd_term_ref * w
    return torch.cat([q_ref, qd_ref], -1)


def srbm_lcp_params(q_init, qd_init, n_knots: int = 21, horizon: float = 0.6,
                    robot: str = "mc3D") -> LandingParams:
    """SRBM-LCP warm-start NLP parameter set
    (generate_landingCtrller_IPOPT_warmstart.m:168-225)."""
    dtype, dev = q_init.dtype, q_init.device
    B = q_init.shape[0]
    n = n_knots
    mass, ib, ib_inv = srbm_constants(robot)

    def const(vals):
        t = torch.as_tensor(np.asarray(vals, np.float64), dtype=dtype, device=dev)
        return t.expand((B,) + t.shape).clone()

    x_ref = _linspace_refs(q_init, qd_init, const([0, 0, 0.275, 0, 0, 0])[:, None],
                           const(np.zeros(6))[:, None], n)
    # foot reference: CoM reference + fixed offset, unrotated
    # (generate_landingCtrller_IPOPT_warmstart.m:205-206)
    c_ref = torch.as_tensor((FOOT_SIGN * np.array([0.2, 0.1, -0.2])).reshape(12),
                            dtype=dtype, device=dev)
    c_knots = x_ref[:, :-1, 0:3].repeat(1, 1, 4) + c_ref
    u_ref = torch.cat([c_knots, torch.zeros_like(c_knots)], -1)
    return LandingParams(
        x_ref=x_ref,
        u_ref=u_ref,
        dt=torch.full((B, n - 1), horizon / (n - 1), dtype=dtype, device=dev),
        q_init=q_init,
        qd_init=qd_init,
        c_init=c_knots[:, 0],  # unused by the srbm problem (no c_init equality)
        q_min=const([-10, -10, 0.1, -10, -10, -10]),
        q_max=const([10, 10, 1.0, 10, 10, 10]),
        qd_min=const([-10, -10, -10, -40, -40, -40]),
        qd_max=const([10, 10, 10, 40, 40, 40]),
        q_term_min=const([-10, -10, 0.2, -0.1, -0.1, -10]),
        q_term_max=const([10, 10, 5, 0.1, 0.1, 10]),
        qd_term_min=const([-10, -10, -10, -40, -40, -40]),
        qd_term_max=const([10, 10, 10, 40, 40, 40]),
        qn=const([0, 0, 100, 100, 100, 0, 10, 10, 10, 10, 10, 10]),
        jpos_min=const(np.tile([-np.pi / 3, -np.pi / 2, 0.0], 4)),
        jpos_max=const(np.tile([np.pi / 3, np.pi / 2, 3 * np.pi / 4], 4)),
        kin_box=const(np.zeros(2)),
        mu=const(1.0),
        l_leg_max=const(0.35),
        f_max=const(200.0),
        mass=const(mass),
        ib=const(ib),
        ib_inv=const(ib_inv),
    )


def ballistic_guess(problem, theta: LandingParams):
    """Physics-informed cold-start guess, (B, n_vars).

    Base position/velocity follow the ballistic arc until the CoM reaches
    stance height, then blend to the terminal reference with velocity
    decaying to zero; Euler angles integrate the initial rates in flight and
    decay to level after touchdown; feet track under the rotated hips,
    clamped to the ground, and freeze at touchdown; GRFs are zero in flight
    and carry weight plus the stopping impulse in stance.  Branch-free
    (masks over knots).
    """
    n = problem.config.n_knots
    dtype, dev = theta.x_ref.dtype, theta.x_ref.device
    B = theta.batch
    g = -9.81
    dt = theta.dt
    t_knot = torch.cat([torch.zeros((B, 1), dtype=dtype, device=dev), torch.cumsum(dt, -1)], -1)

    q0, qd0 = theta.q_init, theta.qd_init
    z_stand = 0.275

    # ballistic CoM: z(t) = z0 + vz t + g t^2/2; touchdown when z hits stance
    z_b = q0[:, 2:3] + qd0[:, 5:6] * t_knot + 0.5 * g * t_knot**2
    vz_b = qd0[:, 5:6] + g * t_knot
    in_flight = z_b > z_stand  # (B, n)
    t_td = torch.where(in_flight, t_knot, torch.zeros_like(t_knot)).amax(-1, keepdim=True)
    t_end = t_knot[:, -1:]
    wb = torch.clamp((t_knot - t_td) / torch.clamp(t_end - t_td, min=1e-3), 0.0, 1.0)

    t_fl = torch.minimum(t_knot, t_td)[..., None]  # (B, n, 1)
    xy_b = q0[:, None, 0:2] + qd0[:, None, 3:5] * t_fl
    z_traj = torch.where(in_flight, z_b, z_stand + (z_b * 0.0))
    rpy_b = q0[:, None, 3:6] + qd0[:, None, 0:3] * t_fl
    rpy_traj = rpy_b * (1.0 - wb[..., None])
    fl = in_flight[..., None]
    v_xy = torch.where(fl, qd0[:, None, 3:5], qd0[:, None, 3:5] * (1 - wb[..., None]))
    v_z = torch.where(in_flight, vz_b, vz_b * 0.0 + torch.clamp(vz_b, max=0.0) * (1 - wb))
    omega = torch.where(fl, qd0[:, None, 0:3], qd0[:, None, 0:3] * (1 - wb[..., None]))

    X = torch.cat([xy_b, z_traj[..., None], rpy_traj, omega, v_xy, v_z[..., None]], -1)

    # feet: under the rotated hips, z clamped to ground; freeze after t_td
    R = rpy_to_rot_xyz(rpy_traj[:, :-1])  # (B, n-1, 3, 3)
    hips = torch.as_tensor(HIP_SRBM, dtype=dtype, device=dev)
    feet = X[:, :-1, None, 0:3] + hips @ R.transpose(-1, -2)  # (B, n-1, 4, 3)
    feet = torch.cat([feet[..., :2], torch.zeros_like(feet[..., 2:])], -1)
    stance_k = in_flight[:, :-1].sum(-1)  # first stance knot, (B,)
    k_idx = torch.arange(n - 1, device=dev)
    td_feet = feet[torch.arange(B, device=dev), torch.clamp(stance_k, max=n - 2)]
    feet = torch.where((k_idx[None] >= stance_k[:, None])[..., None, None], td_feet[:, None], feet)

    # GRFs: zero in flight; in stance, weight + stopping impulse per leg
    t_stop = torch.clamp(t_end - t_td, min=0.1)
    vz_td = qd0[:, 5:6] + g * t_td
    fz_stance = theta.mass[:, None] * (9.81 - vz_td / t_stop) / 4.0  # (B, 1)
    fz_clip = torch.minimum(torch.clamp(fz_stance, min=1.0), theta.f_max[:, None])
    fz = torch.where(in_flight[:, :-1], torch.zeros_like(fz_clip), fz_clip)  # (B, n-1)
    zeros = torch.zeros_like(fz)[..., None, None].expand(B, n - 1, 4, 2)
    grf = torch.cat([zeros, fz[..., None, None].expand(B, n - 1, 4, 1)], -1)

    U = torch.cat([feet.reshape(B, n - 1, 12), grf.reshape(B, n - 1, 12)], -1)
    return problem.pack(LandingVars(X=X, jpos=X.new_zeros((B, n - 1, 0)), U=U))


def initial_guess_from_reference(problem, theta: LandingParams):
    """Cold-start initial guess z0 = [Xref(:); Uref(:)]
    (landing_optimization.m:309)."""
    B, n = theta.batch, problem.config.n_knots
    return problem.pack(
        LandingVars(X=theta.x_ref, jpos=theta.x_ref.new_zeros((B, n - 1, 0)), U=theta.u_ref)
    )
