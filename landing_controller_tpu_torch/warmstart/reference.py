"""Reference trajectories, default parameters and cold-start guesses.

The parameter sets of the landing NLPs (kinodynamic production values,
landing_optimization.m:203-297; SRBM-LCP, generate_landingCtrller_IPOPT_warmstart.m:168-225;
CCC and contact-scheduled variants), the production dt schedule, and the two
non-learned cold-start guesses.  Batch-first: q_init / qd_init are (B, 6)
and every returned field carries B.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
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


def drop_scenario_from_draws(rpy, omega, v):
    """Drop conditions for given attitudes, body rates and velocities (each
    (n, 3)): q_init = [0, 0, z0, rpy], qd_init = [omega, v], with the
    hip-clearance height z0 = 0.35 + |min_leg hip_world_z| + |dt_0 v_z|
    (landing_optimization.m:210-216; dt_0 = DT_PRODUCTION[0], XYZ rotation)."""
    R = rpy_to_rot_xyz(rpy)  # (n, 3, 3)
    hips = torch.as_tensor(HIP_SRBM, dtype=rpy.dtype, device=rpy.device)
    hip_z = (hips @ R.transpose(-1, -2))[..., 2]  # (n, 4)
    z0 = 0.35 + hip_z.amin(-1).abs() + (DT_PRODUCTION[0] * v[:, 2]).abs()
    zeros = torch.zeros_like(z0)
    q_init = torch.cat([torch.stack([zeros, zeros, z0], -1), rpy], -1)
    return q_init, torch.cat([omega, v], -1)


def sample_drop_scenario(n: int, generator: torch.Generator | None = None,
                         dtype=torch.float32, device="cuda"):
    """n random drop conditions -> (q_init (n, 6), qd_init (n, 6)).

    Sampling ranges of the production driver (landing_optimization.m:207-218):
    roll, yaw ~ U(+-0.25), pitch ~ U(+-pi/3), omega ~ U(+-0.5), v_xy ~ U(+-1),
    v_z ~ -U(0.5, 5); the height by :func:`drop_scenario_from_draws`.  The
    draws come from ``generator`` (a fresh one seeded 0 when None) on its
    own device; the result is moved to ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand((n, 9), generator=generator, dtype=dtype, device=generator.device)
    half = torch.as_tensor([0.25, np.pi / 3, 0.25, 0.5, 0.5, 0.5, 1.0, 1.0], dtype=dtype,
                           device=u.device)
    w = (2.0 * u[:, :8] - 1.0) * half
    vz = -4.5 * u[:, 8:9] - 0.5
    q, qd = drop_scenario_from_draws(w[:, 0:3], w[:, 3:6], torch.cat([w[:, 6:8], vz], -1))
    return q.to(device), qd.to(device)


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


def _consts(q_init):
    """const(vals): the numpy constant as a (B, ...) tensor like q_init."""
    B = q_init.shape[0]

    def const(vals):
        t = torch.as_tensor(np.asarray(vals, np.float64), dtype=q_init.dtype, device=q_init.device)
        return t.expand((B,) + t.shape).clone()

    return const


def _unrotated_foot_refs(x_ref):
    """Foot reference: CoM reference + fixed offset, unrotated
    (generate_landingCtrller_IPOPT_warmstart.m:205-206) -> (c_knots, u_ref)."""
    c_ref = torch.as_tensor((FOOT_SIGN * np.array([0.2, 0.1, -0.2])).reshape(12),
                            dtype=x_ref.dtype, device=x_ref.device)
    c_knots = x_ref[:, :-1, 0:3].repeat(1, 1, 4) + c_ref
    return c_knots, torch.cat([c_knots, torch.zeros_like(c_knots)], -1)


def kinodynamic_params(q_init, qd_init, n_knots: int = 21, robot: str = "mc3D") -> LandingParams:
    """Production kinodynamic parameter set (landing_optimization.m:203-297).

    q_init: (B, 6) initial poses (z taken as given; the hip-clearance rule
    belongs to the scenario sampler); qd_init: (B, 6) [omega_body(3),
    v_world(3)].
    """
    dtype, dev = q_init.dtype, q_init.device
    B = q_init.shape[0]
    n = n_knots
    mass, ib, ib_inv = srbm_constants(robot)
    const = _consts(q_init)
    dt = const(DT_PRODUCTION) if n == 21 else torch.full(
        (B, n - 1), 0.6 / (n - 1), dtype=dtype, device=dev)

    x_ref = _linspace_refs(q_init, qd_init, const([0, 0, 0.25, 0, 0, 0])[:, None],
                           const(np.zeros(6))[:, None], n)

    # nominal foot offsets rotated by the reference orientation at each knot
    # (landing_optimization.m:272-277)
    c_ref = torch.as_tensor(FOOT_SIGN * np.array([0.2, 0.2, -0.3]), dtype=dtype, device=dev)
    R_ref = rpy_to_rot_xyz(x_ref[:, :-1, 3:6])  # (B, n-1, 3, 3)
    c_knots = x_ref[:, :-1, None, 0:3] + c_ref @ R_ref.transpose(-1, -2)
    c_knots = c_knots.reshape(B, n - 1, 12)
    u_ref = torch.cat([c_knots, torch.zeros_like(c_knots)], -1)

    # initial foot positions (landing_optimization.m:233-238)
    p_rel0 = torch.as_tensor(FOOT_SIGN * np.array([0.2, 0.15, -0.3]), dtype=dtype, device=dev)
    R0 = rpy_to_rot_xyz(q_init[:, 3:6])  # (B, 3, 3)
    c_init = (q_init[:, None, 0:3] + p_rel0 @ R0.transpose(-1, -2)).reshape(B, 12)

    # velocity-scaled kin box from the body-frame linear velocity
    # (landing_optimization.m:249-251)
    v_body = (R0.transpose(-1, -2) @ qd_init[:, 3:6, None])[..., 0]
    kin_box = torch.stack([kin_box_limits(v_body[:, 0], "x"), kin_box_limits(v_body[:, 1], "y")], -1)

    return LandingParams(
        x_ref=x_ref,
        u_ref=u_ref,
        dt=dt,
        q_init=q_init,
        qd_init=qd_init,
        c_init=c_init,
        q_min=const([-10, -10, 0.075, -10, -10, -10]),
        q_max=const([10, 10, 1.0, 10, 10, 10]),
        qd_min=const([-10, -10, -10, -40, -40, -40]),
        qd_max=const([10, 10, 10, 40, 40, 40]),
        q_term_min=const([-10, -10, 0.15, -0.1, -0.1, -10]),
        q_term_max=const([10, 10, 5, 0.1, 0.1, 10]),
        qd_term_min=const([-10, -10, -10, -0.5, -0.5, -0.5]),
        qd_term_max=const([10, 10, 10, 0.5, 0.5, 0.5]),
        qn=const([0, 0, 100, 10, 10, 0, 10, 10, 10, 10, 10, 10]),
        jpos_min=const(np.tile([-np.pi / 3, -np.pi / 2, 0.0], 4)),
        jpos_max=const(np.tile([np.pi / 3, np.pi / 2, 3 * np.pi / 4], 4)),
        kin_box=kin_box,
        mu=const(0.75),
        l_leg_max=const(0.4),
        f_max=const(300.0),
        mass=const(mass),
        ib=const(ib),
        ib_inv=const(ib_inv),
    )


def srbm_lcp_params(q_init, qd_init, n_knots: int = 21, horizon: float = 0.6,
                    robot: str = "mc3D") -> LandingParams:
    """SRBM-LCP warm-start NLP parameter set
    (generate_landingCtrller_IPOPT_warmstart.m:168-225)."""
    dtype, dev = q_init.dtype, q_init.device
    B = q_init.shape[0]
    n = n_knots
    mass, ib, ib_inv = srbm_constants(robot)
    const = _consts(q_init)

    x_ref = _linspace_refs(q_init, qd_init, const([0, 0, 0.275, 0, 0, 0])[:, None],
                           const(np.zeros(6))[:, None], n)
    c_knots, u_ref = _unrotated_foot_refs(x_ref)
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


def _feet_under_com(q_init):
    """(B, 12): per-leg offset [0.2, 0.1, 0] from the initial CoM position."""
    off = torch.as_tensor((FOOT_SIGN * np.array([0.2, 0.1, 0.0])).reshape(12),
                          dtype=q_init.dtype, device=q_init.device)
    return q_init[:, 0:3].repeat(1, 4) + off


def ccc_params(q_init, qd_init, n_knots: int = 41, horizon: float = 0.6,
               robot: str = "mc3D") -> LandingParams:
    """Contact-implicit CCC envelope NLP parameters
    (generate_solver/generate_quadruped_SRBM_CCC.m:192-223)."""
    base = srbm_lcp_params(q_init, qd_init, n_knots=n_knots, horizon=horizon, robot=robot)
    const = _consts(q_init)
    x_ref = _linspace_refs(q_init, qd_init, const([0, 0, 0.2, 0, 0, 0])[:, None],
                           const(np.zeros(6))[:, None], n_knots)
    _, u_ref = _unrotated_foot_refs(x_ref)
    # feet start on the ground: offset [0.2, 0.1, -z0] from the CoM per leg
    # (generate_quadruped_SRBM_CCC.m:209-210) puts c_init_z at exactly 0
    on_ground = torch.as_tensor(np.tile([1.0, 1.0, 0.0], 4), dtype=q_init.dtype,
                                device=q_init.device)
    return dataclasses.replace(
        base,
        x_ref=x_ref,
        u_ref=u_ref,
        c_init=_feet_under_com(q_init) * on_ground,
        q_min=const([-10, -10, 0.15, -10, -10, -10]),
        qn=const([0, 0, 100, 100, 100, 0, 10, 10, 10, 10, 10, 10]),
        mu=const(1.0),
        l_leg_max=const(0.35),
        f_max=const(250.0),
        qx=const(np.zeros(12)),
        qc=const(np.zeros(3)),
        qf=const([1e-4, 1e-4, 1e-3]),
    )


def default_contact_schedule(n_knots: int = 16) -> np.ndarray:
    """The reference's default landing schedule, (N-1, 4): 2 flight knots
    then full stance (quadruped_SRBM_NLP.m:33)."""
    cs = np.ones((n_knots - 1, 4))
    cs[:2] = 0.0
    return cs


def contact_scheduled_params(q_init, qd_init, n_knots: int = 16, horizon: float = 0.5,
                             robot: str = "mc3D") -> LandingParams:
    """Contact-scheduled NLP parameters (quadruped_SRBM_NLP.m:186-247)."""
    dtype, dev = q_init.dtype, q_init.device
    B = q_init.shape[0]
    n = n_knots
    mass, ib, ib_inv = srbm_constants(robot)
    const = _consts(q_init)
    x_ref = _linspace_refs(q_init, qd_init, const([0, 0, 0.2, 0, 0, 0])[:, None],
                           const(np.zeros(6))[:, None], n)
    _, u_ref = _unrotated_foot_refs(x_ref)
    return LandingParams(
        x_ref=x_ref,
        u_ref=u_ref,
        dt=torch.full((B, n - 1), horizon / (n - 1), dtype=dtype, device=dev),
        q_init=q_init,
        qd_init=qd_init,
        c_init=_feet_under_com(q_init),
        q_min=const([-10, -10, 0.0, -10, -10, -10]),
        q_max=const([10, 10, 0.4, 10, 10, 10]),
        qd_min=const([-10, -10, -10, -40, -40, -40]),
        qd_max=const([10, 10, 10, 40, 40, 40]),
        q_term_min=const([-10, -10, 0.15, -0.1, -0.1, -10]),
        q_term_max=const([10, 10, 5, 0.1, 0.1, 10]),
        qd_term_min=const([-10, -10, -10, -40, -40, -40]),
        qd_term_max=const([10, 10, 10, 40, 40, 40]),
        qn=const([0, 0, 100, 10, 10, 100, 10, 10, 10, 10, 10, 10]),
        jpos_min=const(np.tile([-np.pi / 3, -np.pi / 2, 0.0], 4)),
        jpos_max=const(np.tile([np.pi / 3, np.pi / 2, 3 * np.pi / 4], 4)),
        kin_box=const(np.zeros(2)),
        mu=const(1.0),
        l_leg_max=const(0.3),
        f_max=const(200.0),
        mass=const(mass),
        ib=const(ib),
        ib_inv=const(ib_inv),
        qx=const(np.full(12, 10.0)),
        qc=const(np.zeros(3)),
        qf=const([1e-4, 1e-4, 1e-3]),
        cs=const(default_contact_schedule(n_knots)),
    )


# home-pose joint angles, the jpos guess of the kinodynamic problem
Q_LEG_HOME = np.tile([0.0, -0.8, 1.6], 4)


def _jpos_guess(problem, like):
    """(B, N-1, 12) home-pose joint angles for the kinodynamic problem,
    (B, N-1, 0) otherwise; dtype/device/batch of ``like`` (B, N, 12)."""
    B, n = like.shape[0], problem.config.n_knots
    if not problem.config.kinodynamic:
        return like.new_zeros((B, n - 1, 0))
    home = torch.as_tensor(Q_LEG_HOME, dtype=like.dtype, device=like.device)
    return home.expand(B, n - 1, 12)


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
    return problem.pack(LandingVars(X=X, jpos=_jpos_guess(problem, X), U=U))


def initial_guess_from_reference(problem, theta: LandingParams):
    """Cold-start initial guess z0 = [Xref(:); (home-pose jpos); Uref(:)]
    (landing_optimization.m:309)."""
    return problem.pack(
        LandingVars(X=theta.x_ref, jpos=_jpos_guess(problem, theta.x_ref), U=theta.u_ref)
    )
