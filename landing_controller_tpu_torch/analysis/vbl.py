"""Variational (error-state) dynamics and the Riccati value function,
batch-first.

The reference's VBL pipeline (srbm-utilities/generateVariationalDynamics.m:1-62,
generateRiccatiIntegrator.m:1-63, main script quadruped_SRBM_NLP.m:428-566):

- the 24-state error dynamics (delta_p, delta_eta, delta_omega, delta_v,
  delta_pf) of the SRBM linearized about a reference (x_ref, f_ref): the
  error-state derivative is written out and A, B come from
  ``torch.func.jacfwd`` (the reference differentiates CasADi SX
  symbolically: the same matrices);
- the Riccati differential equation Pdot = A'P + PA - P B R^-1 B' P + Q
  integrated backward (Euler: the reference's RDE_step keeps only k1,
  generateRiccatiIntegrator.m:55) and forward (RK4) along an optimized
  trajectory, one step per loop turn.

Every function takes leading batch dimensions: references (..., 24) and
(..., 12), P (..., 24, 24), trajectories X_star (..., N, 12).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..dynamics.rotations import rpy_to_rot_zyx, skew
from ..dynamics.srbm import cross
from ..models import get_robot_model, srbm_constants
from ..models.model import composite_inertia_np

NUM_STATES = 24
NUM_CONTROL = 12


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def error_state_xdot(delta_x, delta_f, x_ref, f_ref, mass, ib, ib_inv):
    """Continuous error-state derivative (..., 24)
    (generateVariationalDynamics.m:31-52).

    delta_x (..., 24): [dp (3), deta (3), domega (3), dv (3), dpf (12)];
    delta_f (..., 12); x_ref (..., 24): [p, rpy, omega, v, pf (12)]; f_ref
    (..., 12).  ib: (3, 3) body inertia (the full matrix), ib_inv its
    inverse.  The reference takes the legacy ZYX rotation here
    (generateVariationalDynamics.m:33)."""
    batch = torch.broadcast_shapes(delta_x.shape[:-1], delta_f.shape[:-1], x_ref.shape[:-1],
                                   f_ref.shape[:-1])
    delta_x, x_ref = delta_x.expand(batch + (24,)), x_ref.expand(batch + (24,))
    delta_f, f_ref = delta_f.expand(batch + (12,)), f_ref.expand(batch + (12,))
    p, rpy, omega = x_ref[..., 0:3], x_ref[..., 3:6], x_ref[..., 6:9]
    pf = x_ref[..., 12:24].reshape(x_ref.shape[:-1] + (4, 3))
    f = f_ref.reshape(f_ref.shape[:-1] + (4, 3))
    dp, deta, domega, dv = (delta_x[..., 0:3], delta_x[..., 3:6], delta_x[..., 6:9],
                            delta_x[..., 9:12])
    dpf = delta_x[..., 12:24].reshape(delta_x.shape[:-1] + (4, 3))
    df = delta_f.reshape(delta_f.shape[:-1] + (4, 3))

    R = rpy_to_rot_zyx(rpy)  # body-to-world (rpyToRotMat(rpy)' in MATLAB)
    Rt = R.transpose(-1, -2)

    dp_dot = dv
    deta_dot = -_mv(skew(omega), deta) + domega
    # t1: orientation sensitivity of the body-frame contact torque
    tau_body = _mv(Rt[..., None, :, :], cross(pf - p[..., None, :], f)).sum(-2)
    t1 = _mv(skew(tau_body), deta)
    # t2: foot-position, CoM-position and force sensitivities (world frame)
    t2a = -cross(f, dpf).sum(-2)
    t2b = cross(f.sum(-2), dp)
    t2c = cross(pf - p[..., None, :], df).sum(-2)
    # t3: gyroscopic terms
    t3 = _mv(skew(_mv(ib, omega)), domega) - _mv(skew(omega), _mv(ib, domega))
    domega_dot = _mv(ib_inv, t1 + _mv(Rt, t2a + t2b + t2c) + t3)
    dv_dot = df.sum(-2) / mass
    # small stabilizing decay on the foot-position error states
    dpf_dot = -1e-5 * dpf
    dpf_dot = dpf_dot.reshape(dpf_dot.shape[:-2] + (12,))
    return torch.cat([dp_dot, deta_dot, domega_dot, dv_dot, dpf_dot], -1)


@functools.lru_cache(maxsize=8)
def _full_body_inertia(robot: str):
    """The FULL 3x3 composite body inertia at the home pose and its inverse
    (the reference's VBL uses the full matrix, not its diagonal)."""
    model = get_robot_model(robot)
    ic = composite_inertia_np(model, model.q_home)
    return ic[:3, :3].copy(), np.linalg.inv(ic[:3, :3])


def variational_dynamics(x_ref, f_ref, robot: str = "mc3D"):
    """(A (..., 24, 24), B (..., 24, 12)): the error dynamics linearized at
    (x_ref (..., 24), f_ref (..., 12)); the counterparts of the reference's
    CasADi ``Avbl`` / ``Bvbl``."""
    mass, _, _ = srbm_constants(robot)
    ib_np, ib_inv_np = _full_body_inertia(robot)
    ib = torch.as_tensor(ib_np, dtype=x_ref.dtype, device=x_ref.device)
    ib_inv = torch.as_tensor(ib_inv_np, dtype=x_ref.dtype, device=x_ref.device)
    zx = torch.zeros(NUM_STATES, dtype=x_ref.dtype, device=x_ref.device)
    zf = torch.zeros(NUM_CONTROL, dtype=x_ref.dtype, device=x_ref.device)
    A = torch.func.jacfwd(lambda dx: error_state_xdot(dx, zf, x_ref, f_ref, mass, ib, ib_inv))(zx)
    B = torch.func.jacfwd(lambda df: error_state_xdot(zx, df, x_ref, f_ref, mass, ib, ib_inv))(zf)
    return A, B


def _pdot(P, A, B, Q, R_inv):
    At = A.transpose(-1, -2)
    return At @ P + P @ A - P @ B @ (R_inv @ (B.transpose(-1, -2) @ P)) + Q


def riccati_step_backward(P, x_ref, f_ref, Q, R, dt, robot: str = "mc3D"):
    """One backward Euler RDE step, P_{k-1} = P_k + dt Pdot(P_k) (the
    reference's RDE_step keeps only k1, generateRiccatiIntegrator.m:50-55)."""
    A, B = variational_dynamics(x_ref, f_ref, robot)
    return P + dt * _pdot(P, A, B, Q, torch.linalg.inv(R))


def riccati_step_forward(P, x_ref, f_ref, Q, R, dt, robot: str = "mc3D"):
    """One forward RK4 RDE step (generateRiccatiIntegrator.m:58-63)."""
    A, B = variational_dynamics(x_ref, f_ref, robot)
    R_inv = torch.linalg.inv(R)

    def f(P_):
        return -_pdot(P_, A, B, Q, R_inv)

    k1 = f(P)
    k2 = f(P + dt / 2 * k1)
    k3 = f(P + dt / 2 * k2)
    k4 = f(P + dt * k3)
    return P + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6


def default_vbl_weights(dtype=torch.float64, device="cuda"):
    """The reference's F, Q, R weight matrices (quadruped_SRBM_NLP.m:439-487),
    on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    F = np.zeros((NUM_STATES, NUM_STATES))
    np.fill_diagonal(F[:12, :12], [1, 1, 1, 5, 5, 5, 4, 4, 4, 3, 3, 3])
    Q = np.zeros((NUM_STATES, NUM_STATES))
    np.fill_diagonal(Q[:12, :12], [0.25, 0.25, 0.25, 1, 1, 1, 0.5, 0.5, 0.5, 1, 1, 1])
    R = np.diag(np.full(NUM_CONTROL, 90.0))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (F, Q, R))


def _interp(t, tp, fp):
    """jnp.interp of every column of fp (..., M, C) on the knots tp (..., M)
    at the time t (a 0-dim tensor): linear between knots, the end values
    outside them."""
    M = fp.shape[-2]
    tp = tp.expand(fp.shape[:-1]).contiguous()
    tt = t.expand(tp.shape[:-1] + (1,)).contiguous()
    i = torch.clamp(torch.searchsorted(tp, tt, right=True), 1, M - 1)  # (..., 1)
    t0, t1 = torch.gather(tp, -1, i - 1), torch.gather(tp, -1, i)
    gi = (i - 1)[..., None].expand(i.shape + (fp.shape[-1],))
    f0 = torch.gather(fp, -2, gi)[..., 0, :]
    f1 = torch.gather(fp, -2, gi + 1)[..., 0, :]
    dx = t1 - t0
    dx0 = dx.abs() <= torch.finfo(tp.dtype).eps ** 2  # np.spacing(eps), as jnp.interp
    f = torch.where(dx0, f0, f0 + ((tt - t0) / torch.where(dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(tt < tp[..., :1], fp[..., 0, :], f)
    return torch.where(tt > tp[..., -1:], fp[..., -1, :], f)


def riccati_value_function(X_star, U_star, t_star, F=None, Q=None, R=None,
                           dt_riccati: float = 0.022, horizon: float | None = None,
                           robot: str = "mc3D"):
    """Time-varying value function P(t) along optimized trajectories.

    X_star (..., N, 12), U_star (..., N-1, 24) ([foot positions; forces]),
    t_star (N,) or (..., N) knot times.  The RDE is swept backward from the
    terminal weight F over the grid t = 0, dt_riccati, ..., T (T the last
    knot time, the same for every trajectory, or ``horizon``), sampling each
    trajectory by linear interpolation of its states and foot positions and
    by the zero-order hold of its forces, exactly as the reference script
    (quadruped_SRBM_NLP.m:495-513); then swept forward by RK4 from P(0) as a
    consistency check.  Returns (P (..., n, 24, 24), P_fwd (..., n, 24, 24)),
    n = round(T / dt_riccati) + 1."""
    dtype, dev = X_star.dtype, X_star.device
    t_star = torch.as_tensor(t_star, dtype=dtype, device=dev)
    if F is None:
        F_, Q_, R_ = default_vbl_weights(dtype, dev)
    else:
        F_, Q_, R_ = F, Q, R
    if horizon is None:
        ends = t_star[..., -1].reshape(-1)
        if not bool((ends == ends[0]).all()):
            raise ValueError("trajectories end at different times; pass horizon")
        T = float(ends[0])
    else:
        T = horizon
    n_ric = int(round(T / dt_riccati)) + 1
    N = X_star.shape[-2]
    batch = X_star.shape[:-2]
    t_knots = t_star.expand(batch + (N,))
    X12, C12, F12 = X_star[..., :12], U_star[..., :12], U_star[..., 12:24]

    def sample(t):
        # piecewise-linear [X (1:12); pf] on the knot grid; zero-order-hold force
        x_ref = torch.cat([_interp(t, t_knots, X12), _interp(t, t_knots[..., :-1], C12)], -1)
        tt = t.expand(batch + (1,)).contiguous()
        k = torch.clamp(torch.searchsorted(t_knots.contiguous(), tt) - 1, 0, U_star.shape[-2] - 1)
        f_ref = torch.gather(F12, -2, k[..., None].expand(k.shape + (12,)))[..., 0, :]
        return x_ref, f_ref

    ts = torch.arange(n_ric, dtype=dtype, device=dev) * dt_riccati
    P = F_.expand(batch + F_.shape[-2:])
    Ps = [P]
    for j in range(n_ric - 1, 0, -1):
        x_ref, f_ref = sample(ts[j])
        P = riccati_step_backward(P, x_ref, f_ref, Q_, R_, dt_riccati, robot)
        Ps.append(P)
    P_traj = torch.stack(Ps[::-1], -3)
    P = P_traj[..., 0, :, :]
    Ps_f = [P]
    for j in range(n_ric - 1):
        x_ref, f_ref = sample(ts[j])
        P = riccati_step_forward(P, x_ref, f_ref, Q_, R_, dt_riccati, robot)
        Ps_f.append(P)
    return P_traj, torch.stack(Ps_f, -3)
