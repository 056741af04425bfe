"""Single-rigid-body-model (SRBM) dynamics for quadruped landing.

State x (12): [r(3) world position, rpy(3), omega(3) BODY frame, v(3) WORLD
frame]; controls u (24): [c(12) world foot positions, f(12) world GRFs]
(quadruped_SRBM_NLP.m:38-41).

    v_dot     = (1/m) * sum_i f_i + g
    omega_dot = Ib^{-1} ( R_w2b * sum_i (c_i - r) x f_i  -  omega x Ib omega )
    r_dot     = v
    rpy_dot   = Binv(rpy) @ (R_b2w @ omega)

(landing_optimization.m:116-128).  Functions take any leading dimensions:
x (..., 12), u (..., 24), mass (...), ib_diag / ib_inv_diag (..., 3).
Integration is forward Euler with a per-knot dt, as in the defect
constraints (landing_optimization.m:125-128).
"""

from __future__ import annotations

import torch

from .._device import constant
from .rotations import binv, rpy_to_rot_xyz, rpy_to_rot_zyx


def cross(a, b):
    """Cross product over the last axis (written out: forward-mode AD and
    torch.func.vmap friendly)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def split_state(x):
    """x (..., 12) -> (r, rpy, omega_body, v_world), each (..., 3)."""
    return x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12]


def split_control(u):
    """u (..., 24) -> (c (..., 4, 3) world foot positions, f (..., 4, 3) world
    GRFs)."""
    return (u[..., :12].reshape(u.shape[:-1] + (4, 3)),
            u[..., 12:].reshape(u.shape[:-1] + (4, 3)))


def _matvec(M, v):
    return (M * v[..., None, :]).sum(-1)


def _xdot(x, u, mass, ib_diag, ib_inv_diag, rot):
    r, rpy, omega, v = split_state(x)
    c, f = split_control(u)
    R_b2w = rot(rpy)
    g = constant([0.0, 0.0, -9.81], x.dtype, x.device)
    v_dot = f.sum(-2) / mass[..., None] + g
    # world-frame contact torque about the CoM
    tau_world = cross(c - r[..., None, :], f).sum(-2)
    omega_dot = ib_inv_diag * (
        _matvec(R_b2w.transpose(-1, -2), tau_world) - cross(omega, ib_diag * omega)
    )
    rpy_dot = _matvec(binv(rpy), _matvec(R_b2w, omega))
    return torch.cat([v, rpy_dot, omega_dot, v_dot], -1)


def srbm_xdot(x, u, mass, ib_diag, ib_inv_diag):
    """Continuous-time SRBM state derivative, XYZ rotation convention."""
    return _xdot(x, u, mass, ib_diag, ib_inv_diag, rpy_to_rot_xyz)


def srbm_xdot_zyx(x, u, mass, ib_diag, ib_inv_diag):
    """SRBM derivative with the legacy ZYX rotation convention
    (generate_landingCtrller_IPOPT_warmstart.m:114-130)."""
    return _xdot(x, u, mass, ib_diag, ib_inv_diag, rpy_to_rot_zyx)


def _constants(x, *values):
    """Numbers or arrays (mass, dt, inertia diagonals) as tensors like x."""
    return [torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in values]


def euler_defect(x_k, x_kp1, u_k, dt_k, mass, ib_diag, ib_inv_diag):
    """Forward-Euler dynamics defect (..., 12): x_{k+1} - x_k - xdot(x_k, u_k) dt_k,
    zero on a dynamically consistent trajectory (landing_optimization.m:125-128).
    dt_k and mass: (...) or numbers; ib_diag, ib_inv_diag: (..., 3)."""
    dt_k, mass, ib_diag, ib_inv_diag = _constants(x_k, dt_k, mass, ib_diag, ib_inv_diag)
    return x_kp1 - x_k - srbm_xdot(x_k, u_k, mass, ib_diag, ib_inv_diag) * dt_k[..., None]


def rollout(x0, U, dts, mass, ib_diag, ib_inv_diag):
    """Open-loop forward-Euler rollout: x0 (..., 12), U (..., N-1, 24), dts
    (..., N-1) -> X (..., N, 12)."""
    dts, mass, ib_diag, ib_inv_diag = _constants(x0, dts, mass, ib_diag, ib_inv_diag)
    xs = [x0]
    for k in range(U.shape[-2]):
        x = xs[-1]
        xs.append(x + srbm_xdot(x, U[..., k, :], mass, ib_diag, ib_inv_diag) * dts[..., k, None])
    return torch.stack(xs, -2)
