"""Closed-form Mini-Cheetah leg kinematics: FK, analytic Jacobian, torques, IK.

Vectorized over the 4 legs and free of control flow; every function takes
any leading dimensions (jpos (..., 12), q_base (..., 6), rpy (..., 3)) and
is written functionally, so ``torch.func`` traces it per knot.

- :func:`foot_positions_world` is the closed form of the reference's
  Featherstone FK propagation (get_forward_kin_foot.m:1-26) for the fixed
  quad3D topology (incl. the hip's 180-degree yaw flip,
  get_robot_model.m:211).
- :func:`leg_jacobians` is the analytic 3x3 Jacobian with the 0.004 m knee
  y-offset, exactly as get_foot_jacobians_mc.m:1-27.  The reference's FK
  chain does NOT include that offset; both behaviours are reproduced, since
  the NLP uses both with a +-1 cm consistency band.
- :func:`inverse_kinematics` is the closed-form atan2 IK
  (quadInverseKinematics.m:1-44, legacy ZYX base rotation, or the production
  XYZ convention), :func:`inverse_kinematics_newton` its damped-Newton polish
  on the FK residual (misc/inverse_kinematics.m:1-19).

Products are elementwise sums in the working precision (no TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import constant
from .rotations import rpy_to_rot_xyz, rpy_to_rot_zyx

# Per-leg ab/ad y sign [FR, FL, HR, HL] (get_foot_jacobians_mc.m:3).
SIDE_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])

# Per-leg xyz sign pattern for link offsets (get_robot_model.m:192).
SIDE_SIGN_XYZ = np.array(
    [[1.0, -1.0, 1.0], [1.0, 1.0, 1.0], [-1.0, -1.0, 1.0], [-1.0, 1.0, 1.0]]
)


def _trig(jpos):
    """(..., 12) -> per-leg sines/cosines (..., 4) and the side signs."""
    q = jpos.reshape(jpos.shape[:-1] + (4, 3))
    side = constant(SIDE_SIGN, jpos.dtype, jpos.device)
    s, c = torch.sin(q), torch.cos(q)
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    c23 = c2 * c3 - s2 * s3
    s23 = s2 * c3 + c2 * s3
    return side, s1, s2, c1, c2, s23, c23


def foot_positions_hip(params, jpos):
    """Foot position of each leg relative to its ab/ad pivot, body frame.

    jpos: (..., 12) joint angles [abad, hip, knee] x 4 legs -> (..., 4, 3).

    Closed form of the quad3D chain (abad Rx -> rz(pi) hip Ry -> knee Ry):
        px = l3*s23 + l2*s2
        py = side*l1*c1 + s1*(l2*c2 + l3*c23)
        pz = side*l1*s1 - c1*(l2*c2 + l3*c23)
    (No l4 knee y-offset, matching get_forward_kin_foot.m exactly.)
    """
    l1, l2, l3 = params.l1, params.l2, params.l3
    side, s1, s2, c1, c2, s23, c23 = _trig(jpos)
    leg_len = l2 * c2 + l3 * c23  # projected upper+lower link length
    px = l3 * s23 + l2 * s2
    py = side * l1 * c1 + s1 * leg_len
    pz = side * l1 * s1 - c1 * leg_len
    return torch.stack([px, py, pz], -1)


def foot_positions_world(params, q_base, jpos):
    """World-frame foot positions, XYZ production convention.

    q_base: (..., 6) [xyz, rpy]; jpos: (..., 12) -> (..., 4, 3).  Equals the
    reference's ``get_forward_kin_foot(model, [q; jpos])``
    (landing_optimization.m:184).
    """
    R = rpy_to_rot_xyz(q_base[..., 3:6])
    abad = constant(SIDE_SIGN_XYZ * np.asarray(params.abad_location), jpos.dtype, jpos.device)
    p = abad + foot_positions_hip(params, jpos)  # (..., 4, 3)
    # R @ p per leg, written out as a broadcast sum
    return q_base[..., None, :3] + (p[..., None, :] * R[..., None, :, :]).sum(-1)


def leg_jacobians(params, jpos):
    """Analytic 3x3 foot Jacobians, (..., 4, 3, 3) (get_foot_jacobians_mc.m:1-27).

    Includes the l4 = 0.004 m knee y-offset exactly as the reference does.
    d(foot pos in body frame)/d(leg joints); used for the torque map
    tau = J' @ (-R_w2b @ f) (landing_optimization.m:167).
    """
    l1, l2, l3, l4 = params.l1, params.l2, params.l3, params.knee_link_y_offset
    l14 = l1 + l4
    side, s1, s2, c1, c2, s23, c23 = _trig(jpos)
    z = torch.zeros_like(s1)
    row0 = torch.stack([z, l3 * c23 + l2 * c2, l3 * c23], -1)
    row1 = torch.stack(
        [
            l3 * c1 * c23 + l2 * c1 * c2 - l14 * s1 * side,
            -l3 * s1 * s23 - l2 * s1 * s2,
            -l3 * s1 * s23,
        ],
        -1,
    )
    row2 = torch.stack(
        [
            l3 * s1 * c23 + l2 * c2 * s1 + l14 * side * c1,
            l3 * c1 * s23 + l2 * c1 * s2,
            l3 * c1 * s23,
        ],
        -1,
    )
    return torch.stack([row0, row1, row2], -2)


def leg_torques(params, jpos, rpy, f_grf):
    """Jacobian-transpose joint torques for all legs.

    tau_leg = J(jpos)' @ (-R_w2b @ f_world) per leg
    (landing_optimization.m:134,167).  jpos: (..., 12), rpy: (..., 3),
    f_grf: (..., 12) world GRFs -> (..., 12) torques.
    """
    J = leg_jacobians(params, jpos)  # (..., 4, 3, 3)
    R_w2b = rpy_to_rot_xyz(rpy).transpose(-1, -2)
    f = f_grf.reshape(f_grf.shape[:-1] + (4, 3))
    f_body = -(f[..., None, :] * R_w2b[..., None, :, :]).sum(-1)  # -R_w2b @ f_leg
    tau = (J * f_body[..., :, None]).sum(-2)  # J' @ f_body
    return tau.reshape(f_grf.shape)


def _base_rotation(fb_state, convention: str):
    if convention == "zyx":
        return rpy_to_rot_zyx(fb_state[..., 3:6])
    if convention == "xyz":
        return rpy_to_rot_xyz(fb_state[..., 3:6])
    raise ValueError(convention)


def _hip_frame_targets(params, fb_state, p_feet, R_b2w):
    """R_w2b (p - base) - hip per leg, (..., 4, 3)."""
    hip_rel = constant(SIDE_SIGN_XYZ * np.asarray(params.abad_location), p_feet.dtype, p_feet.device)
    p = p_feet.reshape(p_feet.shape[:-1] + (4, 3)) - fb_state[..., None, :3]
    # (p - base) @ R_b2w per leg, written out as a broadcast sum
    return (p[..., :, None] * R_b2w[..., None, :, :]).sum(-2) - hip_rel


def inverse_kinematics(params, fb_state, p_feet, convention: str = "zyx"):
    """Closed-form IK: world foot positions -> 12 joint angles
    (quadInverseKinematics.m:1-44).  ``fb_state`` (..., 6) base pose,
    ``p_feet`` (..., 12) world foot positions -> (..., 12).  The reference
    uses the legacy ZYX base rotation; ``convention="xyz"`` gives the
    production convention of :func:`foot_positions_world`."""
    l1, l2, l3 = params.l1, params.l2, params.l3
    p_rel = _hip_frame_targets(params, fb_state, p_feet, _base_rotation(fb_state, convention))
    l1s = constant(SIDE_SIGN_XYZ[:, 1], p_feet.dtype, p_feet.device) * l1
    px, py, pz = p_rel[..., 0], p_rel[..., 1], p_rel[..., 2]
    th1 = torch.atan2(pz, py) + torch.atan2(
        torch.sqrt(torch.clamp(py**2 + pz**2 - l1s**2, min=0.0)), l1s.expand_as(py))
    tmp = py * torch.sin(th1) - pz * torch.cos(th1)
    A = -2.0 * tmp * l2
    B = -2.0 * px * l2
    C = l3**2 - tmp**2 - px**2 - l2**2
    disc = torch.clamp(A**2 + B**2 - C**2, min=0.0)
    th2 = torch.atan2(B, A) + torch.atan2(torch.sqrt(disc), C)
    th3 = torch.atan2(px - l2 * torch.sin(th2), tmp - l2 * torch.cos(th2)) - th2
    return torch.stack([th1, th2, th3], -1).reshape(p_feet.shape)


def inverse_kinematics_newton(params, fb_state, p_feet, jpos_guess, convention: str = "xyz",
                              iters: int = 8, tol: float = 1e-6):
    """Numeric IK refinement, the ``fsolve``-on-FK-residual fallback
    (misc/inverse_kinematics.m:1-19): ``iters`` damped per-leg Newton steps
    on the body-frame FK residual from ``jpos_guess``.  Where the refined
    answer does not beat the guess's residual (an out-of-workspace target),
    the guess is returned, per scenario and branch-free."""
    dtype = p_feet.dtype
    target = _hip_frame_targets(params, fb_state, p_feet, _base_rotation(fb_state, convention))
    eye = 1e-9 * torch.eye(3, dtype=dtype, device=p_feet.device)

    def residual(jp):
        return foot_positions_hip(params, jp) - target  # (..., 4, 3)

    jp0 = jpos_guess.reshape(p_feet.shape).to(dtype)
    jp = jp0
    for _ in range(iters):
        r = residual(jp)
        J = leg_jacobians(params, jp)  # (..., 4, 3, 3) d p_hip / d jpos per leg
        # damped per-leg 3x3 solve (Levenberg): J'J + eps I guards the
        # knee-singular configurations
        JtJ = J.transpose(-1, -2) @ J + eye
        rhs = (J * r[..., :, None]).sum(-2)
        djp = torch.linalg.solve(JtJ, rhs[..., None])[..., 0]
        jp = jp - djp.reshape(jp.shape)
    err_ref = residual(jp).abs().flatten(-2).amax(-1)
    err_0 = residual(jp0).abs().flatten(-2).amax(-1)
    better = torch.isfinite(err_ref) & (err_ref <= torch.clamp(err_0, min=tol))
    return torch.where(better[..., None], jp, jp0)
