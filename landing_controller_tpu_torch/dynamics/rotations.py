"""Rotation and Euler-rate kinematics (reference conventions).

- ``rx/ry/rz``: 3x3 *coordinate transform* matrices (frame A -> frame B, B
  rotated by theta about the common axis), the transposes of the usual
  active rotations (spatial_v2/3D/rx.m, ry.m, rz.m); ``skew`` / ``unskew``
  (spatial_v2/3D/skew.m, skew_2.m).
- ``rpy_to_rot_xyz(rpy) = rx(r)' @ ry(p)' @ rz(y)'``: production body-to-world
  rotation (dynamics-utilities/rpyToRotMat_xyz.m:1-2).
- ``rpy_to_rot_zyx(rpy) = rz(y)' @ ry(p)' @ rx(r)'``: legacy ZYX convention
  (dynamics-utilities/rpyToRotMat.m:1-2), used by the SRBM-LCP NLP.
- ``binv``: world angular velocity -> Euler rates; singular at pitch = +-pi/2
  (dynamics-utilities/Binv.m:1-16).
- ``bmat_f`` / ``bmat_f_dot``: Euler rates -> world angular velocity and its
  time derivative (BmatF.m:1-12, BmatF_dot.m:1-16), used by the eeParam NLP.

Every function takes its angles with any leading dimensions (``theta``
``(...)``, ``rpy`` and ``v`` ``(..., 3)``) and returns ``(..., 3, 3)``
(``unskew``: ``(..., 3, 3)`` -> ``(..., 3)``).  Matrices are composed
elementwise, with no matmul.
"""

from __future__ import annotations

import torch


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rx(theta):
    """3x3 coordinate rotation about X (spatial_v2/3D/rx.m)."""
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return _mat([[o, z, z], [z, c, s], [z, -s, c]])


def ry(theta):
    """3x3 coordinate rotation about Y (spatial_v2/3D/ry.m)."""
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return _mat([[c, z, -s], [z, o, z], [s, z, c]])


def rz(theta):
    """3x3 coordinate rotation about Z (spatial_v2/3D/rz.m)."""
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return _mat([[c, s, z], [-s, c, z], [z, z, o]])


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix (spatial_v2/3D/skew.m)."""
    z = torch.zeros_like(v[..., 0])
    return _mat([[z, -v[..., 2], v[..., 1]], [v[..., 2], z, -v[..., 0]],
                 [-v[..., 1], v[..., 0], z]])


def unskew(A):
    """Skew-symmetric component of a 3x3 matrix as a vector (skew_2.m)."""
    return 0.5 * torch.stack([A[..., 2, 1] - A[..., 1, 2], A[..., 0, 2] - A[..., 2, 0],
                              A[..., 1, 0] - A[..., 0, 1]], -1)


def rpy_to_rot_xyz(rpy):
    """Body-to-world rotation, XYZ convention (rpyToRotMat_xyz.m:1-2)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return _mat(
        [
            [cp * cy, -cp * sy, sp],
            [cr * sy + sr * sp * cy, cr * cy - sr * sp * sy, -sr * cp],
            [sr * sy - cr * sp * cy, sr * cy + cr * sp * sy, cr * cp],
        ]
    )


def rpy_to_rot_zyx(rpy):
    """Body-to-world rotation, legacy ZYX convention (rpyToRotMat.m:1-2)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return _mat(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def binv(rpy):
    """Euler-rate matrix: ``rpy_dot = binv(rpy) @ omega_world`` (Binv.m:1-16)."""
    theta, psi = rpy[..., 1], rpy[..., 2]
    cp, sp = torch.cos(psi), torch.sin(psi)
    ct, tt = torch.cos(theta), torch.tan(theta)
    z = torch.zeros_like(psi)
    o = torch.ones_like(psi)
    return _mat([[cp / ct, sp / ct, z], [-sp, cp, z], [cp * tt, sp * tt, o]])


def bmat_f(rpy):
    """Euler rates -> world angular velocity (BmatF.m:1-12):
    ``omega_world = bmat_f(rpy) @ rpy_dot``."""
    theta, psi = rpy[..., 1], rpy[..., 2]
    cp, sp = torch.cos(psi), torch.sin(psi)
    ct, st = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(psi)
    o = torch.ones_like(psi)
    return _mat([[cp * ct, -sp, z], [ct * sp, cp, z], [-st, z, o]])


def bmat_f_dot(rpy, rpy_dot):
    """Time derivative of ``bmat_f`` (BmatF_dot.m:1-16):
    ``omega_dot = bmat_f_dot(rpy, rpy_dot) @ rpy_dot + bmat_f(rpy) @ rpy_ddot``."""
    theta, psi = rpy[..., 1], rpy[..., 2]
    theta_d, psi_d = rpy_dot[..., 1], rpy_dot[..., 2]
    cp, sp = torch.cos(psi), torch.sin(psi)
    ct, st = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(psi)
    return _mat(
        [
            [-ct * sp * psi_d - st * theta_d * cp, -cp * psi_d, z],
            [ct * cp * psi_d - st * theta_d * sp, -sp * psi_d, z],
            [-ct * theta_d, z, z],
        ]
    )
