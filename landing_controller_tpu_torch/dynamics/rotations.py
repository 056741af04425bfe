"""Rotation and Euler-rate kinematics (reference conventions).

- ``rpy_to_rot_xyz(rpy) = rx(r)' @ ry(p)' @ rz(y)'``: production body-to-world
  rotation (dynamics-utilities/rpyToRotMat_xyz.m:1-2).
- ``rpy_to_rot_zyx(rpy) = rz(y)' @ ry(p)' @ rx(r)'``: legacy ZYX convention
  (dynamics-utilities/rpyToRotMat.m:1-2), used by the SRBM-LCP NLP.
- ``binv``: world angular velocity -> Euler rates; singular at pitch = +-pi/2
  (dynamics-utilities/Binv.m:1-16).
- ``bmat_f`` / ``bmat_f_dot``: Euler rates -> world angular velocity and its
  time derivative (BmatF.m:1-12, BmatF_dot.m:1-16), used by the eeParam NLP.

Every function takes ``rpy`` with any leading dimensions ``(..., 3)`` and
returns ``(..., 3, 3)``.  Matrices are composed elementwise, with no matmul.
"""

from __future__ import annotations

import torch


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


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
