"""Spatial (6-D) rigid-body algebra, batch-first.

The parts of Featherstone's ``spatial_v2`` that the rigid-body algorithms of
:mod:`.featherstone` use (spatial_v2/spatial/*.m, dynamics/jcalc.m): Plucker
transforms, spatial cross products, spatial inertias and the joint calculus.
Every function takes leading batch dimensions (``(..., 3)`` vectors,
``(..., 3, 3)`` rotations, ``(..., 6, 6)`` transforms and inertias) and
broadcasts them against each other; joint types are static integer codes,
so a model's topology is plain Python data.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import constant
from .rotations import rx, ry, rz, skew, unskew

# Static joint-type codes (spatial_v2/dynamics/jcalc.m:19-40)
JT_RX, JT_RY, JT_RZ, JT_PX, JT_PY, JT_PZ = 0, 1, 2, 3, 4, 5

# Motion subspaces S for each joint code, stacked (6 codes x 6).
_S_TABLE = np.zeros((6, 6))
_S_TABLE[JT_RX, 0] = 1.0
_S_TABLE[JT_RY, 1] = 1.0
_S_TABLE[JT_RZ, 2] = 1.0
_S_TABLE[JT_PX, 3] = 1.0
_S_TABLE[JT_PY, 4] = 1.0
_S_TABLE[JT_PZ, 5] = 1.0


def _blocks(a, b, c, d):
    """[[a, b], [c, d]] from four (..., 3, 3) blocks, broadcast together."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def plux(E, r):
    """Plucker transform ``X = [E 0; -E skew(r) E]`` from rotation E and
    translation r (spatial_v2/spatial/plux.m:14-16): a shift of origin by r
    followed by the rotation E."""
    Z = torch.zeros_like(E)
    return _blocks(E, Z, -E @ skew(r), E)


def plux_inv(X):
    """Plucker transform -> (E, r) (plux.m:18-21): E the world->frame
    rotation, r the frame origin in parent coordinates."""
    E = X[..., :3, :3]
    r = -unskew(E.transpose(-1, -2) @ X[..., 3:, :3])
    return E, r


def rot_spatial(E):
    """Pure-rotation spatial transform [E 0; 0 E]."""
    Z = torch.zeros_like(E)
    return _blocks(E, Z, Z, E)


def xlt(r):
    """Pure-translation spatial transform (spatial_v2/spatial/xlt.m)."""
    E = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[:-1] + (3, 3))
    return plux(E, r)


def rotx(theta):
    """Spatial X-axis rotation (spatial_v2/spatial/rotx.m)."""
    return rot_spatial(rx(theta))


def roty(theta):
    return rot_spatial(ry(theta))


def rotz(theta):
    return rot_spatial(rz(theta))


def crm(v):
    """Spatial cross-product operator for motion vectors (crm.m):
    ``crm(v) @ m = v x m``."""
    Sw, Sv = skew(v[..., :3]), skew(v[..., 3:])
    return _blocks(Sw, torch.zeros_like(Sw), Sv, Sw)


def crf(v):
    """Spatial cross-product operator for force vectors (crf.m):
    ``crf(v) = -crm(v)'``."""
    return -crm(v).transpose(-1, -2)


def spatial_inertia(mass, com, I3):
    """6x6 spatial inertia ``[I3 + m C C', m C; m C', m 1]`` with
    ``C = skew(com)`` (dynamics-utilities/spatialInertia.m:21-25; spatial_v2
    mcI.m).  mass: (...) or a number."""
    mass = torch.as_tensor(mass, dtype=com.dtype, device=com.device)[..., None, None]
    C = skew(com)
    Ct = C.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    return _blocks(I3 + mass * (C @ Ct), mass * C, mass * Ct, mass * eye3)


def spatial_inertia_decompose(I6):
    """Inverse of :func:`spatial_inertia`: 6x6 -> (mass, com, I3)."""
    mass = I6[..., 5, 5]
    mC = I6[..., :3, 3:]
    com = torch.stack([mC[..., 2, 1], mC[..., 0, 2], mC[..., 1, 0]], -1) / mass[..., None]
    C = skew(com)
    I3 = I6[..., :3, :3] - mass[..., None, None] * (C @ C.transpose(-1, -2))
    return mass, com, I3


def flip_spatial_inertia_y(I6):
    """Reflect a spatial inertia across the XZ plane (left/right leg
    mirror), the reference's ``flipAlongAxis(I, 'Y')``
    (get_robot_model.m:202-226): mass unchanged, CoM y negated, inertia
    conjugated by diag(1, -1, 1)."""
    mass, com, I3 = spatial_inertia_decompose(I6)
    R = torch.diag(torch.tensor([1.0, -1.0, 1.0], dtype=I6.dtype, device=I6.device))
    return spatial_inertia(mass, com @ R, R @ I3 @ R)


def motion_subspace(jtype_code: int, dtype, device):
    """S (6,) of a joint code as a tensor, a row of _S_TABLE made once per
    (dtype, device) (no host-to-device copy per call)."""
    return constant(_S_TABLE, dtype, device)[jtype_code]


def jcalc(jtype_code: int, q):
    """Joint transform Xj (..., 6, 6) and motion subspace S (6,) of one
    joint at angles or displacements q (...) (spatial_v2/dynamics/jcalc.m:19-40);
    the joint code is static."""
    z = torch.zeros_like(q)
    if jtype_code == JT_RX:
        Xj = rotx(q)
    elif jtype_code == JT_RY:
        Xj = roty(q)
    elif jtype_code == JT_RZ:
        Xj = rotz(q)
    elif jtype_code == JT_PX:
        Xj = xlt(torch.stack([q, z, z], -1))
    elif jtype_code == JT_PY:
        Xj = xlt(torch.stack([z, q, z], -1))
    elif jtype_code == JT_PZ:
        Xj = xlt(torch.stack([z, z, q], -1))
    else:
        raise ValueError(f"unknown joint code {jtype_code}")
    return Xj, motion_subspace(jtype_code, q.dtype, q.device)
