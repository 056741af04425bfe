"""Derived SRBM constants from the quad3D (18-body) rigid-body model.

The port's copy of the composite-inertia computation behind the SRBM mass
and body inertia (dynamics-utilities/get_robot_model.m:134-245,
get_mass_matrix.m:6-22).  Everything is host-side numpy float64, so the
constants never depend on the device dtype (mc3D: mass == 8.252 exactly).
"""

from __future__ import annotations

import functools

import numpy as np

from .params import get_robot_params


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64)


def _plux(E, r):
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ _skew(r)
    return X


def _rx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _ry(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _rz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _flip_y(I6):
    mass = I6[5, 5]
    mC = I6[:3, 3:]
    com = np.array([mC[2, 1], mC[0, 2], mC[1, 0]]) / mass if mass > 0 else np.zeros(3)
    C = _skew(com)
    I3 = I6[:3, :3] - mass * (C @ C.T)
    R = np.diag([1.0, -1.0, 1.0])
    C2 = _skew(R @ com)
    return np.block(
        [[R @ I3 @ R + mass * (C2 @ C2.T), mass * C2], [mass * C2.T, mass * np.eye(3)]]
    )


# Per-leg coordinate sign pattern (get_robot_model.m:192): columns are legs
# FR, FL, HR, HL; rows are x, y, z multipliers applied to the link offsets.
SIDE_SIGN_XYZ = np.array(
    [[1, 1, -1, -1], [-1, 1, -1, 1], [1, 1, 1, 1]], dtype=np.float64
)

# leg joint axes: ab/ad about x, hip and knee about y
_LEG_AXES = (_rx, _ry, _ry)
# home leg configuration (get_robot_model.m:226)
_Q_LEG_HOME = np.array([0.0, -1.45, 2.65])


def _composite_body_inertia(name: str) -> np.ndarray:
    """6x6 composite spatial inertia of the whole robot about the floating
    base at the home pose (CRBA accumulation, get_mass_matrix.m:6-22)."""
    params = get_robot_params(name)
    total = params.body_inertia.copy()
    leg_side = -1
    for leg in range(4):
        ss = SIDE_SIGN_XYZ[:, leg]
        xtree = (
            _plux(np.eye(3), ss * params.abad_location),
            _plux(_rz(np.pi), np.zeros(3)) @ _plux(np.eye(3), ss * params.hip_location),
            _plux(np.eye(3), ss * params.knee_location),
        )
        links = (params.abad_inertia, params.hip_inertia, params.knee_inertia)
        inertia = [I if leg_side > 0 else _flip_y(I) for I in links]
        xup = []
        for axis, q, xt in zip(_LEG_AXES, _Q_LEG_HOME, xtree):
            E = axis(q)
            xup.append(np.block([[E, np.zeros((3, 3))], [np.zeros((3, 3)), E]]) @ xt)
        # knee -> hip -> ab/ad -> base
        ic = inertia[2]
        ic = inertia[1] + xup[2].T @ ic @ xup[2]
        ic = inertia[0] + xup[1].T @ ic @ xup[1]
        total = total + xup[0].T @ ic @ xup[0]
        leg_side *= -1
    return total


@functools.lru_cache(maxsize=8)
def srbm_constants(name: str = "mc3D"):
    """Derived SRBM constants (mass, body inertia diag & inverse) at q_home.

    Matches the reference's ``[~, Ibody] = get_mass_matrix(model, q_home, 0)``
    then ``mass = Ibody(6,6); Ib = diag(Ibody(1:3,1:3))``
    (landing_optimization.m:240-244).  float64 on the host.
    """
    ic = _composite_body_inertia(name)
    mass = float(ic[5, 5])
    ib_diag = np.diag(ic[:3, :3]).copy()
    ib_inv_diag = np.diag(np.linalg.inv(ic[:3, :3])).copy()
    return mass, ib_diag, ib_inv_diag
