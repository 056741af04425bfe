"""Static rigid-body model of the quad3D (18-body) topology.

The port's copy of the tree built by ``get_robot_model`` for ``quad3D``
(dynamics-utilities/get_robot_model.m:134-245): 6 floating-base
pseudo-joints (Px, Py, Pz, Rx, Ry, Rz), then 4 legs x (ab/ad Rx, hip Ry,
knee Ry); the hip's tree transform includes a 180-degree yaw flip
(``plux(rz(pi), 0)``, get_robot_model.m:211).  Topology and geometry are
host-side numpy float64; :meth:`RobotModel.tensors` gives them as tensors of
one dtype and device, built once per pair.  The derived SRBM constants come
from the composite inertia at the home pose (mc3D: the mass 8.252 of the
reference, bit for bit the JAX package's value).
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

from .._device import constant
from .params import RobotParams, get_robot_params

# numpy mirrors of the spatial helpers (model construction is host-side, static)


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


# Joint type codes matching dynamics.spatial
_JT = {"Rx": 0, "Ry": 1, "Rz": 2, "Px": 3, "Py": 4, "Pz": 5}

# Per-leg coordinate sign pattern (get_robot_model.m:192): columns are legs
# FR, FL, HR, HL; rows are x, y, z multipliers applied to the link offsets.
SIDE_SIGN_XYZ = np.array(
    [[1, 1, -1, -1], [-1, 1, -1, 1], [1, 1, 1, 1]], dtype=np.float64
)

# Ab/ad y sign per leg: the ``sideSign`` of the analytic Jacobian
# (get_foot_jacobians_mc.m:3) and row 2 of SIDE_SIGN_XYZ.
SIDE_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])

# Foot world-position sign convention of the IK and of the reference
# trajectory's construction (landing_optimization.m:205,253).
FOOT_SIGN_CONVENTION = np.array(
    [1, -1, 1, 1, 1, 1, -1, -1, 1, -1, 1, 1], dtype=np.float64
)


class ModelTensors(typing.NamedTuple):
    """A model's arrays as tensors of one dtype and device."""

    xtree: torch.Tensor  # (nb, 6, 6)
    inertia: torch.Tensor  # (nb, 6, 6)
    xfoot: torch.Tensor  # (nlegs, 6, 6)
    gravity: torch.Tensor  # (3,)
    a_grav: torch.Tensor  # (6,) the base acceleration that stands for gravity


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static model arrays (numpy float64) and the tree's topology."""

    params: RobotParams
    nb: int  # number of bodies (18)
    nlegs: int  # 4
    parent: np.ndarray  # (nb,) parent indices, -1 for root
    jtype: tuple  # (nb,) static joint codes
    xtree: np.ndarray  # (nb,6,6) tree transforms
    inertia: np.ndarray  # (nb,6,6) spatial inertias
    xfoot: np.ndarray  # (nlegs,6,6) body->foot transforms
    b_foot: np.ndarray  # (nlegs,) body index holding each foot
    gravity: np.ndarray  # (3,)
    q_home: np.ndarray  # (18,) home configuration
    gear_ratio: np.ndarray  # (3,) abad/hip/knee
    kt: np.ndarray  # (3,)
    rm: np.ndarray  # (3,)
    tau_max: np.ndarray  # (12,) joint torque limits
    battery_v: float

    @property
    def tau_max_leg(self) -> np.ndarray:
        """(3,) per-leg torque limit [18, 18, 28] N*m (get_robot_model.m:240)."""
        return self.tau_max[:3]

    def tensors(self, dtype, device) -> ModelTensors:
        """The model's arrays as tensors of ``dtype`` on ``device``, built at
        the first call for that pair and kept, so that a batched call copies
        no inertia to the device."""
        a_grav = np.concatenate([np.zeros(3), -self.gravity])
        return ModelTensors._make(constant(a, dtype, device) for a in
                                  (self.xtree, self.inertia, self.xfoot, self.gravity, a_grav))


@functools.lru_cache(maxsize=8)
def get_robot_model(name: str = "mc3D") -> RobotModel:
    """Build the quad3D 18-body model (get_robot_model.m:134-245)."""
    params = get_robot_params(name)
    nb = 18
    parent = np.full(nb, -1, dtype=np.int64)
    jtype = []
    xtree = np.tile(np.eye(6), (nb, 1, 1))
    inertia = np.zeros((nb, 6, 6))
    xfoot = np.zeros((4, 6, 6))
    b_foot = np.zeros(4, dtype=np.int64)

    # Floating base: 6 massless pseudo-joints, the yaw body carries the mass.
    for i, jt in enumerate(["Px", "Py", "Pz", "Rx", "Ry", "Rz"]):
        parent[i] = i - 1
        jtype.append(jt)
    inertia[5] = params.body_inertia

    nb_base = 5
    idx = 5
    leg_side = -1
    for leg in range(4):
        ss = SIDE_SIGN_XYZ[:, leg]
        # Ab/ad
        idx += 1
        parent[idx] = nb_base
        jtype.append("Rx")
        xtree[idx] = _plux(np.eye(3), ss * params.abad_location)
        inertia[idx] = params.abad_inertia if leg_side > 0 else _flip_y(params.abad_inertia)
        # Hip (with 180-degree yaw flip, get_robot_model.m:211)
        idx += 1
        parent[idx] = idx - 1
        jtype.append("Ry")
        xtree[idx] = _plux(_rz(np.pi), np.zeros(3)) @ _plux(np.eye(3), ss * params.hip_location)
        inertia[idx] = params.hip_inertia if leg_side > 0 else _flip_y(params.hip_inertia)
        # Knee
        idx += 1
        parent[idx] = idx - 1
        jtype.append("Ry")
        xtree[idx] = _plux(np.eye(3), ss * params.knee_location)
        inertia[idx] = params.knee_inertia if leg_side > 0 else _flip_y(params.knee_inertia)
        # Foot
        xfoot[leg] = _plux(np.eye(3), ss * params.foot_location)
        b_foot[leg] = idx
        leg_side *= -1

    gr = np.array([params.abad_gear_ratio, params.hip_gear_ratio, params.knee_gear_ratio])
    tau_max = np.tile(gr * params.motor_tau_max, 4)
    q_leg = np.array([0.0, -1.45, 2.65])
    return RobotModel(
        params=params,
        nb=nb,
        nlegs=4,
        parent=parent,
        jtype=tuple(_JT[j] for j in jtype),
        xtree=xtree,
        inertia=inertia,
        xfoot=xfoot,
        b_foot=b_foot,
        gravity=np.array([0.0, 0.0, -9.81]),
        q_home=np.concatenate([np.zeros(6), np.tile(q_leg, 4)]),
        gear_ratio=gr,
        kt=np.full(3, params.motor_kt),
        rm=np.full(3, params.motor_r),
        tau_max=tau_max,
        battery_v=params.battery_v,
    )


def _rotation_np(jt, q):
    if jt == _JT["Rx"]:
        return _rx(q)
    if jt == _JT["Ry"]:
        return _ry(q)
    return _rz(q)


def composite_inertia_np(model: RobotModel, q: np.ndarray) -> np.ndarray:
    """Host-side float64 CRBA composite inertia of the floating base at
    configuration q (get_mass_matrix.m:6-22, the composite-inertia
    accumulation only): derived constants never depend on the device dtype.
    Its tensor twin is ``dynamics.featherstone.mass_matrix``."""
    nb = model.nb
    # floating-base lumped transform (rpyToRotMat ZYX convention)
    r, p, y = q[3], q[4], q[5]
    R_w2b = (_rz(y).T @ _ry(p).T @ _rx(r).T).T
    xup = [None] * nb
    xup[5] = np.block([[R_w2b, np.zeros((3, 3))], [-R_w2b @ _skew(q[:3]), R_w2b]])
    for i in range(6, nb):
        E = _rotation_np(model.jtype[i], q[i])
        Xj = np.block([[E, np.zeros((3, 3))], [np.zeros((3, 3)), E]])
        xup[i] = Xj @ model.xtree[i]
    IC = [model.inertia[i].copy() for i in range(nb)]
    for i in range(nb - 1, 5, -1):
        par = int(model.parent[i])
        IC[par] = IC[par] + xup[i].T @ IC[i] @ xup[i]
    return IC[5]


@functools.lru_cache(maxsize=8)
def srbm_constants(name: str = "mc3D"):
    """Derived SRBM constants (mass, body inertia diag & inverse) at q_home.

    Matches the reference's ``[~, Ibody] = get_mass_matrix(model, q_home, 0)``
    then ``mass = Ibody(6,6); Ib = diag(Ibody(1:3,1:3))``
    (landing_optimization.m:240-244).  float64 on the host.
    """
    model = get_robot_model(name)
    ic = composite_inertia_np(model, model.q_home)
    mass = float(ic[5, 5])
    ib_diag = np.diag(ic[:3, :3]).copy()
    ib_inv_diag = np.diag(np.linalg.inv(ic[:3, :3])).copy()
    return mass, ib_diag, ib_inv_diag
