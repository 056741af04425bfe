"""Robot parameter registry (host-side numpy, float64).

The port's own copy of the mc3D / mcv3D parameter sets of the reference
registry (dynamics-utilities/get_robot_params.m:50-190).  Only the fields the
landing problems need are kept: link geometry (with the derived leg link
lengths of the closed-form kinematics), masses and spatial inertias (for the
18-body model and its SRBM constants in :mod:`.model`), the SRBM hip
locations, and the gear ratios and motor constants of the voltage-limit
rows.  ``register_robot`` adds a named set.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _spatial_inertia_np(mass, com, I3):
    com = np.asarray(com, dtype=np.float64)
    I3 = np.asarray(I3, dtype=np.float64)
    C = np.array(
        [
            [0, -com[2], com[1]],
            [com[2], 0, -com[0]],
            [-com[1], com[0], 0],
        ]
    )
    return np.block([[I3 + mass * (C @ C.T), mass * C], [mass * C.T, mass * np.eye(3)]])


@dataclasses.dataclass(frozen=True)
class RobotParams:
    """Static quadruped parameters (mc3D layout, get_robot_params.m:92-122)."""

    name: str
    body_mass: float
    body_length: float  # the body box of the viewers (viz.animate)
    body_width: float
    body_height: float
    body_inertia: np.ndarray  # 6x6 spatial
    abad_inertia: np.ndarray
    hip_inertia: np.ndarray
    knee_inertia: np.ndarray
    abad_location: np.ndarray  # (3,) in body frame
    hip_location: np.ndarray  # (3,) abad->hip offset
    knee_location: np.ndarray  # (3,) hip->knee offset
    foot_location: np.ndarray  # (3,) knee->foot offset
    hip_srbm_location: np.ndarray  # (4,3) SRBM hip positions
    abad_gear_ratio: float
    hip_gear_ratio: float
    knee_gear_ratio: float
    motor_kt: float
    motor_r: float
    motor_tau_max: float
    battery_v: float
    knee_link_y_offset: float = 0.004  # l_4 in the analytic Jacobian (get_foot_jacobians_mc.m:8)

    # Derived leg link lengths used by closed-form kinematics:
    @property
    def l1(self) -> float:
        """Ab/ad link length = hipLocation(2) (get_foot_jacobians_mc.m:5)."""
        return float(self.hip_location[1])

    @property
    def l2(self) -> float:
        """Upper (hip) link length = -kneeLocation(3)."""
        return float(-self.knee_location[2])

    @property
    def l3(self) -> float:
        """Lower (knee) link length = -footLocation(3)."""
        return float(-self.foot_location[2])


def _mc3d() -> RobotParams:
    body_mass = 3.3
    abad_rot = 1e-6 * np.array([[381, 58, 0.45], [58, 560, 0.95], [0.45, 0.95, 444]])
    hip_rot = 1e-6 * np.array([[1983, 245, 13], [245, 2103, 1.5], [13, 1.5, 408]])
    knee_rot = 1e-6 * np.array([[6, 0, 0], [0, 248, 0], [0, 0, 245]])
    body_rot = 1e-6 * np.array([[11253, 0, 0], [0, 36203, 0], [0, 0, 42673]])
    return RobotParams(
        name="mc3D",
        body_mass=body_mass,
        body_length=0.19 * 2,
        body_width=0.049 * 2,
        body_height=0.05 * 2,
        body_inertia=_spatial_inertia_np(body_mass, [0, 0, 0], body_rot),
        abad_inertia=_spatial_inertia_np(0.54, [0, 0.036, 0], abad_rot),
        hip_inertia=_spatial_inertia_np(0.634, [0, 0.016, -0.02], hip_rot),
        knee_inertia=_spatial_inertia_np(0.064, [0, 0, -0.061], knee_rot),
        abad_location=np.array([0.19, 0.049, 0.0]),
        hip_location=np.array([0.0, 0.062, 0.0]),
        knee_location=np.array([0.0, 0.0, -0.209]),
        foot_location=np.array([0.0, 0.0, -0.195]),
        hip_srbm_location=np.array(
            [[0.19, -0.1, 0.0], [0.19, 0.1, 0.0], [-0.19, -0.1, 0.0], [-0.19, 0.1, 0.0]]
        ),
        abad_gear_ratio=6.0,
        hip_gear_ratio=6.0,
        knee_gear_ratio=9.33,
        motor_kt=0.05,
        motor_r=0.173,
        motor_tau_max=3.0,
        battery_v=24.0,
    )


def _mcv3d() -> RobotParams:
    """Mini-Cheetah-Vision variant (get_robot_params.m:124-190)."""
    base = _mc3d()
    body_mass = 3.8
    body_rot = 1e-6 * np.array([[11253, 0, 0], [0, 36203, 0], [0, 0, 42673]])
    return dataclasses.replace(
        base,
        name="mcv3D",
        body_mass=body_mass,
        body_length=0.20275 * 2,
        body_inertia=_spatial_inertia_np(body_mass, [0, 0, 0], body_rot),
        hip_srbm_location=np.array(
            [
                [0.20275, -0.1, 0.0],
                [0.20275, 0.1, 0.0],
                [-0.20275, -0.1, 0.0],
                [-0.20275, 0.1, 0.0],
            ]
        ),
    )


_REGISTRY = {"mc3D": _mc3d, "mcv3D": _mcv3d}


def get_robot_params(name: str = "mc3D") -> RobotParams:
    """Look up a named robot parameter set (get_robot_params.m:1-12)."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown robot '{name}'; available: {sorted(_REGISTRY)}") from None


def register_robot(name: str, factory) -> None:
    """Extend the registry with a named parameter set: ``factory()`` returns
    its :class:`RobotParams`."""
    _REGISTRY[name] = factory
