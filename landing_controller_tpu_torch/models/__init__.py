"""Robot parameter registry, the quad3D rigid-body model and the derived SRBM
constants (host-side float64)."""

from .model import RobotModel, get_robot_model, srbm_constants
from .params import RobotParams, get_robot_params

__all__ = ["RobotParams", "get_robot_params", "RobotModel", "get_robot_model", "srbm_constants"]
