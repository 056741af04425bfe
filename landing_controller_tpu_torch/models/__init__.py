"""Robot parameters and derived SRBM constants (host-side float64)."""

from .model import srbm_constants
from .params import RobotParams, get_robot_params

__all__ = ["RobotParams", "get_robot_params", "srbm_constants"]
