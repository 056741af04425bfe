"""SRBM dynamics and rotation kinematics."""
