"""SRBM dynamics, rotation kinematics and closed-form leg kinematics."""
