"""Dynamics kit: rotations, spatial algebra, quaternions, Featherstone's
rigid-body algorithms, the closed-form leg kinematics and the SRBM."""

from . import featherstone, legs, quaternion, rotations, spatial, srbm

__all__ = ["rotations", "spatial", "featherstone", "legs", "quaternion", "srbm"]
