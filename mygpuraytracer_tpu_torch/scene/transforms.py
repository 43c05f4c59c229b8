"""Affine transform construction for scene geometry.

Semantics match utilityCore::buildTransformationMatrix
(apps/src/utilities.cpp:65-72): M = T * Rx * Ry * Rz * S with rotation angles
given in degrees. Matrices are built in numpy at scene-load time (host side);
only the resulting [4,4] arrays go to the device.
"""

from __future__ import annotations

import math

import numpy as np


def _rot_x(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rot_y(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def _rot_z(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def build_transformation_matrix(
    translation, rotation, scale
) -> np.ndarray:
    """T @ Rx @ Ry @ Rz @ S, rotations in degrees (utilities.cpp:65-72)."""
    t = np.eye(4, dtype=np.float64)
    t[:3, 3] = np.asarray(translation, dtype=np.float64)
    s = np.diag([*np.asarray(scale, dtype=np.float64), 1.0])
    m = t @ _rot_x(rotation[0]) @ _rot_y(rotation[1]) @ _rot_z(rotation[2]) @ s
    return m.astype(np.float32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """glm::inverseTranspose equivalent (scene.cpp:304)."""
    return np.linalg.inv(m.astype(np.float64)).T.astype(np.float32)
