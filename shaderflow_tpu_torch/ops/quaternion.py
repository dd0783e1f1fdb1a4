"""
Quaternion algebra as plain float64 numpy arrays [w, x, y, z].

Same functions as shaderflow_tpu/ops/quaternion.py. Camera orientation
state lives on the host (smoothed per frame, driven by events), so this is
numpy on purpose; a copy rather than an import, because importing the
reference module imports jax through shaderflow_tpu.ops. The device-side
ray math lives in ops/cameralib.py.
"""

from __future__ import annotations

import math

import numpy as np

IDENTITY = np.array([1.0, 0.0, 0.0, 0.0])


def quaternion(axis: np.ndarray, degrees: float) -> np.ndarray:
    """Rotation of `degrees` around `axis` (not required to be unit)."""
    theta = math.radians(degrees / 2.0)
    return np.array([math.cos(theta), *(math.sin(theta) * np.asarray(axis, dtype=np.float64))])


def qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def qconj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def qnorm(q: np.ndarray) -> float:
    return float(np.linalg.norm(q))


def qnormalize(q: np.ndarray) -> np.ndarray:
    n = qnorm(q)
    return q / n if n else q


def rotate_vector(vector: np.ndarray, rotation: np.ndarray) -> np.ndarray:
    """Apply quaternion rotation R * (0, v) * R^-1, vector part."""
    v = np.asarray(vector, dtype=np.float64)
    p = np.array([0.0, v[0], v[1], v[2]])
    return qmul(qmul(rotation, p), qconj(rotation))[1:]


def angle(a: np.ndarray, b: np.ndarray) -> float:
    """Angle between two vectors in degrees; safe for zero norms / domain."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    la = np.linalg.norm(a)
    lb = np.linalg.norm(b)
    if not la or not lb:
        return 0.0
    cos = np.clip(np.dot(a, b) / (la * lb), -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def unit_vector(vector: np.ndarray) -> np.ndarray:
    vector = np.asarray(vector, dtype=np.float64)
    magnitude = np.linalg.norm(vector)
    return vector / magnitude if magnitude else vector
