"""
Shader standard library in PyTorch — the subset of shaderflow_tpu/ops/stdlib.py
the ported slices use: constants, vector constructors, the GLSL built-ins
mix / clamp / smoothstep, the vector algebra the general camera needs (dot,
cross, length, normalize, rotate3d), the magma palette and the piano-key
tests. Vectors live on the last axis; values are float32. Sums over a
vector's components are written out left to right (the reference's reduce
order), and the cross product uses jnp.cross's expression order.
"""

from __future__ import annotations

import numpy as np
import torch

# Constants (shaderflow.glsl:7-11)
PI = 3.1415926535897932
TAU = 6.2831853071795864


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    if isinstance(x, (int, float)) and device is not None:
        # a fill on the device: a host->device copy of a pageable scalar
        # would wait for the stream (no host syncs in the frame loop)
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device(*parts):
    return next((p.device for p in parts if isinstance(p, torch.Tensor)), None)


def _broadcast_stack(*parts) -> torch.Tensor:
    device = _device(*parts)
    parts = [_f32(p, device) for p in parts]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def vec2(x, y=None) -> torch.Tensor:
    """Build a (..., 2) vector from components (GLSL vec2)."""
    return _broadcast_stack(x, x if y is None else y)


def vec4(x, y=None, z=None, w=None) -> torch.Tensor:
    if y is None:
        return _broadcast_stack(x, x, x, x)
    if z is None:  # vec4(vec3, w)
        x = torch.as_tensor(x, dtype=torch.float32)
        w = torch.broadcast_to(
            torch.as_tensor(y, dtype=torch.float32, device=x.device),
            x.shape[:-1])
        return torch.cat([x, w[..., None]], dim=-1)
    return _broadcast_stack(x, y, z, w)


# --------------------------------------------------------------------------- #
# GLSL built-in equivalents

def reciprocal(value: float) -> float:
    """1 / value rounded once to float32. The port writes a division by a
    constant as a product with this value: the reference's compiled
    division (XLA folds x / c into x * (1 / c)), and what eager torch on
    the card computes for a division by a host scalar."""
    return float(np.float32(1.0) / np.float32(value))


def mix(a, b, t) -> torch.Tensor:
    device = _device(a, b, t)
    a, b = _f32(a, device), _f32(b, device)
    return a + (b - a) * _f32(t, device)


def clamp(x, lo, hi) -> torch.Tensor:
    return torch.clamp(x, lo, hi)


def smoothstep(edge0, edge1, x) -> torch.Tensor:
    """GLSL smoothstep. With constant (Python number) edges the division by
    (e1 - e0) is a product with its f32 reciprocal, as the reference's
    compiled division by a constant."""
    if isinstance(edge0, (int, float)) and isinstance(edge1, (int, float)):
        t = (_f32(x) - edge0) * reciprocal(edge1 - edge0)
    else:
        t = (_f32(x) - edge0) / (edge1 - edge0)
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def dot(a, b) -> torch.Tensor:
    device = _device(a, b)
    p = _f32(a, device) * _f32(b, device)
    total = p[..., 0]
    for k in range(1, p.shape[-1]):
        total = total + p[..., k]
    return total


def cross(a, b) -> torch.Tensor:
    device = _device(a, b)
    a, b = _f32(a, device), _f32(b, device)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(torch.broadcast_tensors(
        a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim=-1)


def length(v) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v) -> torch.Tensor:
    v = _f32(v)
    return v / torch.clamp(length(v)[..., None], min=1e-12)


def rotate3d(vector, axis, angle) -> torch.Tensor:
    """Rotate a vector around an axis, right-handed (Rodrigues, as the GLSL)."""
    device = _device(vector, axis, angle)
    vector, axis, angle = _f32(vector, device), _f32(axis, device), _f32(angle, device)
    cos_t = torch.cos(angle)[..., None]
    sin_t = torch.sin(angle)[..., None]
    return (mix(dot(axis, vector)[..., None] * axis, vector, cos_t)
            + cross(axis, vector) * sin_t)


# Magma palette stops (shaderflow.glsl:212-226)
PALETTE_MAGMA_1 = torch.tensor([0.01060815, 0.01808215, 0.10018654], dtype=torch.float32)
PALETTE_MAGMA_2 = torch.tensor([0.38092887, 0.12061482, 0.32506528], dtype=torch.float32)
PALETTE_MAGMA_3 = torch.tensor([0.79650140, 0.10506637, 0.31063031], dtype=torch.float32)
PALETTE_MAGMA_4 = torch.tensor([0.95922872, 0.53307513, 0.37488950], dtype=torch.float32)


# --------------------------------------------------------------------------- #
# Piano and MIDI keys (shaderflow.glsl:231-245)

def is_black_key(index) -> torch.Tensor:
    key = torch.remainder(torch.as_tensor(index).to(torch.int32), 12)
    return (key == 1) | (key == 3) | (key == 6) | (key == 8) | (key == 10)


def is_white_key(index) -> torch.Tensor:
    return ~is_black_key(index)
