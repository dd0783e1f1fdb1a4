"""
Complex arithmetic over (..., 2) tensors.

Port of shaderflow_tpu/ops/complexmath.py (the reference GLSL complex
library, complex.glsl, where a complex number is a vec2): the same
expressions in the same order. Used by the Tetration scene.
"""

from __future__ import annotations

import torch


def cadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def csub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def cmag(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])


def cpol(a: torch.Tensor) -> torch.Tensor:
    """Cartesian to polar (r, theta)."""
    return torch.stack([cmag(a), torch.arctan2(a[..., 1], a[..., 0])], dim=-1)


def ccar(polar: torch.Tensor) -> torch.Tensor:
    """Polar to cartesian."""
    r, t = polar[..., 0], polar[..., 1]
    return torch.stack([r * torch.cos(t), r * torch.sin(t)], dim=-1)


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay = a[..., 0], a[..., 1]
    bx, by = b[..., 0], b[..., 1]
    return torch.stack(torch.broadcast_tensors(ax * bx - ay * by, ax * by + ay * bx), dim=-1)


def cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay = a[..., 0], a[..., 1]
    bx, by = b[..., 0], b[..., 1]
    den = bx * bx + by * by
    return torch.stack(torch.broadcast_tensors(
        (ax * bx + ay * by) / den, (ay * bx - ax * by) / den), dim=-1)


def cconj(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def cexp(a: torch.Tensor) -> torch.Tensor:
    expx = torch.exp(a[..., 0])
    return torch.stack([expx * torch.cos(a[..., 1]), expx * torch.sin(a[..., 1])], dim=-1)


def cpow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex power a**b via polar form (the tetration fractal's step)."""
    r = cmag(a)
    t = torch.arctan2(a[..., 1], a[..., 0])
    bx, by = b[..., 0], b[..., 1]
    nr = torch.pow(r, bx) * torch.exp(-by * t)
    nt = by * torch.log(r) + bx * t
    return torch.stack(torch.broadcast_tensors(nr * torch.cos(nt), nr * torch.sin(nt)), dim=-1)
