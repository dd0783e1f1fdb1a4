"""
Shader standard library in PyTorch — the subset of shaderflow_tpu/ops/stdlib.py
the ported slices use (constants, vector constructors, the magma palette).
Vectors live on the last axis; values are float32.
"""

from __future__ import annotations

import torch

# Constants (shaderflow.glsl:7-11)
PI = 3.1415926535897932
TAU = 6.2831853071795864


def _broadcast_stack(*parts) -> torch.Tensor:
    device = next((p.device for p in parts if isinstance(p, torch.Tensor)),
                  None)
    parts = [torch.as_tensor(p, dtype=torch.float32, device=device)
             for p in parts]
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


# Magma palette stops (shaderflow.glsl:212-226)
PALETTE_MAGMA_1 = torch.tensor([0.01060815, 0.01808215, 0.10018654], dtype=torch.float32)
PALETTE_MAGMA_2 = torch.tensor([0.38092887, 0.12061482, 0.32506528], dtype=torch.float32)
PALETTE_MAGMA_3 = torch.tensor([0.79650140, 0.10506637, 0.31063031], dtype=torch.float32)
PALETTE_MAGMA_4 = torch.tensor([0.95922872, 0.53307513, 0.37488950], dtype=torch.float32)
