"""
shaderflow_tpu_torch.ops — the PyTorch shader standard library (the part of
shaderflow_tpu.ops that the ported slices use).
"""

from shaderflow_tpu_torch.ops import (  # noqa: F401
    cameralib, downsample, dynamics, fractal, quaternion, stdlib, tailfuse,
)
from shaderflow_tpu_torch.ops.stdlib import (  # noqa: F401
    PALETTE_MAGMA_1, PALETTE_MAGMA_2, PALETTE_MAGMA_3, PALETTE_MAGMA_4,
    PI, TAU, clamp, cross, dot, is_black_key, is_white_key, length, mix,
    normalize, rotate3d, smoothstep, vec2, vec4,
)
