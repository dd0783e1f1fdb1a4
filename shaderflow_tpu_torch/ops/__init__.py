"""
shaderflow_tpu_torch.ops — the PyTorch shader standard library.

`from shaderflow_tpu_torch.ops import *` inside a pixel program gives the
vocabulary of shaderflow_tpu.ops: the whole stdlib, the complex library
and the GL sampler with its coordinate-space accessors.
"""

from shaderflow_tpu_torch.ops import (  # noqa: F401
    cameralib, complexmath, downsample, dynamics, fractal, quaternion, sampling,
    stdlib, tailfuse,
)
from shaderflow_tpu_torch.ops.complexmath import (  # noqa: F401
    cadd, ccar, cconj, cdiv, cexp, cmag, cmul, cpol, cpow, csub,
)
from shaderflow_tpu_torch.ops.sampling import (  # noqa: F401
    MipSampler, Sampler2D, agtexture, astexture, gmtexture, gtexture, sample, stexture,
    texel_fetch,
)
from shaderflow_tpu_torch.ops.stdlib import *  # noqa: F401,F403 — the GLSL-like vocabulary
from shaderflow_tpu_torch.ops.stdlib import (  # noqa: F401
    PI, TAU, SQRT2, SQRT3, SQRT5,
    vec2, vec3, vec4, X, Y, Z, W, XY, YX, RGB, A, with_alpha, with_rgb,
    fract, mix, clamp, step, smoothstep, glsl_mod, length, distance, dot, cross,
    normalize, reflect, sign, radians, degrees,
    proportion, lerp, smoothlerp, smin, smax, smoothmix, smix, triangle_wave,
    angle_between, rotate2d, rotate2deg, rotate3d, rotate3deg,
    stuv2gluv, gluv2stuv, s2g, g2s, agluv2gluv, gluv2agluv, stuv2stxy, stxy2stuv,
    astuv2stuv, stuv2astuv, agluv_mirrored_repeat, gluv_mirrored_repeat,
    astuv_oob, stuv_oob, agluv_oob, gluv_oob, polar2rect, sphere2rect,
    palette, palette_magma, PALETTE_MAGMA_1, PALETTE_MAGMA_2, PALETTE_MAGMA_3,
    PALETTE_MAGMA_4, is_black_key, is_white_key,
    sd_line, sd_line_segment, sd_sphere, sd_plane, sd_box, sd_octahedron,
    sd_union, sd_smooth_union, sd_subtraction, sd_smooth_subtraction,
    sd_intersection, sd_smooth_intersection,
    blend, alpha_composite, saturate, zoom,
    atan_normalized, atan1, atan1n, atan2, atan2n,
    hsv2rgb, hsv2rgb3, rgb2hsv, noise21, noise22, noise11,
    folded, reciprocal, scaled_quotient,
)
