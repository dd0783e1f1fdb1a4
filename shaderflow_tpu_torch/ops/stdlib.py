"""
Shader standard library in PyTorch.

Port of shaderflow_tpu/ops/stdlib.py, every public name: constants, vector
constructors and swizzles, the GLSL built-ins, interpolation, waveforms,
rotations, coordinate conversions, palettes, piano-key predicates, signed
distance functions, compositing, zoom, the atan variants, HSV color space
and hash noise. A "pixel" is any broadcastable tensor, vectors live on the
last axis, values are float32.

The reference's values are those of its compiled programs (XLA), and the
port computes them in the same order:
  * sums over a vector's components run left to right (the reduce order),
    and the cross product uses jnp.cross's expression order
  * a division by a constant (a Python number) is a product with its f32
    reciprocal (`reciprocal`), as XLA folds x / c
  * a chain of products with constants is one product with the constants
    folded in f32 (`folded`), as XLA reassociates (x * c1) * c2; so
    c1 * (x / c2) is x * (c1 * (1 / c2)) (`scaled_quotient`: hsv2rgb's
    sector, atan_normalized)
  * GLSL mod is the floored modulo of jnp.mod (torch.remainder: fmod, then
    + y where the remainder's sign differs from y's), not torch.fmod
"""

from __future__ import annotations

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# Constants (shaderflow.glsl:7-11)

PI = 3.1415926535897932
TAU = 6.2831853071795864
SQRT2 = 1.4142135623730951
SQRT3 = 1.7320508075688772
SQRT5 = 2.2360679774997898


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    if isinstance(x, (int, float)) and device is not None:
        # a fill on the device: a host->device copy of a pageable scalar
        # would wait for the stream (no host syncs in the frame loop)
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _device(*parts):
    return next((p.device for p in parts if isinstance(p, torch.Tensor)), None)


def _number(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def reciprocal(value: float) -> float:
    """1 / value rounded once to float32. The port writes a division by a
    constant as a product with this value: the reference's compiled
    division (XLA folds x / c into x * (1 / c)), and what eager torch on
    the card computes for a division by a host scalar."""
    return float(np.float32(1.0) / np.float32(value))


def folded(a: float, b: float) -> float:
    """The f32 product of two constants, as XLA folds them: it rewrites
    (x * c1) * c2 as x * (c1 * c2) and computes c1 * c2 once in float32,
    also where x * c1 has other users."""
    return float(np.float32(a) * np.float32(b))


def scaled_quotient(x, scale: float, value: float):
    """scale * (x / value) for constants scale and value, as the reference's
    compiled program computes it: XLA folds the division into a product
    with the f32 reciprocal and reassociates the two constants, so x meets
    the one f32 constant scale * (1 / value)."""
    return x * folded(scale, reciprocal(value))


def _quotient(x, y):
    """x / y, with a constant y as a product with its f32 reciprocal."""
    return x * reciprocal(y) if _number(y) else x / y


# --------------------------------------------------------------------------- #
# Vector constructors and swizzles

def _broadcast_stack(*parts) -> torch.Tensor:
    device = _device(*parts)
    parts = [_f32(p, device) for p in parts]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def vec2(x, y=None) -> torch.Tensor:
    """Build a (..., 2) vector from components (GLSL vec2)."""
    return _broadcast_stack(x, x if y is None else y)


def vec3(x, y=None, z=None) -> torch.Tensor:
    if y is None:
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[-1] == 3:
            return x.to(torch.float32)
        return _broadcast_stack(x, x, x)
    return _broadcast_stack(x, y, z)


def vec4(x, y=None, z=None, w=None) -> torch.Tensor:
    if y is None:
        return _broadcast_stack(x, x, x, x)
    if z is None:  # vec4(vec3, w)
        x = _f32(x, _device(y))
        w = torch.broadcast_to(_f32(y, x.device), x.shape[:-1])
        return torch.cat([x, w[..., None]], dim=-1)
    return _broadcast_stack(x, y, z, w)


def X(v): return v[..., 0]
def Y(v): return v[..., 1]
def Z(v): return v[..., 2]
def W(v): return v[..., 3]
def XY(v): return v[..., 0:2]
def YX(v): return v[..., [1, 0]]
def RGB(v): return v[..., 0:3]
def A(v): return v[..., 3]


def with_rgb(color: torch.Tensor, rgb) -> torch.Tensor:
    """Return color with .rgb replaced (colors are immutable tensors)."""
    rgb = torch.broadcast_to(_f32(rgb, color.device), color[..., :3].shape)
    return torch.cat([rgb, color[..., 3:]], dim=-1)


def with_alpha(color: torch.Tensor, a) -> torch.Tensor:
    a = torch.broadcast_to(_f32(a, color.device).to(color.dtype), color[..., :1].shape)
    return torch.cat([color[..., :3], a], dim=-1)


# --------------------------------------------------------------------------- #
# GLSL built-in equivalents

def fract(x) -> torch.Tensor:
    x = _f32(x)
    return x - torch.floor(x)


def mix(a, b, t) -> torch.Tensor:
    device = _device(a, b, t)
    a, b = _f32(a, device), _f32(b, device)
    return a + (b - a) * _f32(t, device)


def clamp(x, lo, hi) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else _f32(x)
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        # jnp.clip: minimum(maximum(x, lo), hi)
        return torch.minimum(torch.maximum(x, _f32(lo, x.device)), _f32(hi, x.device))
    return torch.clamp(x, lo, hi)


def step(edge, x) -> torch.Tensor:
    x = _f32(x, _device(edge))
    return torch.where(x < edge, 0.0, 1.0).to(torch.float32)


def smoothstep(edge0, edge1, x) -> torch.Tensor:
    """GLSL smoothstep. With constant (Python number) edges the division by
    (e1 - e0) is a product with its f32 reciprocal, as the reference's
    compiled division by a constant."""
    if _number(edge0) and _number(edge1):
        t = (_f32(x) - edge0) * reciprocal(edge1 - edge0)
    else:
        t = (_f32(x) - edge0) / (edge1 - edge0)
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def glsl_mod(x, y) -> torch.Tensor:
    """GLSL mod(), x - y * floor(x / y) in exact arithmetic: the floored
    modulo of jnp.mod (torch.remainder), not torch.fmod."""
    return torch.remainder(_f32(x, _device(y)), y)


def dot(a, b) -> torch.Tensor:
    device = _device(a, b)
    p = _f32(a, device) * _f32(b, device)
    total = p[..., 0]
    for k in range(1, p.shape[-1]):
        total = total + p[..., k]
    return total


def length(v, axis: int = -1) -> torch.Tensor:
    v = _f32(v)
    if axis != -1:
        v = v.movedim(axis, -1)
    return torch.sqrt(dot(v, v))


def distance(a, b) -> torch.Tensor:
    device = _device(a, b)
    return length(_f32(a, device) - _f32(b, device))


def cross(a, b) -> torch.Tensor:
    device = _device(a, b)
    a, b = _f32(a, device), _f32(b, device)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(torch.broadcast_tensors(
        a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim=-1)


def normalize(v) -> torch.Tensor:
    v = _f32(v)
    return v / torch.clamp(length(v)[..., None], min=1e-12)


def reflect(incident, normal) -> torch.Tensor:
    device = _device(incident, normal)
    incident, normal = _f32(incident, device), _f32(normal, device)
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def sign(x) -> torch.Tensor:
    return torch.sign(_f32(x))


def radians(deg) -> torch.Tensor:
    return _f32(deg) * (PI / 180.0)


def degrees(rad) -> torch.Tensor:
    return _f32(rad) * (180.0 / PI)


# --------------------------------------------------------------------------- #
# Interpolation (shaderflow.glsl:24-57)

def proportion(a, b, c) -> torch.Tensor:
    """Cross multiplication: (a/c) = (b/?), returns '?'."""
    return _quotient(_f32(b, _device(a, c)) * c, a)


def lerp(ax, ay, bx, by, x) -> torch.Tensor:
    """Interpolate between points (Ax, Ay), (Bx, By) at x."""
    x = _f32(x, _device(ax, ay, bx, by))
    return ay + _quotient((x - ax) * (by - ay), bx - ax)


def smoothlerp(a, b, difference) -> torch.Tensor:
    """Smooth relative interpolation given a magnitude difference factor."""
    device = _device(a, b, difference)
    a, b = _f32(a, device), _f32(b, device)
    t = torch.clamp(_quotient(a - b, difference) + 0.5, 0.0, 1.0)
    offset = difference * t * (1.0 - t) / 2.0
    return mix(a, b, t) - offset


def smin(a, b, k=1.0) -> torch.Tensor:
    return smoothlerp(a, b, k)


def smax(a, b, k=1.0) -> torch.Tensor:
    return smoothlerp(a, b, -k)


def smoothmix(a, b, x0, x1, x) -> torch.Tensor:
    return mix(a, b, smoothstep(x0, x1, x))


smix = smoothmix


# --------------------------------------------------------------------------- #
# Waveforms (shaderflow.glsl:62-65)

def triangle_wave(x, period) -> torch.Tensor:
    """Triangle wave starting at zero, amplitude 1, range (-1, 1)."""
    x = _f32(x, _device(period))
    wave = (scaled_quotient(x, 2.0, period) if _number(period)
            else 2.0 * x / period)
    return 2.0 * torch.abs(torch.remainder(wave - 0.5, 2.0) - 1.0) - 1.0


# --------------------------------------------------------------------------- #
# Angles and rotations (shaderflow.glsl:70-86)

def angle_between(a, b) -> torch.Tensor:
    return torch.arccos(torch.clamp(dot(a, b) / (length(a) * length(b)), -1.0, 1.0))


def rotate2d(v, angle) -> torch.Tensor:
    """Apply the reference's 2D rotation: GLSL `rotate2d(angle) * v` where the
    mat2 is column-major mat2(c,-s,s,c) -> result (c*x + s*y, -s*x + c*y)."""
    angle = _f32(angle, _device(v))
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = v[..., 0], v[..., 1]
    return torch.stack(torch.broadcast_tensors(c * x + s * y, -s * x + c * y), dim=-1)


def rotate2deg(v, angle_degrees) -> torch.Tensor:
    return rotate2d(v, radians(_f32(angle_degrees, _device(v))))


def rotate3d(vector, axis, angle) -> torch.Tensor:
    """Rotate a vector around an axis, right-handed (Rodrigues, as the GLSL)."""
    device = _device(vector, axis, angle)
    vector, axis, angle = _f32(vector, device), _f32(axis, device), _f32(angle, device)
    cos_t = torch.cos(angle)[..., None]
    sin_t = torch.sin(angle)[..., None]
    return (mix(dot(axis, vector)[..., None] * axis, vector, cos_t)
            + cross(axis, vector) * sin_t)


def rotate3deg(vector, axis, angle_degrees) -> torch.Tensor:
    return rotate3d(vector, axis, radians(_f32(angle_degrees, _device(vector, axis))))


# --------------------------------------------------------------------------- #
# Coordinate conversions (shaderflow.glsl:91-159)
#
#   astuv: absolute (0,0)-(1,1), aspect-free       (ShaderToy-style)
#   agluv: absolute (-1,-1)-(1,1), aspect-free     (OpenGL NDC-style)
#   stuv / gluv: aspect-ratio-corrected variants (x scaled by aspect for gluv)
#   stxy / glxy: pixel coordinates

def stuv2gluv(stuv):
    return stuv * 2.0 - 1.0


s2g = stuv2gluv


def gluv2stuv(gluv):
    return (gluv + 1.0) / 2.0


g2s = gluv2stuv


def agluv2gluv(agluv, aspect):
    return agluv * vec2(_f32(aspect, agluv.device), 1.0)


def gluv2agluv(gluv, aspect):
    if _number(aspect):
        return gluv * vec2(_f32(reciprocal(aspect), gluv.device), 1.0)
    return gluv / vec2(_f32(aspect, gluv.device), 1.0)


def stuv2stxy(stuv, resolution):
    return _f32(resolution, stuv.device) * stuv


def stxy2stuv(stxy, resolution):
    if isinstance(resolution, torch.Tensor):     # a per-frame uniform
        return stxy / resolution
    # a constant: the product with each component's f32 reciprocal
    return stxy * _f32([reciprocal(v) for v in np.asarray(resolution).reshape(-1)],
                       stxy.device)


def astuv2stuv(astuv, aspect):
    return vec2(astuv[..., 0] * aspect + (1.0 - aspect) / 2.0, astuv[..., 1])


def stuv2astuv(stuv, aspect):
    return vec2(_quotient(stuv[..., 0] - (1.0 - aspect) / 2.0, aspect), stuv[..., 1])


def agluv_mirrored_repeat(agluv):
    return vec2(triangle_wave(agluv[..., 0], 4.0), triangle_wave(agluv[..., 1], 4.0))


def gluv_mirrored_repeat(gluv, want_aspect):
    return vec2(
        want_aspect * triangle_wave(gluv[..., 0], 4.0 * want_aspect),
        triangle_wave(gluv[..., 1], 4.0),
    )


def astuv_oob(astuv):
    x, y = astuv[..., 0], astuv[..., 1]
    return (x < 0) | (x > 1) | (y < 0) | (y > 1)


def stuv_oob(stuv, aspect):
    return astuv_oob(stuv2astuv(stuv, aspect))


def agluv_oob(agluv):
    x, y = agluv[..., 0], agluv[..., 1]
    return (x < -1) | (x > 1) | (y < -1) | (y > 1)


def gluv_oob(gluv, aspect):
    return agluv_oob(gluv2agluv(gluv, aspect))


def polar2rect(radius, angle):
    angle = _f32(angle, _device(radius))
    return radius * vec2(torch.cos(angle), torch.sin(angle))


def sphere2rect(radius, theta, phi):
    device = _device(radius, theta, phi)
    theta, phi = _f32(theta, device), _f32(phi, device)
    return vec3(
        radius * torch.sin(theta) * torch.cos(phi),
        radius * torch.sin(theta) * torch.sin(phi),
        radius * torch.cos(theta),
    )


# --------------------------------------------------------------------------- #
# Palettes (shaderflow.glsl:212-226)

def palette(t, A, B, C, D):
    """4-stop palette: A->B over [0,.25), B->C over [.25,.5), C->D after."""
    t = _f32(t)[..., None]
    A, B, C, D = (_f32(x, t.device) for x in (A, B, C, D))
    ab = mix(A, B, t * 4.0)
    bc = mix(B, C, (t - 0.25) * 4.0)
    cd = mix(C, D, (t - 0.5) * 4.0)
    return torch.where(t < 0.25, ab, torch.where(t < 0.5, bc, cd))


PALETTE_MAGMA_1 = torch.tensor([0.01060815, 0.01808215, 0.10018654], dtype=torch.float32)
PALETTE_MAGMA_2 = torch.tensor([0.38092887, 0.12061482, 0.32506528], dtype=torch.float32)
PALETTE_MAGMA_3 = torch.tensor([0.79650140, 0.10506637, 0.31063031], dtype=torch.float32)
PALETTE_MAGMA_4 = torch.tensor([0.95922872, 0.53307513, 0.37488950], dtype=torch.float32)


def palette_magma(x):
    return palette(x, PALETTE_MAGMA_1, PALETTE_MAGMA_2, PALETTE_MAGMA_3, PALETTE_MAGMA_4)


# --------------------------------------------------------------------------- #
# Piano and MIDI keys (shaderflow.glsl:231-245)

def is_black_key(index) -> torch.Tensor:
    key = torch.remainder(torch.as_tensor(index).to(torch.int32), 12)
    return (key == 1) | (key == 3) | (key == 6) | (key == 8) | (key == 10)


def is_white_key(index) -> torch.Tensor:
    return ~is_black_key(index)


# --------------------------------------------------------------------------- #
# Signed distance functions (shaderflow.glsl:255-332)

def _sd_line(origin, a, b, segment: bool):
    device = _device(origin, a, b)
    a = _f32(a, device)
    direction = _f32(b, device) - a
    shortest = _f32(origin, device) - a
    t = dot(shortest, direction) / dot(direction, direction)
    if segment:
        t = torch.clamp(t, 0.0, 1.0)
    return length(shortest - direction * t[..., None])


def sd_line(origin, p1, p2):
    return _sd_line(origin, p1, p2, segment=False)


def sd_line_segment(origin, p1, p2):
    return _sd_line(origin, p1, p2, segment=True)


def sd_sphere(origin, position, radius):
    device = _device(origin, position)
    return length(_f32(position, device) - origin) - radius


def sd_plane(origin, point, normal):
    device = _device(origin, point, normal)
    return dot(_f32(origin, device) - _f32(point, device), normalize(_f32(normal, device)))


def sd_box(origin, point, size):
    device = _device(origin, point, size)
    d = torch.abs(_f32(origin, device) - _f32(point, device)) - _f32(size, device) / 2.0
    inner = torch.clamp(torch.amax(d, dim=-1), max=0.0)
    return inner + length(torch.clamp(d, min=0.0))


def sd_octahedron(origin, point, size):
    device = _device(origin, point)
    p = torch.abs(_f32(origin, device) - _f32(point, device))
    total = p[..., 0]
    for k in range(1, p.shape[-1]):
        total = total + p[..., k]
    return SQRT3 * (total - size)


def sd_union(a, b):
    return torch.minimum(a, b)


def sd_smooth_union(a, b, width):
    k = torch.clamp(0.5 + _quotient(0.5 * (b - a), width), 0.0, 1.0)
    return mix(b, a, k) - width * k * (1.0 - k)


def sd_subtraction(a, b):
    return torch.maximum(b, -a)


def sd_smooth_subtraction(a, b, width):
    k = torch.clamp(0.5 - _quotient(0.5 * (b + a), width), 0.0, 1.0)
    return mix(b, -a, k) + width * k * (1.0 - k)


def sd_intersection(a, b):
    return torch.maximum(a, b)


def sd_smooth_intersection(a, b, width):
    k = torch.clamp(0.5 - _quotient(0.5 * (b - a), width), 0.0, 1.0)
    return mix(b, a, k) + width * k * (1.0 - k)


# --------------------------------------------------------------------------- #
# Compositing and utilities (shaderflow.glsl:343-367)

def blend(a, b):
    return mix(a, b, b[..., 3:4])


def alpha_composite(a, b):
    return a * (1.0 - b[..., 3:4]) + b * b[..., 3:4]


def saturate(color, amount):
    return torch.clamp(color * amount, 0.0, 1.0)


def zoom(uv, factor, anchor=None):
    """Zoom into an STUV coordinate (quadratic factor, as the GLSL)."""
    factor = _f32(factor, uv.device)
    if anchor is None:
        return uv * (factor * factor)
    anchor = _f32(anchor, uv.device)
    return (uv - anchor) * (factor * factor) + anchor


# --------------------------------------------------------------------------- #
# Math (shaderflow.glsl:370-400)

def atan_normalized(x):
    return scaled_quotient(torch.arctan(_f32(x)), 2.0, PI)


def atan1(point):
    return torch.arctan2(point[..., 1], point[..., 0])


def atan1n(point):
    return atan1(point) * reciprocal(PI)


def atan2(y, x=None):
    """The reference's custom (0, 2pi)-range atan2 (shaderflow.glsl:382-388)."""
    if x is None:
        y, x = y[..., 1], y[..., 0]
    device = _device(y, x)
    y, x = _f32(y, device), _f32(x, device)
    return torch.where(y < 0, TAU - torch.arctan2(-y, x), torch.arctan2(y, x))


def atan2n(y, x=None):
    return atan2(y, x) * reciprocal(TAU)


# --------------------------------------------------------------------------- #
# Colors (shaderflow.glsl:406-454)

def hsv2rgb(hsv):
    """HSV (h in radians 0..2pi) to RGB, matching the GLSL switch exactly.
    The constant divisions are the reference's compiled products: h / (pi /
    3) with the f32 reciprocal, 6 * (h / tau) with one folded constant."""
    hsv = _f32(hsv)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = torch.remainder(h, TAU)
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h * reciprocal(PI / 3.0), 2.0) - 1.0))
    m = v - c
    sector = torch.floor(scaled_quotient(h, 6.0, TAU)).to(torch.int32)
    zero = torch.zeros_like(c)

    def pick(options):
        out = zero
        for index in range(5, -1, -1):   # jnp.select: the first true condition wins
            out = torch.where(sector == index, options[index], out)
        return out

    r = pick([c, x, zero, zero, x, c])
    g = pick([x, c, c, x, zero, zero])
    b = pick([zero, zero, x, c, c, x])
    rgb = torch.stack([r, g, b], dim=-1) + m[..., None]
    if hsv.shape[-1] == 4:
        return torch.cat([rgb, hsv[..., 3:4]], dim=-1)
    return rgb


def hsv2rgb3(h, s, v):
    return hsv2rgb(vec3(h, s, v))


def rgb2hsv(rgb):
    rgb_in = _f32(rgb)
    r, g, b = rgb_in[..., 0], rgb_in[..., 1], rgb_in[..., 2]
    cmax = torch.maximum(r, torch.maximum(g, b))
    cmin = torch.minimum(r, torch.minimum(g, b))
    delta = cmax - cmin
    safe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(
        delta == 0, 0.0,
        torch.where(
            cmax == r, torch.remainder((g - b) / safe, 6.0),
            torch.where(cmax == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
        ),
    ) * (PI / 3.0)
    s = torch.where(cmax == 0, 0.0, delta / torch.where(cmax == 0, 1.0, cmax))
    hsv = torch.stack([h, s, cmax], dim=-1)
    if rgb_in.shape[-1] == 4:
        return torch.cat([hsv, rgb_in[..., 3:4]], dim=-1)
    return hsv


# --------------------------------------------------------------------------- #
# Noise (shaderflow.glsl:459-470)

_NOISE_DOT = (18.4835183, 59.583596)


def noise21(coords):
    coords = _f32(coords)
    return fract(torch.sin(dot(coords, _f32(_NOISE_DOT, coords.device))) * 39758.381532)


def noise22(coords):
    coords = _f32(coords)
    x = noise21(coords)
    return vec2(x, noise21(coords + x[..., None]))


def noise11(f):
    return fract(torch.sin(_f32(f)) * 39758.381532)
