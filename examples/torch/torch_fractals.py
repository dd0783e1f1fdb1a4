"""
Fractal scenes on the PyTorch port (shaderflow_tpu_torch).

Port of examples/fractals/fractals.py: Mandelbrot, the escape-time loop
bounded by the scene quality (a static uniform), magma palette; Julia,
the same loop from z0 = pixel with a c that orbits with time, hue-wheel
palette; and Tetration, z <- c^z for 67 steps in plain PyTorch, frozen at
the first escape, its hue tail in kernel K1. With the default (trivial) 2D camera Mandelbrot's escape counts
run on two coordinate lines (kernel K3's lines form, ops/fractal.py); a
rotated camera (MandelbrotRotated) and Julia run K3's planes form on
per-pixel planes. The palette, out-of-bounds mask, SSAA downsample and u8
quantize run in the fused tail (kernel K1, ops/tailfuse.py).

    python examples/torch/torch_fractals.py [Mandelbrot|MandelbrotRotated|Julia|Tetration]
                                              # 1080p60 2xSSAA, 2 s, to null
"""

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from shaderflow_tpu_torch import ops  # noqa: E402
from shaderflow_tpu_torch.ops import TAU, tailfuse  # noqa: E402
from shaderflow_tpu_torch.scene import ShaderScene  # noqa: E402


MAGMA = tuple(np.asarray(stop) for stop in (
    ops.PALETTE_MAGMA_1, ops.PALETTE_MAGMA_2,
    ops.PALETTE_MAGMA_3, ops.PALETTE_MAGMA_4))


def mandelbrot_cap(quality: int) -> int:
    """Visual iteration cap: the tail maps count i to palette(pow(1-i/q, 20))
    quantized to u8; past cap = q*(1 - (0.5/(255*slope))^(1/20)) ~ 0.284*q
    every count renders within half a u8 step of the q-count colour (only
    the A->B palette segment applies, slope 4*max|B-A| per unit t^20).
    Counts below the cap stay exact."""
    slope = 4.0 * float(max(abs(MAGMA[1] - MAGMA[0])))
    return math.ceil(quality * (1.0 - (0.5 / (255.0 * slope)) ** (1.0 / 20.0)))


def mandelbrot_tail(quality: int, trivial: bool):
    """The palette + out-of-bounds tail (plane dialect, ops/tailfuse.py)."""
    oob_color = MAGMA[0]     # palette_magma(0) == stop A exactly

    def tail(tp):
        t = 1.0 - tp.plane("iters") / quality
        # x^20 as a multiply chain (exact for t in [0, 1])
        t2 = t * t
        t4 = t2 * t2
        t16 = (t4 * t4) * (t4 * t4)
        t = t16 * t4
        oob = (tp.col("oob") if trivial else tp.plane("oob")) > 0.5
        out = []
        for channel in range(3):
            a, b, cc, d = (float(stop[channel]) for stop in MAGMA)
            # GLSL mix does NOT clamp: the selected branches extrapolate
            ab = a + (b - a) * (t * 4.0)
            bc = b + (cc - b) * ((t - 0.25) * 4.0)
            cd = cc + (d - cc) * ((t - 0.5) * 4.0)
            value = torch.where(t < 0.25, ab, torch.where(t < 0.5, bc, cd))
            out.append(torch.where(oob, float(oob_color[channel]), value))
        return out

    return tail


def mandelbrot_quality(sf) -> tuple[int, int]:
    """The frame's escape budget: (quality, mandelbrot_cap(quality))."""
    quality = max(1, int(1000.0 * sf.uniform("iQualityS")))
    return quality, mandelbrot_cap(quality)


def mandelbrot_lines(sf) -> tuple:
    """c = gluv - vec2(0.5, 0.0) under the trivial camera, as K3's two
    lines: (x line (W,), y line (H,))."""
    gluv_x, gluv_y = sf.camera.line("gluv")
    return gluv_x - 0.5, gluv_y


def mandelbrot_frag(sf):
    """Escape-time Mandelbrot with magma palette (mandelbrot.frag)."""
    from shaderflow_tpu_torch.ops import tailfuse
    from shaderflow_tpu_torch.ops.fractal import escape_iterations, escape_iterations_sep
    cam = sf.camera
    quality, cap = mandelbrot_quality(sf)
    # Trivial (axis-aligned) camera: c is an outer product of two lines,
    # and out-of-bounds is a column line. `iCameraTrivial` is a static.
    trivial = bool(sf.uniform("iCameraTrivial", default=False))
    if trivial:
        iters = escape_iterations_sep(*mandelbrot_lines(sf), quality,
                                      radius=3.0, saturate=cap,
                                      out_dtype=torch.float32)
        oob_in = tailfuse.Col(cam.out_of_bounds_x.to(torch.float32))
    else:
        # c = gluv - vec2(0.5, 0.0), built on the device (y - 0.0 == y)
        gluv = cam.gluv
        c = torch.stack([gluv[..., 0] - 0.5, gluv[..., 1]], dim=-1)
        iters = escape_iterations(c, quality, radius=3.0,
                                  saturate=cap, out_dtype=torch.float32)
        oob_in = cam.out_of_bounds.to(torch.float32)
    return sf.tail(mandelbrot_tail(quality, trivial), iters=iters, oob=oob_in)


class Mandelbrot(ShaderScene):
    """Mandelbrot fractal"""

    def build(self):
        self.shader.fragment = mandelbrot_frag


class MandelbrotRotated(Mandelbrot):
    """Mandelbrot under a camera rolled by `angle` degrees (camera.rotate2d),
    held from the first frame: c comes from the general per-pixel camera."""
    angle = 30.0

    def build(self):
        super().build()
        self.camera.rotate2d(self.angle)
        self.camera.rotation.set(self.camera.rotation.target)


def julia_cap(quality: int) -> int:
    """Visual iteration cap (see mandelbrot_cap): every channel is bounded
    by pow(1 - i/q, 8), so once 255 t^8 < 0.25 the capped and the true
    colours round alike. Counts below the cap stay exact."""
    return math.ceil(quality * (1.0 - (0.25 / 255.0) ** (1.0 / 8.0)))


def julia_tail(quality: int):
    """hsv2rgb of the count on a hue wheel (s = 0.8), black out of bounds.
    The reference divides by constants: tailfuse.divide computes each
    quotient as its compiled program does, in float32 and in bfloat16.
    (XLA computes 6 * (h / tau) as one product with a folded constant; at
    count 32 the two products here floor to sector 3 where it floors to 2,
    on the sectors' boundary, where both give the same color.)"""
    def tail(tp):
        it = tp.plane("iters")
        t = 1.0 - tailfuse.divide(it, quality)
        t2 = t * t
        t8 = (t2 * t2) * (t2 * t2)             # == power(t, 8), exact
        h = torch.remainder(TAU * (it * 0.015625), TAU)   # it / 64
        value = t8
        c = value * 0.8
        x = c * (1.0 - torch.abs(torch.remainder(tailfuse.divide(h, math.pi / 3.0), 2.0) - 1.0))
        m = value - c
        sector = torch.floor(6.0 * tailfuse.divide(h, TAU))
        zero = torch.zeros_like(c)

        def pick(options):
            out = zero
            for k, option in enumerate(options):
                out = torch.where(sector == float(k), option, out)
            return out

        oob = tp.plane("oob") > 0.5
        r = pick([c, x, zero, zero, x, c]) + m
        g = pick([x, c, c, x, zero, zero]) + m
        b = pick([zero, zero, x, c, c, x]) + m
        return (torch.where(oob, 0.0, r), torch.where(oob, 0.0, g),
                torch.where(oob, 0.0, b))

    return tail


def julia_c(sf):
    """The orbiting parameter c as two 0-d tensors on the device, from the
    frame's iTime (no host read-back)."""
    cx = -0.8 + 0.156 * torch.cos(sf.iTime * 0.31)
    cy = 0.156 + 0.08 * torch.sin(sf.iTime * 0.17)
    return cx, cy


def julia_frag(sf):
    """Julia set: the escape loop from z0 = pixel with c orbiting over time.
    The counts run in K3's planes form with c read on the device."""
    from shaderflow_tpu_torch.ops.fractal import escape_iterations_z0
    cam = sf.camera
    cx, cy = julia_c(sf)
    quality = max(1, int(1000.0 * sf.uniform("iQualityS")))
    # monotone: the orbiting c stays within |c| <= 0.96 << r^2 - r = 6
    iters = escape_iterations_z0(cam.gluv, cx, cy, quality, radius=3.0,
                                 saturate=julia_cap(quality), monotone=True,
                                 out_dtype=torch.float32)
    return sf.tail(julia_tail(quality), iters=iters,
                   oob=cam.out_of_bounds.to(torch.float32))


class Julia(ShaderScene):
    """Julia fractal with a time-orbiting parameter"""

    def build(self):
        self.shader.fragment = julia_frag


TETRATION_STEPS = 67


def tetration_escape(c: torch.Tensor) -> tuple:
    """The tetration orbit z <- cpow(c, z) from z = c for TETRATION_STEPS
    steps (tetration.frag), each pixel frozen at its first escaped value
    (GLSL breaks after the update, so the breaking z colors the pixel);
    escape is |z| > 100 or a non-finite |z| -> (zx, zy, k): k is 1 where
    the orbit never escaped, else 0 (tetration.frag:48 `it / MAX_STEPS` is
    integer division; the finite guard maps orbits that blow up to inf or
    NaN to k = 0, as the reference does).

    ops.complexmath.cpow on planes: its c-only terms (|c|, atan2(c), the
    log of |c|) are computed once, as the reference's compiled loop hoists
    them; every step then runs the same ops on the same values. Plain
    PyTorch, no host sync and no early exit."""
    from shaderflow_tpu_torch.ops import complexmath
    cx, cy = c[..., 0], c[..., 1]
    r = complexmath.cmag(c)
    t = torch.arctan2(cy, cx)
    log_r = torch.log(r)
    zx, zy = cx, cy
    escaped = torch.zeros(cx.shape, dtype=torch.bool, device=cx.device)
    for _ in range(TETRATION_STEPS):
        nr = torch.pow(r, zx) * torch.exp(-zy * t)
        nt = zy * log_r + zx * t
        active = ~escaped
        zx = torch.where(active, nr * torch.cos(nt), zx)
        zy = torch.where(active, nr * torch.sin(nt), zy)
        magnitude = torch.sqrt(zx * zx + zy * zy)
        escaped = escaped | (magnitude > 100.0) | ~torch.isfinite(magnitude)
    return zx, zy, (~escaped).to(torch.float32)


# h / (pi / 3) and 6 * (h / tau) for h = m / tau, folded as XLA folds them
TETRATION_THIRDS = ops.folded(ops.reciprocal(TAU), ops.reciprocal(math.pi / 3.0))
TETRATION_SECTOR = ops.folded(ops.reciprocal(TAU), ops.folded(6.0, ops.reciprocal(TAU)))


def tetration_tail(tp):
    """The hue of the escaped z on the wheel, value k (s = 1: c == v, m ==
    0). The hue is the reference's (0, 2pi)-range atan2 in cycles fed to
    the radians-domain hsv (the scene's existing look): tailfuse.atan2 has
    the standard (-pi, pi] range, and mod folds it to (0, 2pi).

    The constant products are the reference's compiled ones (its optimized
    program, XLA:CPU): with m the hue angle in [0, 2pi), h = m / tau, and
    XLA folds each chain of constant products into one f32 constant
    (stdlib.folded): h / (pi / 3) is m * (1/tau * 1/(pi/3)), and 6 * (h /
    tau) is m * (1/tau * (6 * 1/tau)). Written as two products each, the
    hue moves by an ulp on about a tenth of the pixels."""
    m = torch.remainder(tailfuse.atan2(tp.plane("zy"), tp.plane("zx")), TAU)
    value = tp.plane("k")
    x = value * (1.0 - torch.abs(torch.remainder(m * TETRATION_THIRDS, 2.0) - 1.0))
    sector = torch.floor(m * TETRATION_SECTOR)
    zero = torch.zeros_like(value)

    def pick(options):
        out = zero
        for index, option in enumerate(options):
            out = torch.where(sector == float(index), option, out)
        return out

    return (pick([value, x, zero, zero, x, value]),
            pick([x, value, value, x, zero, zero]),
            pick([zero, zero, x, value, value, x]))


def tetration_frag(sf):
    """Complex tetration fractal (tetration.frag): the orbit in plain
    PyTorch, the hue tail in kernel K1."""
    zx, zy, k = tetration_escape(sf.camera.gluv)
    return sf.tail(tetration_tail, k=k, zx=zx, zy=zy)


class Tetration(ShaderScene):
    """Complex tetration fractal"""

    def build(self):
        self.shader.fragment = tetration_frag


SCENES = [Mandelbrot, MandelbrotRotated, Julia, Tetration]

if __name__ == "__main__":
    scene = {cls.__name__: cls for cls in SCENES}[sys.argv[1] if len(sys.argv) > 1
                                                   else "Mandelbrot"]
    scene().main(width=1920, height=1080, fps=60, ssaa=2, time=2, output="null")
