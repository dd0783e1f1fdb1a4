"""
Fractal scenes on the PyTorch port (shaderflow_tpu_torch).

Port of examples/fractals/fractals.py: Mandelbrot, the escape-time loop
bounded by the scene quality (a static uniform), magma palette. With the
default (trivial) 2D camera the escape counts run on two coordinate lines
(kernel K3, ops/fractal.py) and the palette, out-of-bounds mask, SSAA
downsample and u8 quantize run in the fused tail (kernel K1,
ops/tailfuse.py).

    python examples/torch/torch_fractals.py            # 1080p60 2xSSAA, 2 s, to null
"""

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from shaderflow_tpu_torch import ops  # noqa: E402
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


def mandelbrot_frag(sf):
    """Escape-time Mandelbrot with magma palette (mandelbrot.frag)."""
    from shaderflow_tpu_torch.ops import tailfuse
    from shaderflow_tpu_torch.ops.fractal import escape_iterations, escape_iterations_sep
    cam = sf.camera
    quality = max(1, int(1000.0 * sf.uniform("iQualityS")))
    cap = mandelbrot_cap(quality)
    # Trivial (axis-aligned) camera: c is an outer product of two lines,
    # and out-of-bounds is a column line. `iCameraTrivial` is a static.
    trivial = bool(sf.uniform("iCameraTrivial", default=False))
    if trivial:
        gluv_x, gluv_y = cam.line("gluv")
        iters = escape_iterations_sep(gluv_x - 0.5, gluv_y, quality,
                                      radius=3.0, saturate=cap,
                                      out_dtype=torch.float32)
        oob_in = tailfuse.Col(cam.out_of_bounds_x.to(torch.float32))
    else:
        shift = torch.tensor([0.5, 0.0], dtype=torch.float32, device=sf.device)
        iters = escape_iterations(cam.gluv - shift, quality, radius=3.0,
                                  saturate=cap, out_dtype=torch.float32)
        oob_in = cam.out_of_bounds.to(torch.float32)
    return sf.tail(mandelbrot_tail(quality, trivial), iters=iters, oob=oob_in)


class Mandelbrot(ShaderScene):
    """Mandelbrot fractal"""

    def build(self):
        self.shader.fragment = mandelbrot_frag


SCENES = [Mandelbrot]

if __name__ == "__main__":
    Mandelbrot().main(width=1920, height=1080, fps=60, ssaa=2, time=2,
                      output="null")
