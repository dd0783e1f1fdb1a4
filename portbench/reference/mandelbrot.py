"""
Plain reference of the `mandelbrot` configuration: the Mandelbrot scene of
upstream ShaderFlow's examples/fractals (mandelbrot.frag) under its
default trivial 2D camera, rendered in float32 PyTorch at the render size
and brought to the output size by the final pass, then stored as u8.

Independent of shaderflow_tpu_torch (it imports nothing of it and reads
nothing it made): the same formulas in the same order, so that it agrees
with a sound port to rounding:
  * c = gluv - (0.5, 0): screen lines ((i + 0.5) * f32(1 / n) * 2 - 1),
    x times the aspect; the trivial camera's plane hit is the identity
  * z0 = c, z <- z^2 + c until |z|^2 > 3^2, at most `quality` steps
    (1000 x quality / 100 / 1000 of the scene: 500), counts saturated at
    the visual cap; main cardioid and period-2 bulb take the full count
  * color = magma palette of (1 - n / quality)^20 (GLSL mix, unclamped)
  * final pass: render == output x 2 averages each 2 x 2 block; any
    other ratio (ssaa 4) averages the subsample^2 = 4 bilinear taps of
    final.glsl, as a separable resample of tap-averaged hat weights
  * u8 = floor(clamp(c, 0, 1) * 255 + 0.5)
The scene has no time dependence: upstream's default view, every frame of
a clip the same, so one frame serves every request (and a stale, repeated
or reordered frame cannot fail the comparison; PERF.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAGMA = tuple(np.asarray(stop, np.float32) for stop in (
    (0.01060815, 0.01808215, 0.10018654), (0.38092887, 0.12061482, 0.32506528),
    (0.79650140, 0.10506637, 0.31063031), (0.95922872, 0.53307513, 0.37488950)))
RADIUS = 3.0


def check(config: dict) -> None:
    """The configuration's env is the one source of the port's options:
    this reference renders the float32 tail."""
    if config.get("env", {}).get("SHADERFLOW_TAIL_BF16", "0") != "0":
        raise ValueError("the mandelbrot reference renders the float32 tail only")


def recip(n: float) -> float:
    return float(np.float32(1.0) / np.float32(n))


def quality_of(config: dict) -> tuple:
    """(escape budget, visual cap): every count past the cap renders within
    half a u8 step of the budget's colour."""
    quality = max(1, int(1000.0 * float(np.float32(config["quality"] / 100))))
    slope = 4.0 * float(max(abs(MAGMA[1] - MAGMA[0])))
    cap = math.ceil(quality * (1.0 - (0.5 / (255.0 * slope)) ** (1.0 / 20.0)))
    return quality, cap


def c_lines(width: int, height: int, aspect: float, device) -> tuple:
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) * recip(width)
    v = 1.0 - (torch.arange(height, dtype=torch.float32, device=device) + 0.5) * recip(height)
    gx = (u * 2.0 - 1.0) * aspect
    gy = v * 2.0 - 1.0
    return gx - 0.5, gy, gx


def escape_counts(cx_line, cy_line, quality: int, cap: int, rows: int = 512) -> tuple:
    """(counts (H, W) float32, useful steps): per pixel the steps until
    |z|^2 > r^2 (at most `cap`; interior points `quality`), in blocks of
    rows. Useful steps leave out the interior points, which need none."""
    r2 = RADIUS * RADIUS
    blocks, useful = [], 0
    for first in range(0, cy_line.shape[0], rows):
        cx, cy = torch.broadcast_tensors(cx_line[None, :], cy_line[first:first + rows, None])
        xq = cx - 0.25
        q = xq * xq + cy * cy
        interior = (q * (q + xq) <= 0.25 * (cy * cy)) | (
            (cx + 1.0) * (cx + 1.0) + cy * cy <= 0.0625)
        zx, zy = cx, cy
        iters = torch.zeros(cx.shape, dtype=torch.int32, device=cx.device)
        escaped = (zx * zx + zy * zy > r2) | interior
        for _ in range(min(quality, cap)):
            nx = zx * zx - zy * zy + cx
            ny = 2.0 * zx * zy + cy
            active = ~escaped
            zx = torch.where(active, nx, zx)
            zy = torch.where(active, ny, zy)
            escaped = escaped | (zx * zx + zy * zy > r2)
            iters = iters + active.to(torch.int32)
        useful += int(torch.where(interior, 0, iters).sum())
        blocks.append(torch.where(interior, quality, iters).to(torch.float32))
    return torch.cat(blocks), useful


def palette(iters: torch.Tensor, oob: torch.Tensor, quality: int) -> list:
    t = 1.0 - iters / quality
    t2 = t * t
    t4 = t2 * t2
    t16 = (t4 * t4) * (t4 * t4)
    t = t16 * t4
    out = []
    for channel in range(3):
        a, b, cc, d = (float(stop[channel]) for stop in MAGMA)
        ab = a + (b - a) * (t * 4.0)
        bc = b + (cc - b) * ((t - 0.25) * 4.0)
        cd = cc + (d - cc) * ((t - 0.5) * 4.0)
        value = torch.where(t < 0.25, ab, torch.where(t < 0.5, bc, cd))
        out.append(torch.where(oob, float(MAGMA[0][channel]), value))
    return out


def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(x.to(torch.float32), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _taps(out: int, render: int, subsample: int, device, up: bool) -> tuple:
    """Per output index along one axis: the texel indices (clamped) and the
    tap-averaged hat weights of final.glsl's subsample taps. Rows count v
    up the screen (up=True): a row's position is (1 - v) * H - 0.5."""
    centers = (torch.arange(out, dtype=torch.float32) + 0.5) / out
    if up:
        centers = 1.0 - centers
    pixel = 1.0 / out
    positions = []
    for k in range(subsample):
        offset = -pixel / 2.0 + (pixel / subsample) * (0.5 + k)
        position = ((1.0 - (centers + offset)) if up else (centers + offset)) * render - 0.5
        positions.append(torch.clamp(position, 0.0, float(render - 1)))
    base = torch.floor(torch.stack(positions).amin(0))
    span = int(math.ceil(render / out)) + 2
    texels = base[:, None] + torch.arange(span, dtype=torch.float32)[None, :]
    weights = sum(torch.clamp(1.0 - torch.abs(p[:, None] - texels), min=0.0)
                  for p in positions) / float(subsample)
    index = torch.clamp(texels, 0, render - 1).to(torch.int64)
    return index.to(device), weights.to(device)


def final_pass(rgb: list, out_h: int, out_w: int, subsample: int) -> torch.Tensor:
    """(Hr, Wr) planes -> (out_h, out_w, 3) u8."""
    render_h, render_w = rgb[0].shape
    if (render_h, render_w) == (out_h * subsample, out_w * subsample):
        pooled = [plane.reshape(out_h, subsample, out_w, subsample).sum(dim=(1, 3))
                  / float(subsample * subsample) for plane in rgb]
    else:
        rows_i, rows_w = _taps(out_h, render_h, subsample, rgb[0].device, up=True)
        cols_i, cols_w = _taps(out_w, render_w, subsample, rgb[0].device, up=False)
        pooled = []
        for plane in rgb:
            rows = sum(plane[rows_i[:, j]] * rows_w[:, j, None] for j in range(rows_i.shape[1]))
            pooled.append(sum(rows[:, cols_i[:, j]] * cols_w[None, :, j]
                              for j in range(cols_i.shape[1])))
    return quantize(torch.stack(pooled, dim=-1))


def frame(config: dict, traffic: dict, device, with_work: bool = False):
    """The (H, W, 3) u8 frame; with_work: also K3's useful steps, the
    counts and the out-of-bounds flags at the render size."""
    check(config)
    width, height = int(traffic["width"]), int(traffic["height"])
    ssaa = float(traffic["ssaa"])
    render_w, render_h = int(width * ssaa), int(height * ssaa)
    aspect = width / height
    quality, cap = quality_of(config)
    cx, cy, gx = c_lines(render_w, render_h, aspect, device)
    iters, useful = escape_counts(cx, cy, quality, cap)
    oob = (torch.abs(gx) > float(np.float32(aspect)))[None, :].expand(render_h, render_w)
    out = final_pass(palette(iters, oob, quality), height, width, int(config["subsample"]))
    return (out, useful, iters, oob) if with_work else out


def render(config: dict, traffic: dict, inputs: dict, requests: list, device) -> dict:
    """{(job, frame): (H, W, 3) u8 numpy} for requests [(job, clip, frame)]."""
    if not requests:
        return {}
    with torch.no_grad():
        image = frame(config, traffic, device).cpu().numpy()
    return {(job, index): image for job, _, index in requests}


def work(config: dict, traffic: dict, inputs: dict, device) -> dict:
    """What the roofline readers count for one frame: K3's useful escape
    steps, and the tail stage's operations and bytes (the counts plane
    read once as float32, the column of out-of-bounds flags, the u8 frame
    written once; the operations the palette formula needs, counted on
    every 16th row and column of the frame's own counts)."""
    from portbench.harness.counting import count_elementwise
    width, height = int(traffic["width"]), int(traffic["height"])
    ssaa = float(traffic["ssaa"])
    render_w, render_h = int(width * ssaa), int(height * ssaa)
    quality, _ = quality_of(config)
    with torch.no_grad():
        _, useful, iters, oob = frame(config, traffic, device, with_work=True)
        sample = iters[::16, ::16].cpu()
        _, ops = count_elementwise(palette, sample, oob[::16, ::16].cpu(), quality)
    pixels = render_w * render_h
    return {"escape_steps": useful,
            "tail_ops": ops / sample.numel() * pixels,
            "tail_bytes": pixels * 4 + render_w * 4 + width * height * 3}
