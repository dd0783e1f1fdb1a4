"""
Escape-time fractal iteration counts.

Port of shaderflow_tpu/ops/fractal.py. Semantics follow the reference GLSL
loop (mandelbrot.frag): check |z| > radius, then z = z^2 + c, from z = c;
pixels inside the main cardioid / period-2 bulb report max_iter without
iterating; an optional `saturate` cap bounds the trip (counts below it are
exact).

  escape_plain           the plain PyTorch loop (_escape_xla, same math and
                         order) — what the kernel is held against
  escape_iterations_sep  the lines form: kernel K3 (csrc/escape.cu) on CUDA
                         tensors, escape_plain on CPU tensors
  escape_iterations      the plane form: plain on CPU; its kernel (K3 plane
                         form, Julia/Tetration/rotated cameras) is not
                         ported yet and CUDA tensors raise

Not ported (TPU workarounds, ROADMAP "Not ported"): predicted rounds, the
unroll between early-exit checks, f32 mask carries, the maskless monotone
step — one thread per pixel exits on its own escape.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch


def _interior_mask(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Main-cardioid + period-2-bulb membership (exact: such points never
    escape). Valid only for z0 == c (Mandelbrot)."""
    xq = cx - 0.25
    q = xq * xq + cy * cy
    cardioid = q * (q + xq) <= 0.25 * (cy * cy)
    bulb = (cx + 1.0) * (cx + 1.0) + cy * cy <= 0.0625
    return cardioid | bulb


def escape_plain(zx0: torch.Tensor, zy0: torch.Tensor, cx: torch.Tensor,
                 cy: torch.Tensor, max_iter: int, radius: float,
                 interior: torch.Tensor = None, saturate: int = None,
                 out_dtype=torch.int32) -> torch.Tensor:
    """The reference's masked loop (_escape_xla): `trip` steps over the
    whole field, each pixel frozen once |z|^2 > radius^2."""
    r2 = radius * radius
    trip = max_iter if saturate is None else min(max_iter, saturate)
    zx, zy = zx0, zy0
    iters = torch.zeros(zx0.shape, dtype=torch.int32, device=zx0.device)
    escaped = zx0 * zx0 + zy0 * zy0 > r2
    if interior is not None:
        escaped = escaped | interior
    for _ in range(trip):
        nx = zx * zx - zy * zy + cx
        ny = 2.0 * zx * zy + cy
        active = ~escaped
        zx = torch.where(active, nx, zx)
        zy = torch.where(active, ny, zy)
        escaped = escaped | (zx * zx + zy * zy > r2)
        iters = iters + active.to(torch.int32)
    if interior is not None:
        iters = torch.where(interior, max_iter, iters)
    return iters.to(out_dtype)


def escape_lines_plain(cx_line: torch.Tensor, cy_line: torch.Tensor,
                       max_iter: int, radius: float = 3.0,
                       saturate: int = None, out_dtype=torch.int32) -> torch.Tensor:
    """Plain version of kernel K3: escape_plain on the outer-product grid
    c[i, j] = (cx_line[j], cy_line[i]) with the interior shortcut."""
    cx, cy = torch.broadcast_tensors(cx_line[None, :], cy_line[:, None])
    return escape_plain(cx, cy, cx, cy, int(max_iter), float(radius),
                        interior=_interior_mask(cx, cy), saturate=saturate,
                        out_dtype=out_dtype)


def _escape_library() -> ctypes.CDLL:
    from shaderflow_tpu_torch.build import cuda_library
    library = cuda_library(Path(__file__).parent.parent / "csrc" / "escape.cu")
    function = library.escape_lines
    if function.argtypes is None:
        function.restype = ctypes.c_int
        function.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
    return library


def escape_iterations_sep(cx_line: torch.Tensor, cy_line: torch.Tensor,
                          max_iter: int, radius: float = 3.0,
                          saturate: int = None,
                          out_dtype=torch.int32) -> torch.Tensor:
    """Mandelbrot escape counts for the separable (trivial 2D camera) case:
    c[i, j] = (cx_line[j], cy_line[i]) -> (H, W) counts of `out_dtype`
    (int32 or float32; counts are exact in f32, max_iter << 2^24).

    Kernel K3 (csrc/escape.cu) for CUDA tensors — built at first use,
    launched on the current stream; escape_lines_plain for CPU tensors.
    `escape_iterations_sep.launches` counts kernel launches."""
    if cx_line.ndim != 1 or cy_line.ndim != 1:
        raise ValueError(f"lines must be 1-D, got {tuple(cx_line.shape)} "
                         f"and {tuple(cy_line.shape)}")
    if out_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if cx_line.device != cy_line.device:
        raise ValueError(f"lines on different devices: {cx_line.device}, {cy_line.device}")
    if cx_line.device.type == "cpu":
        return escape_lines_plain(cx_line.to(torch.float32),
                                  cy_line.to(torch.float32), max_iter,
                                  radius, saturate, out_dtype)
    if cx_line.device.type != "cuda":
        raise ValueError(f"Unsupported device {cx_line.device}")
    for line in (cx_line, cy_line):
        if line.dtype != torch.float32 or not line.is_contiguous():
            raise ValueError("K3 takes contiguous float32 lines, got "
                             f"{line.dtype} contiguous={line.is_contiguous()}")
    height, width = cy_line.shape[0], cx_line.shape[0]
    trip = int(max_iter) if saturate is None else min(int(max_iter), int(saturate))
    out = torch.empty((height, width), dtype=out_dtype, device=cx_line.device)
    library = _escape_library()
    with torch.cuda.device(cx_line.device):   # the launch targets the current card
        status = library.escape_lines(
            cx_line.data_ptr(), cy_line.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), height, width, int(max_iter), trip,
            float(radius) * float(radius),
            torch.cuda.current_stream(cx_line.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"escape_lines launch failed: cudaError {status}")
    escape_iterations_sep.launches += 1
    return out


escape_iterations_sep.launches = 0


def escape_iterations(c: torch.Tensor, max_iter: int, radius: float = 3.0,
                      saturate: int = None, out_dtype=torch.int32) -> torch.Tensor:
    """Mandelbrot escape counts for per-pixel c = (..., 2) (the plane form:
    rotated or non-perspective cameras). Plain on CPU tensors; the plane
    form of kernel K3 is not ported yet, so CUDA tensors raise."""
    if c.device.type != "cpu":
        raise NotImplementedError(
            "escape_iterations plane form: kernel K3's plane form "
            "(shaderflow_tpu/ops/fractal.py:_escape_pallas, planes) is not "
            "ported yet; the trivial camera's lines form is "
            "(escape_iterations_sep)")
    cx, cy = c[..., 0], c[..., 1]
    return escape_plain(cx, cy, cx, cy, int(max_iter), float(radius),
                        interior=_interior_mask(cx, cy), saturate=saturate,
                        out_dtype=out_dtype)
