"""
Escape-time fractal iteration counts.

Port of shaderflow_tpu/ops/fractal.py. Semantics follow the reference GLSL
loop (mandelbrot.frag): check |z| > radius, then z = z^2 + c, from z = c;
pixels inside the main cardioid / period-2 bulb report max_iter without
iterating; an optional `saturate` cap bounds the trip (counts below it are
exact).

  escape_plain           the plain PyTorch loop (_escape_xla, same math and
                         order) — what the kernel is held against
  escape_iterations_sep  the lines form: kernel K3 (csrc/escape.cu,
                         escape_lines) on CUDA tensors, escape_plain on CPU
  escape_iterations      the plane form, z0 == c (rotated cameras): K3's
                         planes form (escape_planes, interior computed
                         in-kernel from c) on CUDA, escape_plain on CPU
  escape_iterations_z0   the plane form with c given apart (Julia): planes or
                         0-d values read on the device through a pointer

K3's design (csrc/escape.cu's note): one thread a pixel, a warp on an 8 x 4
tile of pixels, and an escape loop that keeps no count: it branches out
every few steps and works out the first escaping step from where it left
the unrolled loop. Not ported (TPU workarounds, ROADMAP "Not ported"):
predicted rounds, f32 mask carries, the maskless monotone step.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from shaderflow_tpu_torch.tools import flopcount

ESCAPE_STEP_OPS = 9   # one escape step in csrc/escape.cu: 4 products, 4 sums, 1 compare


def _escape_cost(pixels: int, operand_bytes: float) -> flopcount.Cost:
    """One pixel's share of a K3 launch for the cost walker: its operands
    read once and its count written once; the escape loop reported per
    trip (ESCAPE_STEP_OPS), which the caller closes with the measured
    counts."""
    return flopcount.Cost(kernel_bytes=4 + operand_bytes / pixels,
                          unknown_loops=[("K3 escape step", ESCAPE_STEP_OPS, 1.0)])


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
    function = library.escape_planes
    if function.argtypes is None:
        function.restype = ctypes.c_int
        function.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
    return library


def escape_iterations_sep(cx_line: torch.Tensor, cy_line: torch.Tensor,
                          max_iter: int, radius: float = 3.0,
                          saturate: int = None,
                          out_dtype=torch.int32) -> torch.Tensor:
    """Mandelbrot escape counts for the separable (trivial 2D camera) case:
    c[i, j] = (cx_line[j], cy_line[i]) -> (H, W) counts of `out_dtype`
    (int32 or float32; counts are exact in f32, max_iter << 2^24).

    Kernel K3 (csrc/escape.cu) for CUDA tensors — built at first use,
    launched on the current stream; escape_lines_plain for CPU tensors,
    declared to the cost walker as the kernel's launch.
    `escape_iterations_sep.launches` counts kernel launches: a call
    captured into a CUDA graph launches nothing (fraggraph.py)."""
    if cx_line.ndim != 1 or cy_line.ndim != 1:
        raise ValueError(f"lines must be 1-D, got {tuple(cx_line.shape)} "
                         f"and {tuple(cy_line.shape)}")
    if out_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if cx_line.device != cy_line.device:
        raise ValueError(f"lines on different devices: {cx_line.device}, {cy_line.device}")
    height, width = cy_line.shape[0], cx_line.shape[0]
    cost = lambda: _escape_cost(height * width, 4 * (height + width))
    if cx_line.device.type == "cpu":
        with flopcount.kernel("K3 lines", height * width, cost):
            return escape_lines_plain(cx_line.to(torch.float32),
                                      cy_line.to(torch.float32), max_iter,
                                      radius, saturate, out_dtype)
    if cx_line.device.type != "cuda":
        raise ValueError(f"Unsupported device {cx_line.device}")
    for line in (cx_line, cy_line):
        if line.dtype != torch.float32 or not line.is_contiguous():
            raise ValueError("K3 takes contiguous float32 lines, got "
                             f"{line.dtype} contiguous={line.is_contiguous()}")
    trip = int(max_iter) if saturate is None else min(int(max_iter), int(saturate))
    out = torch.empty((height, width), dtype=out_dtype, device=cx_line.device)
    library = _escape_library()
    with flopcount.kernel("K3 lines", height * width, cost), torch.cuda.device(cx_line.device):
        status = library.escape_lines(
            cx_line.data_ptr(), cy_line.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), height, width, int(max_iter), trip,
            float(radius) * float(radius),
            torch.cuda.current_stream(cx_line.device).cuda_stream)
        captured = torch.cuda.is_current_stream_capturing()
    if status != 0:
        raise RuntimeError(f"escape_lines launch failed: cudaError {status}")
    if not captured:
        escape_iterations_sep.launches += 1
    return out


escape_iterations_sep.launches = 0


# escape_planes' c and interior kinds (csrc/escape.cu)
_C_IS_Z0, _C_PLANES, _C_SCALARS = 0, 1, 2
_INTERIOR_NONE, _INTERIOR_FROM_C, _INTERIOR_PLANE = 0, 1, 2


def _strided_plane(plane: torch.Tensor, shape: tuple) -> tuple:
    """(base tensor, element stride) of a plane whose k-th pixel (row-major)
    sits at base[k * stride]: a contiguous plane, or one channel of a
    contiguous (..., 2) vector field. Anything else is made contiguous."""
    plane = torch.broadcast_to(plane, shape)
    stride = plane.stride(-1) if plane.ndim else 1
    expected = [stride]
    for size in reversed(plane.shape[1:]):
        expected.insert(0, expected[0] * size)
    if plane.ndim and list(plane.stride()) == expected and stride in (1, 2):
        return plane, stride
    return plane.contiguous(), 1


def _escape_planes_cuda(zx0: torch.Tensor, zy0: torch.Tensor, cx, cy, c_kind: int,
                        interior: torch.Tensor, interior_kind: int, max_iter: int,
                        radius: float, saturate, out_dtype) -> torch.Tensor:
    """Launch K3's planes form (csrc/escape.cu:escape_planes) on the
    current stream -> counts of zx0's shape."""
    shape = tuple(zx0.shape)
    device = zx0.device
    zx0, z_stride = _strided_plane(zx0, shape)
    zy0, zy_stride = _strided_plane(zy0, shape)
    if zy_stride != z_stride:
        zx0, zy0, z_stride = zx0.contiguous(), zy0.contiguous(), 1
    c_stride = 1
    if c_kind == _C_PLANES:
        cx, c_stride = _strided_plane(cx, shape)
        cy, cy_stride = _strided_plane(cy, shape)
        if cy_stride != c_stride:
            cx, cy, c_stride = cx.contiguous(), cy.contiguous(), 1
    tensors = [zx0, zy0] + ([cx, cy] if c_kind != _C_IS_Z0 else [])
    if interior_kind == _INTERIOR_PLANE:
        interior = torch.broadcast_to(interior, shape).to(torch.bool).contiguous()
        tensors.append(interior)
    for tensor in tensors:
        if tensor.device != device or (tensor.dtype != torch.float32
                                       and tensor is not interior):
            raise ValueError(f"K3 takes float32 planes on {device}, got "
                             f"{tensor.dtype} on {tensor.device}")
    trip = int(max_iter) if saturate is None else min(int(max_iter), int(saturate))
    out = torch.empty(shape, dtype=out_dtype, device=device)
    library = _escape_library()
    pointer = lambda t: t.data_ptr() if isinstance(t, torch.Tensor) else None
    operand_bytes = sum(t.numel() * t.element_size() for t in tensors)
    cost = lambda: _escape_cost(out.numel(), operand_bytes)
    with flopcount.kernel("K3 planes", out.numel(), cost), torch.cuda.device(device):
        status = library.escape_planes(
            zx0.data_ptr(), zy0.data_ptr(), z_stride,
            pointer(cx) if c_kind != _C_IS_Z0 else None,
            pointer(cy) if c_kind != _C_IS_Z0 else None, c_stride, c_kind,
            interior.data_ptr() if interior_kind == _INTERIOR_PLANE else None,
            interior_kind, out.data_ptr(), int(out_dtype == torch.float32),
            out.numel(), shape[-1] if shape else 1, int(max_iter), trip,
            float(radius) * float(radius),
            torch.cuda.current_stream(device).cuda_stream)
        captured = torch.cuda.is_current_stream_capturing()
    if status != 0:
        raise RuntimeError(f"escape_planes launch failed: cudaError {status}")
    if not captured:
        escape_iterations.launches += 1
    return out


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")


def escape_iterations(c: torch.Tensor, max_iter: int, radius: float = 3.0,
                      saturate: int = None, out_dtype=torch.int32) -> torch.Tensor:
    """Mandelbrot escape counts for per-pixel c = (..., 2) (the plane form:
    rotated or non-perspective cameras), z0 = c, interior pixels reported
    as max_iter. K3's planes form on CUDA tensors (c read in place from a
    contiguous (..., 2) field, the interior test computed in-kernel);
    escape_plain on CPU tensors, declared to the cost walker as the
    kernel's launch. `escape_iterations.launches` counts the
    launches of the planes form (escape_iterations_z0's too): a call
    captured into a CUDA graph launches nothing (fraggraph.py)."""
    _check_out_dtype(out_dtype)
    cx, cy = c[..., 0], c[..., 1]
    if c.device.type == "cpu":
        pixels = cx.numel()
        with flopcount.kernel("K3 planes", pixels, lambda: _escape_cost(pixels, 8 * pixels)):
            return escape_plain(cx, cy, cx, cy, int(max_iter), float(radius),
                                interior=_interior_mask(cx, cy), saturate=saturate,
                                out_dtype=out_dtype)
    if c.device.type != "cuda" or c.dtype != torch.float32:
        raise ValueError(f"K3 takes float32 CUDA tensors, got {c.dtype} on {c.device}")
    c = c.contiguous()
    return _escape_planes_cuda(c[..., 0], c[..., 1], None, None, _C_IS_Z0, None,
                               _INTERIOR_FROM_C, max_iter, radius, saturate, out_dtype)


escape_iterations.launches = 0


def escape_iterations_z0(z0: torch.Tensor, cx, cy, max_iter: int, radius: float = 3.0,
                         interior: torch.Tensor = None, saturate: int = None,
                         monotone: bool = False, out_dtype=torch.int32) -> torch.Tensor:
    """General escape counts: per-pixel z0 (..., 2), c per pixel or as
    scalars (the Julia form; no interior shortcut unless `interior` is
    given, as it is sound only when z0 == c). `monotone` is the
    reference's licence for a maskless TPU step; the counts do not depend
    on it and the port ignores it.

    On CUDA, K3's planes form: a 0-d (or one-element) tensor c is read on
    the device through a pointer (no host sync), Python numbers become
    0-d tensors, anything else is broadcast to z0's planes. escape_plain
    on CPU tensors, declared to the cost walker as the kernel's launch."""
    del monotone
    _check_out_dtype(out_dtype)
    zx0, zy0 = z0[..., 0], z0[..., 1]
    if z0.device.type == "cpu":
        cx = torch.as_tensor(cx, dtype=torch.float32)
        cy = torch.as_tensor(cy, dtype=torch.float32)
        pixels = zx0.numel()
        # the bytes the card reads: z0's planes, c's planes (or two values),
        # the interior plane
        operand_bytes = (8 * pixels + (8 if cx.numel() == cy.numel() == 1 else 8 * pixels)
                         + (pixels if interior is not None else 0))
        with flopcount.kernel("K3 planes", pixels,
                              lambda: _escape_cost(pixels, operand_bytes)):
            return escape_plain(zx0, zy0, cx, cy, int(max_iter), float(radius),
                                interior=interior, saturate=saturate, out_dtype=out_dtype)
    if z0.device.type != "cuda" or z0.dtype != torch.float32:
        raise ValueError(f"K3 takes float32 CUDA tensors, got {z0.dtype} on {z0.device}")
    cx = torch.as_tensor(cx, dtype=torch.float32, device=z0.device)
    cy = torch.as_tensor(cy, dtype=torch.float32, device=z0.device)
    scalars = cx.numel() == 1 and cy.numel() == 1
    c_kind = _C_SCALARS if scalars else _C_PLANES
    if scalars:
        cx, cy = cx.reshape(()).contiguous(), cy.reshape(()).contiguous()
    return _escape_planes_cuda(zx0, zy0, cx, cy, c_kind, interior,
                               _INTERIOR_NONE if interior is None else _INTERIOR_PLANE,
                               max_iter, radius, saturate, out_dtype)
