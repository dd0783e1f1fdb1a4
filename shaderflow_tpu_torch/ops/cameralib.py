"""
Camera ray generation — the device-side half of the camera system.

Port of shaderflow_tpu/ops/cameralib.py (the reference camera.glsl). Only
the trivial camera is ported: identity orientation, perspective projection,
where the ray/plane math is separable. The general `project` (rotated
cameras, stereoscopic and equirectangular projections) waits for the
RayMarch slice and raises.
"""

from __future__ import annotations

from functools import cached_property

import torch


def _grid(x_line, y_line, height: int, width: int) -> torch.Tensor:
    """(H, W, 2) grid of (x_line[j], y_line[i])."""
    x_line = torch.as_tensor(x_line)
    y_line = torch.as_tensor(y_line, device=x_line.device)
    return torch.stack(torch.broadcast_tensors(
        x_line.reshape(-1)[None, :].expand(height, width),
        y_line.reshape(-1)[:, None].expand(height, width)), dim=-1)


class CameraRays:
    """Per-pixel camera outputs, the fields of the GLSL Camera struct that
    shaders consume (camera.glsl:14-52), for the separable trivial camera.

    Eager PyTorch does not dead-code-eliminate unused (H, W, 2) fields the
    way XLA did, so every field is kept as an x line (W,) and a y line (H,)
    — `line(name)` — and materialized as a grid only on first access of the
    attribute of the same name (`gluv`, `astuv`, ...)."""

    def __init__(self, *, height: int, width: int, lines: dict,
                 out_of_bounds_x: torch.Tensor, position, forward, up, right):
        self.height = height
        self.width = width
        self._lines = lines              # name -> (x (W,), y (H,), z or None)
        self.out_of_bounds_x = out_of_bounds_x   # (W,) bool
        self.position = position
        self.forward = forward
        self.up = up
        self.right = right

    def line(self, name: str) -> tuple:
        """The separable form of a 2D field: (x line (W,), y line (H,))."""
        x, y, _ = self._lines[name]
        return x, y

    def _materialize(self, name: str) -> torch.Tensor:
        x, y, z = self._lines[name]
        grid = _grid(x, y, self.height, self.width)
        if z is None:
            return grid
        depth = torch.broadcast_to(torch.as_tensor(z, device=grid.device),
                                   (self.height, self.width))
        return torch.cat([grid, depth[..., None].to(grid.dtype)], dim=-1)

    @cached_property
    def origin(self): return self._materialize("origin")
    @cached_property
    def target(self): return self._materialize("target")
    @cached_property
    def gluv(self): return self._materialize("gluv")
    @cached_property
    def agluv(self): return self._materialize("agluv")
    @cached_property
    def stuv(self): return self._materialize("stuv")
    @cached_property
    def astuv(self): return self._materialize("astuv")
    @cached_property
    def stxy(self): return self._materialize("stxy")
    @cached_property
    def glxy(self): return self._materialize("glxy")

    @property
    def out_of_bounds(self) -> torch.Tensor:
        """(H, W) bool, a broadcast view of the column line."""
        return self.out_of_bounds_x[None, :].expand(self.height, self.width)


def project_trivial(
    *,
    gluv_x: torch.Tensor,   # (W,) aspect-corrected x line
    gluv_y: torch.Tensor,   # (H,) y line
    position,
    zoom,
    isometric,
    orbital,
    dolly,
    focal_length,
    aspect,
    want_aspect,
    resolution,
) -> CameraRays:
    """Separable path for the identity-orientation perspective camera
    (right=X, up=Y, forward=Z): camera.glsl's math specialized to the
    global basis. t = (1 - origin_z) / (focal + dolly) is a scalar, so the
    plane hit is an axis-aligned affine map of the screen. Scalars may be
    0-d tensors on the lines' device (per-frame uniforms) or floats."""
    height, width = gluv_y.shape[0], gluv_x.shape[0]
    device = gluv_x.device
    position = torch.as_tensor(position, dtype=torch.float32, device=device)
    resolution = torch.as_tensor(resolution, dtype=torch.float32, device=device)

    origin_z = position[2] - orbital - dolly
    direction_z = focal_length + dolly
    t = (1.0 - origin_z) / direction_z

    iso_size = zoom * isometric
    hit_x = position[0] + gluv_x * iso_size + t * (gluv_x * (zoom - iso_size))
    hit_y = position[1] + gluv_y * iso_size + t * (gluv_y * (zoom - iso_size))

    oob_x = (torch.abs(gluv_x) > want_aspect) | (t < 0)

    astuv_x = (hit_x / aspect + 1.0) / 2.0
    astuv_y = (hit_y + 1.0) / 2.0
    stxy_x = astuv_x * resolution[0]
    stxy_y = astuv_y * resolution[1]
    lines = {
        "gluv": (hit_x, hit_y, None),
        "agluv": (hit_x / aspect, hit_y, None),
        "stuv": ((hit_x + 1.0) / 2.0, (hit_y + 1.0) / 2.0, None),
        "astuv": (astuv_x, astuv_y, None),
        "stxy": (stxy_x, stxy_y, None),
        "glxy": (stxy_x - resolution[0] / 2.0, stxy_y - resolution[1] / 2.0, None),
        "origin": (position[0] + gluv_x * iso_size,
                   position[1] + gluv_y * iso_size, origin_z),
        "target": (position[0] + gluv_x * zoom, position[1] + gluv_y * zoom,
                   position[2] - orbital + focal_length),
    }
    basis = torch.eye(3, dtype=torch.float32, device=device)
    return CameraRays(height=height, width=width, lines=lines,
                      out_of_bounds_x=oob_x, position=position,
                      forward=basis[2], up=basis[1], right=basis[0])


def project(**kwargs) -> CameraRays:
    """The general per-pixel camera (any orientation and projection)."""
    raise NotImplementedError(
        "cameralib.project (rotated / stereoscopic / equirectangular "
        "cameras) is not ported yet; the trivial camera is (project_trivial)")
