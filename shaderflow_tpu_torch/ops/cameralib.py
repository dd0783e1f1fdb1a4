"""
Camera ray generation — the device-side half of the camera system.

Port of shaderflow_tpu/ops/cameralib.py (the reference camera.glsl): the
trivial camera (identity orientation, perspective projection, where the
ray/plane math is separable into axis lines) and the general per-pixel
`project` (any orientation; perspective, stereoscopic and equirectangular
projections) with the CameraRay2D plane hit. The general form computes
in the reference's expression order, so its fields equal the reference's
on the same inputs wherever the math is elementwise products and sums.
"""

from __future__ import annotations

from functools import cached_property

import torch

from shaderflow_tpu_torch.ops import stdlib as sl

# Enum values match camera.glsl:4-12 and camera.py
MODE_FREE = 0
MODE_2D = 1
MODE_SPHERICAL = 2

PROJECTION_PERSPECTIVE = 0
PROJECTION_STEREOSCOPIC = 1
PROJECTION_EQUIRECTANGULAR = 2


def grid(x_line, y_line, height: int, width: int) -> torch.Tensor:
    """(H, W, 2) grid of (x_line[j], y_line[i]): how a field of the trivial
    camera is materialized from its axis lines."""
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
        plane = grid(x, y, self.height, self.width)
        if z is None:
            return plane
        depth = torch.broadcast_to(torch.as_tensor(z, device=plane.device),
                                   (self.height, self.width))
        return torch.cat([plane, depth[..., None].to(plane.dtype)], dim=-1)

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

    @property
    def ray_direction(self) -> torch.Tensor:
        """(H, W, 3) unit vectors from origin to target."""
        return sl.normalize(self.target - self.origin)


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


class PlaneCameraRays:
    """The fields of the GLSL Camera struct for the general camera: the
    per-pixel ray origin and target (H, W, 3) and the plane hit (H, W, 2),
    from which the coordinate flavors are derived on first access."""

    def __init__(self, *, origin, target, hit, t, gluv_x, aspect, want_aspect,
                 resolution, position, forward, up, right):
        self.origin = origin
        self.target = target
        self.gluv = hit
        self._t = t
        self._gluv_x = gluv_x
        self._aspect = aspect
        self._want_aspect = want_aspect
        self._resolution = resolution
        self.position = position
        self.forward = forward
        self.up = up
        self.right = right

    @property
    def ray_direction(self) -> torch.Tensor:
        """(H, W, 3) unit vectors from origin to target."""
        return sl.normalize(self.target - self.origin)

    @cached_property
    def out_of_bounds(self) -> torch.Tensor:
        """(H, W) bool: behind the camera or outside the wanted aspect."""
        return (self._t < 0) | (torch.abs(self._gluv_x) > self._want_aspect)

    @cached_property
    def agluv(self):
        return self.gluv / sl.vec2(self._aspect, 1.0)

    @cached_property
    def stuv(self):
        return (self.gluv + 1.0) / 2.0

    @cached_property
    def astuv(self):
        return (self.agluv + 1.0) / 2.0

    @cached_property
    def stxy(self):
        return self._resolution * self.astuv

    @cached_property
    def glxy(self):
        return self.stxy - self._resolution / 2.0


def _rectangle(gluv: torch.Tensor, right, up, size) -> torch.Tensor:
    """Projection plane offsets (CameraRectangle, camera.glsl:55-57)."""
    return size * (gluv[..., 0:1] * right + gluv[..., 1:2] * up)


def project(
    *,
    gluv: torch.Tensor,    # (H, W, 2) screen gluv
    agluv: torch.Tensor,   # (H, W, 2)
    mode: int,
    projection: int,
    position,
    right,
    up,
    forward,
    zoom,
    isometric,
    orbital,
    dolly,
    focal_length,
    separation,
    aspect,
    want_aspect,
    resolution,
) -> PlaneCameraRays:
    """Per-pixel rays and the 2D uv set (CameraProject + CameraRay2D).
    mode/projection are static Python ints (they select the path, as the
    GLSL if-chain resolves uniformly per draw); everything else may be a
    per-frame 0-d / (3,) tensor on the grids' device.

    The plane hit intersects z = 1 (point (0, 0, 1), normal (0, 0, 1)):
    the reference's two dot products with that normal are the z
    components, 1 - origin.z and target.z - origin.z, for finite rays."""
    del mode  # affects only host-side interaction, not ray math
    device = gluv.device

    def vector(value):
        return torch.as_tensor(value, dtype=torch.float32, device=device)

    position, right, up, forward = (vector(v) for v in (position, right, up, forward))
    resolution = vector(resolution)
    backward = -forward

    def ray_origin(pos, g):
        return (pos
                + _rectangle(g, right, up, zoom * isometric)
                + backward * orbital
                + backward * dolly)

    def ray_target(pos, g):
        return (pos
                + _rectangle(g, right, up, zoom)
                + backward * orbital
                + forward * focal_length)

    if projection == PROJECTION_PERSPECTIVE:
        origin = ray_origin(position, gluv)
        target = ray_target(position, gluv)
    elif projection == PROJECTION_STEREOSCOPIC:
        # Each half of the screen gets its own centered gluv (camera.glsl:101-109)
        eye = torch.sign(agluv[..., 0:1])
        g = gluv - eye * sl.vec2(aspect / 2.0, 0.0)
        pos = position + eye * separation * right
        origin = ray_origin(pos, g)
        target = ray_target(pos, g)
    elif projection == PROJECTION_EQUIRECTANGULAR:
        # The screen rectangle as azimuth/inclination (camera.glsl:112-125)
        inclination = zoom * (float(sl.PI) * agluv[..., 1] / 2.0)
        azimuth = zoom * (float(sl.PI) * agluv[..., 0])
        direction = sl.rotate3d(forward, right, -inclination)
        direction = sl.rotate3d(direction, up, azimuth)
        origin = torch.broadcast_to(position, gluv.shape[:-1] + (3,))
        target = origin + direction
    else:
        raise ValueError(f"Unknown camera projection: {projection}")

    num = 1.0 - origin[..., 2]
    den = target[..., 2] - origin[..., 2]
    t = num / den
    hit = origin[..., 0:2] + t[..., None] * (target[..., 0:2] - origin[..., 0:2])
    return PlaneCameraRays(origin=origin, target=target, hit=hit, t=t,
                           gluv_x=gluv[..., 0], aspect=aspect,
                           want_aspect=want_aspect, resolution=resolution,
                           position=position, forward=forward, up=up, right=right)
