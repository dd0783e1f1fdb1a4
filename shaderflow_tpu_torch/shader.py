"""
ShaderProgram — pixel programs as Python functions on torch tensors.

Port of shaderflow_tpu/shader.py. A fragment is `main(sf) -> rgba | TailSpec`
operating on whole planes through the `Frag` context (coordinate flavors,
uniforms by name, textures, batch preludes, the camera). The engine runs
it once per frame and layer in eager PyTorch. Ported: Frag (uniforms,
statics, coordinates, `tex` samplers of external textures, device
sequences and program textures (any temporal slot and layer), the GL
sampler and its coordinate-space accessors, `texel_fetch`, `discard`,
`prelude` / `prelude_indexed`, `tail`, the trivial and the general
camera), make_coords / finish_coords, the built-in default (welcome) and
missing-texture programs, and ShaderProgram with function fragments and
instancing. Not yet: mipmaps, the GLSL front-end, hot reload, and the
missing-texture fallback for a program that fails to build (there is no
front-end to fail: a failing fragment raises).
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Callable, Optional

import torch

from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.ops import cameralib, sampling
from shaderflow_tpu_torch.ops import stdlib as sl
from shaderflow_tpu_torch.ops.stdlib import reciprocal
from shaderflow_tpu_torch.ops.sampling import Sampler2D, texel_fetch
from shaderflow_tpu_torch.texture import ShaderTexture

PixelFunction = Callable[["Frag"], Any]


# --------------------------------------------------------------------------- #
# Coordinates

class Coords(Mapping):
    """Pixel-center coordinate flavors over one render resolution (the
    interpolated vertex outputs, vertex/default.glsl:8-16; row 0 = top).

    XLA hoisted and dead-code-eliminated the reference's full (H, W, 2)
    grids; eager PyTorch would rebuild them every frame. Here the two axis
    lines are the data, and each grid flavor is built on first access and
    cached for the life of the engine build (one render size). stxy/glxy
    depend on the per-frame iResolution uniform: finish_coords returns a
    view that builds them lazily per frame."""

    _GRIDS = ("astuv", "agluv", "stuv", "gluv")
    _FRAME = ("stxy", "glxy")

    def __init__(self, height: int, width: int, aspect: float, device: torch.device):
        self.height = height
        self.width = width
        self.aspect = aspect
        self.device = torch.device(device)
        # (i + 0.5) * (1 / n), not (i + 0.5) / n: the reference engine's
        # lines as XLA computes them (its algebraic simplifier folds a
        # division by a constant into a product with the reciprocal). The
        # two differ by an ulp on about a third of the pixels, and escape
        # counts of chaotic boundary pixels amplify an ulp of c.
        self.u_line = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) * reciprocal(width)
        self.v_line = 1.0 - (torch.arange(height, dtype=torch.float32, device=device) + 0.5) * reciprocal(height)
        self.resolution = None   # per-frame iResolution, set by finish_coords
        self._grids: dict[str, torch.Tensor] = {}
        self._frame: dict[str, torch.Tensor] = {}

    def _keys(self) -> tuple:
        return (*self._GRIDS, "u_line", "v_line", "aspect",
                *(self._FRAME if self.resolution is not None else ()))

    def __iter__(self):
        return iter(self._keys())

    def __len__(self) -> int:
        return len(self._keys())

    def __contains__(self, key) -> bool:
        return key in self._keys()

    def __getitem__(self, key: str):
        if key == "u_line":
            return self.u_line
        if key == "v_line":
            return self.v_line
        if key == "aspect":
            return self.aspect
        if key in self._GRIDS:
            if key not in self._grids:
                self._grids[key] = self._build(key)
            return self._grids[key]
        if key in self._FRAME and self.resolution is not None:
            if key not in self._frame:
                resolution = torch.as_tensor(self.resolution, dtype=torch.float32,
                                             device=self.device)
                stxy = resolution * self["astuv"] + 1.0
                self._frame["stxy"] = stxy
                self._frame["glxy"] = stxy - resolution / 2.0
            return self._frame[key]
        raise KeyError(key)

    def _build(self, key: str) -> torch.Tensor:
        if key == "astuv":
            return torch.stack(torch.broadcast_tensors(
                self.u_line[None, :], self.v_line[:, None]), dim=-1)
        if key == "agluv":
            return self["astuv"] * 2.0 - 1.0
        if key == "gluv":
            scale = torch.tensor([self.aspect, 1.0], dtype=torch.float32,
                                 device=self.device)
            return self["agluv"] * scale
        return (self["gluv"] + 1.0) / 2.0   # stuv


def make_coords(render_height: int, render_width: int, aspect: float,
                device="cpu") -> Coords:
    """Coordinate flavors of one render size (lazy; see Coords)."""
    return Coords(render_height, render_width, aspect, device)


def finish_coords(coords: Coords, resolution) -> Coords:
    """Add the pixel-space coordinates that depend on the iResolution uniform
    (stxy has the reference's +1 offset, vertex/default.glsl:14). Shares the
    lines and the grid cache with `coords`."""
    finished = copy.copy(coords)
    finished.resolution = resolution
    finished._frame = {}
    return finished


# --------------------------------------------------------------------------- #
# Frag: everything a pixel program sees

class Frag:
    """The per-draw context handed to pixel programs: coordinate flavors,
    every pipeline uniform by name (per-frame values are tensors on the
    run's device, statics are host values), textures by name, the batch
    preludes, and the camera."""

    def __init__(self, coords: Coords, uniforms: Mapping, statics: dict,
                 layer: int = 0, instance: int = 0, textures: Optional[dict] = None,
                 texture_meta: Optional[dict] = None,
                 preludes: Optional[dict] = None,
                 prelude_stacks: Optional[dict] = None,
                 prelude_step: Optional[int] = None):
        self._coords = coords
        self._uniforms = uniforms
        self._statics = statics
        self.layer = layer
        self.instance = instance
        self._discard = None                     # (H, W) bool mask set by discard()
        self._textures = textures or {}          # name -> (T, L, H, W, C) tensor
        self._texture_meta = texture_meta or {}  # name -> ShaderTexture
        self._preludes = preludes or {}          # name -> this frame's value
        self._prelude_stacks = prelude_stacks or {}  # name -> (B or 1, ...) stack
        self._prelude_step = prelude_step        # this frame's position in the batch
        self._camera_cache: dict = {}

    def discard(self, mask) -> None:
        """GLSL `discard`: pixels where `mask` is true keep what lies below
        this draw (the instances drawn before it; zeros, the clear color,
        under instance 0) instead of its output. Calls OR together."""
        mask = torch.as_tensor(mask, device=self.device)
        self._discard = mask if self._discard is None else (self._discard | mask)

    # -- coordinates --------------------------------------------------------

    @property
    def astuv(self): return self._coords["astuv"]
    @property
    def agluv(self): return self._coords["agluv"]
    @property
    def stuv(self): return self._coords["stuv"]
    @property
    def gluv(self): return self._coords["gluv"]
    @property
    def stxy(self): return self._coords["stxy"]
    @property
    def glxy(self): return self._coords["glxy"]
    @property
    def fragcoord(self): return self._coords["stxy"]

    @property
    def lines(self) -> tuple:
        """The axis lines of astuv: (u (W,), v (H,)) — astuv[0, :, 0] and
        astuv[:, 0, 1] without building the grid."""
        return self._coords["u_line"], self._coords["v_line"]

    @property
    def device(self) -> torch.device:
        return self._coords.device

    @property
    def resolution(self):
        return self._uniforms["iResolution"]

    @property
    def aspect_ratio(self):
        """iAspectRatio: iResolution.x / iResolution.y (shaderflow.glsl:16)."""
        res = self._uniforms["iResolution"]
        return res[..., 0] / res[..., 1]

    # -- uniforms -----------------------------------------------------------

    def uniform(self, name: str, default=None):
        if name in self._uniforms:
            return self._uniforms[name]
        if name in self._statics:
            return self._statics[name]
        if default is not None:
            return default
        raise KeyError(f"Unknown uniform {name!r}; known: {sorted(self._uniforms)}")

    def __getattr__(self, name: str):
        # Fallback attribute access: uniforms, then textures
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._uniforms:
            return self._uniforms[name]
        if name in self._statics:
            return self._statics[name]
        if name in self._textures:
            return self.tex(name)
        raise AttributeError(f"Frag has no uniform/texture {name!r}")

    # -- textures -----------------------------------------------------------

    def tex(self, name: str, temporal: int = 0, layer: int = -1) -> Sampler2D:
        """Sampler of one texture box with the texture's filter and wrap
        state: a static upload, this frame's row of a device sequence, or a
        program's matrix (temporal slot 0 holds what its layers rendered
        this frame; tex('iScreen') is the newest box, as in the
        reference's <name><T>x<L> naming)."""
        if name not in self._textures:
            raise KeyError(f"Unknown texture {name!r}; known: {sorted(self._textures)}")
        meta = self._texture_meta[name]
        if getattr(meta, "mipmaps", False):
            raise NotImplementedError(f"Texture {name!r} asks for mipmaps: not ported yet")
        return Sampler2D(self._textures[name][temporal, layer], linear=meta.linear,
                         repeat_x=meta.repeat_x, repeat_y=meta.repeat_y)

    def _sampler(self, tex) -> Sampler2D:
        return self.tex(tex) if isinstance(tex, str) else tex

    def texture(self, sampler, uv: torch.Tensor) -> torch.Tensor:
        """GLSL texture() on a Sampler2D or a texture name (ops.sampling)."""
        return sampling.sample(self._sampler(sampler), uv)

    def texel_fetch(self, sampler, xy: torch.Tensor) -> torch.Tensor:
        """GLSL texelFetch on a Sampler2D or a texture name (ops.sampling)."""
        return texel_fetch(self._sampler(sampler), xy)

    def astexture(self, tex, astuv):
        return sampling.astexture(self._sampler(tex), astuv)

    def stexture(self, tex, stuv):
        return sampling.stexture(self._sampler(tex), stuv)

    def gtexture(self, tex, gluv, mirror: bool = False):
        return sampling.gtexture(self._sampler(tex), gluv, mirror)

    def agtexture(self, tex, agluv, mirror: bool = False):
        return sampling.agtexture(self._sampler(tex), agluv,
                                  self.uniform("iWantAspect"), mirror)

    # -- batch preludes -------------------------------------------------------

    def prelude(self, name: str):
        """This frame's slice of a batch prelude (engine.PreludeCtx): a
        value the scene computed once for the whole batch; None when the
        prelude is inactive (callers branch to their per-frame form)."""
        return self._preludes.get(name)

    def prelude_indexed(self, name: str):
        """The whole (B, ...) prelude stack and this frame's position in the
        batch (a Python int), for ops.tailfuse.Indexed: the tail reads the
        frame's plane straight from the stack. None when inactive."""
        stack = self._prelude_stacks.get(name)
        if stack is None or self._prelude_step is None:
            return None
        return stack, self._prelude_step

    # -- fused tail stage -----------------------------------------------------

    def tail(self, fn, **inputs):
        """Defer the remaining per-pixel math to the fused tail stage
        (ops/tailfuse.py): kernel K1 on the card, the plain path on CPU.
        Only valid as the RETURN value of a pixel program."""
        from shaderflow_tpu_torch.ops import tailfuse
        return tailfuse.make_spec(fn, self._coords.height, self._coords.width, **inputs)

    # -- camera -------------------------------------------------------------

    def get_camera(self, name: str = "iCamera"):
        """GetCamera(name) (camera.glsl:132-155): the camera module's
        uniforms wired into ray generation — the separable lines of the
        trivial camera (cameralib.CameraRays), else the per-pixel rays of
        cameralib.project (cameralib.PlaneCameraRays)."""
        if name in self._camera_cache:
            return self._camera_cache[name]
        u, s = self._uniforms, self._statics
        if not s.get(f"{name}Trivial"):
            rays = cameralib.project(
                gluv=self.gluv,
                agluv=self.agluv,
                mode=int(s.get(f"{name}Mode", cameralib.MODE_2D)),
                projection=int(s.get(f"{name}Projection",
                                     cameralib.PROJECTION_PERSPECTIVE)),
                position=u[f"{name}Position"],
                right=u[f"{name}Right"],
                up=u[f"{name}Upward"],
                forward=u[f"{name}Forward"],
                zoom=u[f"{name}Zoom"],
                isometric=u[f"{name}Isometric"],
                orbital=u[f"{name}Orbital"],
                dolly=u[f"{name}Dolly"],
                focal_length=u[f"{name}FocalLength"],
                separation=u[f"{name}Separation"],
                aspect=self.aspect_ratio,
                want_aspect=u["iWantAspect"],
                resolution=u["iResolution"],
            )
            self._camera_cache[name] = rays
            return rays
        aspect = self._coords["aspect"]
        rays = cameralib.project_trivial(
            gluv_x=(self._coords["u_line"] * 2.0 - 1.0) * aspect,
            gluv_y=self._coords["v_line"] * 2.0 - 1.0,
            position=u[f"{name}Position"],
            zoom=u[f"{name}Zoom"],
            isometric=u[f"{name}Isometric"],
            orbital=u[f"{name}Orbital"],
            dolly=u[f"{name}Dolly"],
            focal_length=u[f"{name}FocalLength"],
            aspect=self.aspect_ratio,
            want_aspect=u["iWantAspect"],
            resolution=u["iResolution"],
        )
        self._camera_cache[name] = rays
        return rays

    @property
    def camera(self):
        return self.get_camera()


# --------------------------------------------------------------------------- #
# Built-in fragment programs

def default_fragment(sf: Frag):
    """The welcome shader: a neon hsv ring over a checkerboard with a
    vignette (fragment/default.glsl; shaderflow_tpu/shader.py:311)."""
    cam = sf.camera
    uv = cam.gluv
    angle = sl.atan2(uv)
    color = 0.3 + sl.hsv2rgb(sl.vec3(angle + (2 * sl.TAU * sf.iTau) - (sl.PI / 4), 1.0, 1.0))
    circle = 1.333 * sl.length(uv) - 1.0
    width = 2.0 * torch.abs(1.0 / (circle * circle)) * 1e-4

    grid = torch.where(
        torch.remainder(torch.floor(uv[..., 0] * 4.0) + torch.floor(uv[..., 1] * 4.0),
                        2.0) > 0.5, 0.22, 0.20)[..., None]
    base = torch.where(circle[..., None] < 0.0, 0.18, grid)
    rgb = base + width[..., None] * color

    astuv = cam.astuv
    away = astuv * (1.0 - astuv.flip(-1))
    linear = 50.0 * (away[..., 0] * away[..., 1])
    rgb = rgb * torch.clamp(torch.pow(torch.clamp(linear, min=0.0), 0.1), 0.0, 1.0)[..., None]

    rgb = torch.where(cam.out_of_bounds[..., None], 0.15, rgb)
    return sl.vec4(rgb, 1.0)


def missing_fragment(sf: Frag):
    """The magenta checkerboard the reference shows for a program that
    fails to build (fragment/missing.glsl; shaderflow_tpu/shader.py:335).
    Not wired in as a fallback: a failing fragment raises."""
    uv = sf.stuv + sf.iTime / 64.0
    block = torch.floor(8.0 * uv)
    on = torch.remainder(block[..., 0] + block[..., 1], 2.0) == 0.0
    magenta = torch.where(on, 100.0 / 25.0, 0.0)      # (1, 0, 1) * 100 / 25
    return sl.vec4(magenta, 0.0, magenta, 0.2)


# --------------------------------------------------------------------------- #

class ShaderProgram(ShaderModule):
    """A pixel program + the texture matrix it renders into."""

    instances: int = 1

    def __init__(self, scene=None, name: Optional[str] = None, **kwargs):
        self._fragment: Optional[PixelFunction] = None
        self.texture: Optional[ShaderTexture] = None
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.texture = ShaderTexture(scene=self.scene, name=self.name, track=1.0)
        self._fragment = default_fragment

    @property
    def fragment(self) -> Optional[PixelFunction]:
        return self._fragment

    @fragment.setter
    def fragment(self, value: PixelFunction) -> None:
        if not callable(value):
            raise NotImplementedError(
                f"Fragment source {type(value).__name__}: GLSL / file sources "
                "need the GLSL front-end, not ported yet; pass a Python function")
        self._fragment = value
        self.scene.invalidate_engine()

    def handle(self, message) -> None:
        if isinstance(message, ShaderMessage.Shader.Compile):
            self.scene.invalidate_engine()

    def render_layer(self, ctx: Frag):
        """Run one layer of this program: a TailSpec (the engine fuses it
        with the final pass or evaluates it) or an (H, W, C) float tensor in
        sample space, padded with ones / cropped to the texture's
        components.

        Instancing (shaderflow_tpu/shader.py:505-529): the fragment runs
        `instances` times with ctx.instance = 0..N-1, drawn in order with
        GL's no-blending rule (the last instance to write a pixel wins);
        sf.discard(mask) leaves pixels to the instances below (zeros under
        instance 0)."""
        from shaderflow_tpu_torch.ops import tailfuse
        result = None
        for instance in range(self.instances):
            ctx.instance = instance
            ctx._discard = None
            out = self._fragment(ctx)
            if isinstance(out, tailfuse.TailSpec):
                if self.instances == 1:
                    return out
                height, width = ctx._coords.height, ctx._coords.width
                out = tailfuse.eval_reference(out, height, width, ctx._coords.aspect)
            out = torch.as_tensor(out, dtype=torch.float32, device=ctx.device)
            components = self.texture.components
            if out.shape[-1] < components:
                pad = torch.ones(out.shape[:-1] + (components - out.shape[-1],),
                                 dtype=torch.float32, device=out.device)
                out = torch.cat([out, pad], dim=-1)
            out = out[..., :components]
            if ctx._discard is not None:
                below = torch.zeros_like(out) if result is None else result
                out = torch.where(ctx._discard[..., None], below, out)
            result = out
        return result
