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
missing-texture programs, and ShaderProgram with instancing and its
fragment sources: a Python function, GLSL or Python source text, or a path
to a file of either (GLSL runs through glsl.py). A source that fails to
build resolves to the missing-texture program after a report is written
to the user log directory, as in the reference. Not yet: mipmaps and hot
reload (the realtime loop polls it).
"""

from __future__ import annotations

import copy
import traceback
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Callable, Optional, Union

import torch

import shaderflow_tpu_torch
from shaderflow_tpu_torch import logger, tracing
from shaderflow_tpu_torch.fraggraph import FragmentGraph
from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.ops import cameralib, sampling
from shaderflow_tpu_torch.ops import stdlib as sl
from shaderflow_tpu_torch.ops.rows import require_whole_rows
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
    view that builds them lazily per frame.

    `rows` = (first, end) restricts the flavors to a window of rows (a
    slab of the row-sharded render, parallel/mesh.py): v_line is the
    whole render's line sliced, so every value equals the whole render's
    at the same pixel; `height` is the slab's, `full_height` the
    render's."""

    _GRIDS = ("astuv", "agluv", "stuv", "gluv")
    _FRAME = ("stxy", "glxy")

    def __init__(self, height: int, width: int, aspect: float, device: torch.device,
                 rows: Optional[tuple] = None):
        self.rows = rows
        self.full_height = height
        self.height = height if rows is None else rows[1] - rows[0]
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
        if rows is not None:
            self.v_line = self.v_line[rows[0]:rows[1]]
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
                device="cpu", rows: Optional[tuple] = None) -> Coords:
    """Coordinate flavors of one render size (lazy; see Coords), or of the
    window `rows` of it."""
    return Coords(render_height, render_width, aspect, device, rows)


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
    preludes, and the camera. `recorder`: the FragmentGraph whose
    recording this Frag renders (fraggraph.py), else None."""

    recorder = None

    def __init__(self, coords: Coords, uniforms: Mapping, statics: dict,
                 layer: int = 0, instance: int = 0, textures: Optional[dict] = None,
                 texture_meta: Optional[dict] = None,
                 preludes: Optional[dict] = None,
                 prelude_stacks: Optional[dict] = None,
                 prelude_step: Optional[int] = None,
                 mip_cache: Optional[dict] = None):
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
        self._mip_cache = mip_cache              # the engine's pyramids of static textures
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
        reference's <name><T>x<L> naming). A texture with mipmaps=True
        gives its pyramid (a MipSampler)."""
        if name not in self._textures:
            raise KeyError(f"Unknown texture {name!r}; known: {sorted(self._textures)}")
        meta = self._texture_meta[name]
        array = self._textures[name]
        sampler = Sampler2D(array[temporal, layer], linear=meta.linear,
                            repeat_x=meta.repeat_x, repeat_y=meta.repeat_y)
        if not getattr(meta, "mipmaps", False):
            return sampler
        # texture(mipmaps=True): the pyramid, sampled trilinearly by every
        # accessor; anisotropic only when the texture asked for it
        aniso = meta.anisotropy if getattr(meta, "_aniso_explicit", False) else 1
        if self._mip_cache is None or not isinstance(array, torch.Tensor):
            return sampling.mip_pyramid(sampler, anisotropy=aniso)
        # A static upload is the same tensor every frame until it changes:
        # its pyramid is built once (the reference's compiler hoists it out
        # of the frame loop). The entry holds the tensor, so a match by
        # identity is never a freed tensor's address reused.
        key = (name, temporal, layer, aniso)
        cached = self._mip_cache.get(key)
        if cached is None or cached[0] is not array:
            cached = self._mip_cache[key] = (array, sampling.mip_pyramid(sampler,
                                                                        anisotropy=aniso))
        return cached[1]

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
        prelude is inactive (callers branch to their per-frame form). Its
        planes are the whole render's: a slab renders whole rows."""
        require_whole_rows("a batch prelude")
        return self._preludes.get(name)

    def has_prelude(self, name: str) -> bool:
        return name in self._preludes

    def prelude_indexed(self, name: str):
        """The whole (B, ...) prelude stack and this frame's position in the
        batch (a Python int), for ops.tailfuse.Indexed: the tail reads the
        frame's plane straight from the stack. None when inactive."""
        require_whole_rows("a batch prelude")
        stack = self._prelude_stacks.get(name)
        if stack is None or self._prelude_step is None:
            return None
        return stack, self._prelude_step

    # -- fused tail stage -----------------------------------------------------

    def tail(self, fn, **inputs):
        """Defer the remaining per-pixel math to the fused tail stage
        (ops/tailfuse.py): kernel K1 on the card, the plain path on CPU.
        Only valid as the RETURN value of a pixel program."""
        require_whole_rows("the fused tail")   # K1 writes whole frames
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
    fails to build (fragment/missing.glsl; shaderflow_tpu/shader.py:335)."""
    uv = sf.stuv + sf.iTime / 64.0
    block = torch.floor(8.0 * uv)
    on = torch.remainder(block[..., 0] + block[..., 1], 2.0) == 0.0
    magenta = torch.where(on, 100.0 / 25.0, 0.0)      # (1, 0, 1) * 100 / 25
    return sl.vec4(magenta, 0.0, magenta, 0.2)


# --------------------------------------------------------------------------- #

def _is_pathlike(value) -> bool:
    if isinstance(value, Path):
        return True
    if isinstance(value, str) and "\n" not in value and len(value) < 4096:
        try:
            return Path(value).exists()
        except OSError:
            return False
    return False


class ShaderProgram(ShaderModule):
    """A pixel program + the texture matrix it renders into."""

    instances: int = 1

    def __init__(self, scene=None, name: Optional[str] = None, **kwargs):
        self._fragment: Union[PixelFunction, str, Path, None] = None
        self._resolved: Optional[PixelFunction] = None
        self._compiled_src: Optional[tuple] = None   # (origin, source) of _resolved
        self._watch_path: Optional[Path] = None       # a file fragment, watched in realtime
        self._watch_mtime: float = 0.0
        self.texture: Optional[ShaderTexture] = None
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.texture = ShaderTexture(scene=self.scene, name=self.name, track=1.0)
        self._fragment = default_fragment
        self._resolved = default_fragment

    # -- fragment source handling -------------------------------------------

    @property
    def fragment(self) -> Optional[PixelFunction]:
        return self._resolved

    @fragment.setter
    def fragment(self, value: Union[PixelFunction, str, Path]) -> None:
        self._fragment = value
        self._watch_path = None
        if _is_pathlike(value):
            self._watch_path = Path(value)
            self._watch_mtime = self._watch_path.stat().st_mtime
        self.compile()

    @staticmethod
    def _load_source(source: str, origin: str) -> PixelFunction:
        """Source text -> pixel function: GLSL (`void main()`, the
        reference's `.frag` format) through the GLSL front-end, Python
        (`def main(sf)`) by exec."""
        from shaderflow_tpu_torch import glsl
        if glsl.looks_like_glsl(source):
            return glsl.compile_fragment(source, origin)
        namespace: dict[str, Any] = {}
        exec(compile(source, origin, "exec"), namespace)
        main = namespace.get("main")
        if not callable(main):
            raise ValueError(f"Shader source {origin!r} does not define main(sf)")
        return main

    def compile(self) -> "ShaderProgram":
        """Resolve the fragment into a callable; on a build error write a
        report and resolve to the missing-texture program, as the reference
        does (a run never crashes on a shader)."""
        value = self._fragment
        try:
            if value is None:
                self._resolved = default_fragment
                self._compiled_src = None
            elif callable(value):
                self._resolved = value
                self._compiled_src = None
            elif _is_pathlike(value):
                path = Path(value)
                source = path.read_text()
                # Unchanged source keeps the resolved callable: the compile
                # relay fires on every run's set-up, and re-parsing would
                # walk the whole source again for every export
                if self._compiled_src == (str(path), source):
                    return self
                self._resolved = self._load_source(source, str(path))
                self._compiled_src = (str(path), source)
            elif isinstance(value, str):
                if self._compiled_src == (self.name, value):
                    return self
                self._resolved = self._load_source(value, f"<{self.name}-fragment>")
                self._compiled_src = (self.name, value)
            else:
                raise TypeError(f"Unsupported fragment source: {type(value)}")
        except Exception as error:
            self.dump_error(error)
            self._resolved = missing_fragment
            self._compiled_src = None
        self.scene.invalidate_engine()
        return self

    def dump_error(self, error: Exception) -> None:
        """Write the faulty source and its traceback to the user log
        directory and log loudly (the reference's ShaderDumper)."""
        directory = shaderflow_tpu_torch.directories.ensure().user_log_path
        report = directory / f"{self.uuid}-error.md"
        source = self._fragment if isinstance(self._fragment, str) else str(self._fragment)
        report.write_text(
            f"# Shader build error (module {self.uuid}, {self.name})\n\n"
            f"```\n{traceback.format_exc()}\n```\n\n## Source\n\n```\n{source}\n```\n")
        logger.error(f"Error building shader {self.name}: {error}; "
                     f"falling back to missing-texture shader (report: {report})")

    def poll_hot_reload(self) -> bool:
        """The realtime loop's file watch: when a file fragment's mtime
        changed, queue its recompile as a 'once' task of the scene's
        scheduler (the frame runs it before capturing). Exports never
        reload."""
        if self._watch_path is None:
            return False
        try:
            mtime = self._watch_path.stat().st_mtime
        except OSError:
            return False
        if mtime != self._watch_mtime:
            self._watch_mtime = mtime
            self.scene.scheduler.once(self.compile)
            return True
        return False

    def handle(self, message) -> None:
        if isinstance(message, ShaderMessage.Shader.Compile):
            self.compile()

    def ui(self):
        tex = self.texture
        yield (f"{tex.resolution[0]}x{tex.resolution[1]}  "
               f"layers {tex.layers}  temporal {tex.temporal}")
        if self._watch_path is not None:
            yield f"watching {self._watch_path.name}"

    def render_layer(self, ctx: Frag):
        """Run one layer of this program: a TailSpec (the engine fuses it
        with the final pass or evaluates it) or an (H, W, C) float tensor in
        sample space, padded with ones / cropped to the texture's
        components (draw).

        A Frag from the engine's FragmentGraph (ctx.recorder, fraggraph.py)
        is a recorded frame: the build's second frame of a recordable
        program is captured into a CUDA graph and replayed, and every later
        frame only replays it. Every other frame, the first of a
        recording's included, runs the fragment eagerly."""
        with tracing.span("fragment"):
            FragmentGraph.calls += 1
            if ctx.recorder is not None:
                return ctx.recorder.render(self, ctx)
            return self.draw(ctx)

    def draw(self, ctx: Frag):
        """The fragment run eagerly over `ctx` (see render_layer).

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
            out = self._resolved(ctx)
            if isinstance(out, tailfuse.TailSpec):
                if self.instances == 1:
                    return out
                height, width = ctx._coords.height, ctx._coords.width
                out = tailfuse.eval_reference(out, height, width, ctx._coords.aspect)
            out = self.fit(torch.as_tensor(out, dtype=torch.float32, device=ctx.device))
            if ctx._discard is not None:
                below = torch.zeros_like(out) if result is None else result
                out = torch.where(ctx._discard[..., None], below, out)
            result = out
        return result

    def fit(self, value: torch.Tensor) -> torch.Tensor:
        """An (H, W, C) float32 layer value as this program's texture holds
        it: padded with ones, or cropped, to the texture's components."""
        components = self.texture.components
        if value.shape[-1] < components:
            pad = torch.ones(value.shape[:-1] + (components - value.shape[-1],),
                             dtype=torch.float32, device=value.device)
            value = torch.cat([value, pad], dim=-1)
        return value[..., :components]
