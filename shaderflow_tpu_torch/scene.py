"""
ShaderScene — the root module, time model, and batched offline export.

Port of shaderflow_tpu/scene.py, offline path: the scene is its own first
module, owns the frametimer, keyboard and camera modules, the main
"iScreen" program and the SSAA final program, the virtual time model, the
resolution model with fractional SSAA, and `main()`. main() advances module
state per frame on the host, captures uniforms, and renders B frames per
flush through the engine; the device renders batch k while the host
captures batch k+1 and the sink drains batch k-1.

The device is an argument: main(..., device="cuda") by default, and
device="cpu" runs every kernel's plain PyTorch version. Before the first
frame, modules prewarm (the audio precomputes); the runtime follows the
longest module duration (the audio file) unless `time` is given; module
ffhooks mux their inputs (the audio) into FFmpeg outputs; the scene's
batch_preludes run in the engine once per batch. Not ported yet: the
realtime loop, window, HUD and input devices, multi-device sharding.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np
import torch

from shaderflow_tpu_torch import logger, resolve_device
from shaderflow_tpu_torch.engine import RenderEngine, to_wire
from shaderflow_tpu_torch.exporting import ExportingHelper
from shaderflow_tpu_torch.frametimer import ShaderFrametimer
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.keyboard import ShaderKeyboard
from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.resolution import Resolution
from shaderflow_tpu_torch.shader import ShaderProgram
from shaderflow_tpu_torch.variable import ShaderVariable, StaticUniform


def _parse_ratio(value: str) -> Optional[float]:
    """Parse '16:9', '16/9', '1.777' or 'none' (no eval)."""
    text = value.strip().lower()
    if text in ("", "none", "null"):
        return None
    for sep in (":", "/"):
        if sep in text:
            num, _, den = text.partition(sep)
            return float(num) / float(den)
    return float(text)


def _parse_duration(value: str) -> Optional[float]:
    """Parse a duration: plain seconds, 'MM:SS'/'HH:MM:SS', or a simple
    product/quotient like '30*60' (no general expression eval)."""
    text = value.strip().lower().removesuffix("s")
    if not text or text in ("none", "null"):
        return None
    if ":" in text:
        total = 0.0
        for part in text.split(":"):
            total = total * 60.0 + float(part)
        return total
    if "*" in text:
        result = 1.0
        for factor in text.split("*"):
            result *= float(factor)
        return result
    if "/" in text:
        num, _, den = text.partition("/")
        return float(num) / float(den)
    return float(text)


class ShaderScene(ShaderModule):

    PIPELINE_DEPTH = 2
    """Batches in flight before the host drains the oldest: the device
    always has a queued batch when one finishes, and the sink's host work
    overlaps the next batch's compute."""

    def __init__(self, **kwargs):
        # The scene is its own first module; the registry must exist before
        # ShaderModule.__init__ appends self to it.
        self.modules: list[ShaderModule] = []

        # Temporal model
        self.time: float = 0.0
        self._frame_counter: int = 0
        self.speed: float = 1.0
        self.runtime: float = 10.0
        self.fps: float = 60.0
        self.dt: float = 0.0
        self.rdt: float = 0.0

        # Resolution model
        self._width: int = 1920
        self._height: int = 1080
        self._ssaa: float = 1.0
        self._aspect_ratio: Optional[float] = None
        self.quality: float = 50.0
        self.subsample: int = 2

        # Run state
        self.device: torch.device = torch.device("cpu")
        self.realtime: bool = True
        self.exporting: bool = False
        self.freewheel: bool = False
        self.quit: bool = False

        # Interaction state (uniforms; no input devices in the offline path)
        self.mouse_gluv: tuple[float, float] = (0.0, 0.0)
        self.mouse_inside: bool = False
        self.mouse_buttons: dict[int, bool] = {k: False for k in range(1, 6)}
        self.exclusive: bool = False

        self.ffmpeg = FFmpeg()
        self.engine: Optional[RenderEngine] = None
        self.batch_preludes: dict = {}
        # Module-registered CLI commands (module.register_command)
        self._commands: dict = {}

        self.frametimer: Optional[ShaderFrametimer] = None
        self.keyboard: Optional[ShaderKeyboard] = None
        self.camera = None
        self.shader: Optional[ShaderProgram] = None
        self._final: Optional[ShaderProgram] = None
        self._initialized = False
        self._capture_enabled = True

        super().__init__(scene=None, **kwargs)
        self.name = self.name or type(self).__name__

    # ------------------------------------------------------------------ #
    # Initialization

    def initialize(self) -> None:
        if self._initialized:
            return
        from shaderflow_tpu_torch.camera import ShaderCamera

        self.frametimer = ShaderFrametimer(scene=self)
        self.keyboard = ShaderKeyboard(scene=self)
        self.camera = ShaderCamera(scene=self)

        # SSAA downsampler target (u8 RGB at the output resolution) and the
        # main screen program, in this order — the engine renders reversed.
        self._final = ShaderProgram(scene=self, name="iFinal")
        self._final.texture.components = 3
        self._final.texture.dtype = np.uint8
        self._final.texture.final = True
        self._final.texture.track = 1.0
        self.shader = ShaderProgram(scene=self, name="iScreen")
        self.shader.texture.repeat(False)
        self.shader.texture.track = 1.0

        self.engine = RenderEngine(self)
        self._initialized = True
        self.build()

    def invalidate_engine(self) -> None:
        if self.engine is not None:
            self.engine.invalidate()

    # ------------------------------------------------------------------ #
    # Temporal model

    @property
    def tau(self) -> float:
        return (self.time / self.runtime) % 1.0

    @property
    def frametime(self) -> float:
        return 1.0 / self.fps

    @property
    def frame(self) -> int:
        return round(self.time * self.fps)

    @property
    def duration(self) -> float:
        return self.runtime

    @property
    def max_duration(self) -> float:
        return max((module.duration or 0.0) for module in self.modules)

    def set_duration(self, override: Optional[float] = None) -> float:
        self.runtime = (override or self.max_duration or self.runtime)
        self.runtime /= self.speed
        return self.runtime

    # ------------------------------------------------------------------ #
    # Resolution model

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    @property
    def resolution(self) -> tuple[int, int]:
        return (self._width, self._height)

    @property
    def ssaa(self) -> float:
        """Fractional supersampling factor; O(N^2) device cost."""
        return self._ssaa

    @ssaa.setter
    def ssaa(self, value: float) -> None:
        self._ssaa = max(0.01, float(value))
        self.relay(ShaderMessage.Shader.RecreateTextures)
        self.invalidate_engine()

    @property
    def render_resolution(self) -> tuple[int, int]:
        return (int(self._width * self._ssaa), int(self._height * self._ssaa))

    @property
    def aspect_ratio(self) -> float:
        return self._aspect_ratio or (self._width / self._height)

    @aspect_ratio.setter
    def aspect_ratio(self, value: Optional[Union[float, str]]) -> None:
        if isinstance(value, str):
            value = _parse_ratio(value)
        self._aspect_ratio = value

    def resize(
        self,
        width: Optional[int] = None,
        height: Optional[int] = None,
        ratio: Optional[Union[float, str]] = None,
        bounds: Optional[tuple[int, int]] = None,
        ssaa: Optional[float] = None,
        scale: float = 1.0,
    ) -> tuple[int, int]:
        self.aspect_ratio = (ratio or self._aspect_ratio)
        self._ssaa = (ssaa or self._ssaa)
        resolution = Resolution.fit(
            old=(self._width, self._height),
            new=(width, height),
            max=bounds,
            ar=self._aspect_ratio,
            scale=scale,
        )
        if resolution != (self._width, self._height):
            self._width, self._height = resolution
            self.relay(ShaderMessage.Shader.RecreateTextures)
            self.invalidate_engine()
            logger.info(f"Resized Scene to {self.resolution}")
        return self.resolution

    # ------------------------------------------------------------------ #
    # Frame stepping

    def next(self, dt: float = 0.0) -> None:
        """Advance one frame of host state: every module's update(), the
        engine's capture, then time (frame zero renders at t=0)."""
        for module in self.modules:
            if not isinstance(module, ShaderProgram):
                module.update()
        if self.engine is not None and self._capture_enabled:
            self.engine.capture_frame()
        self.dt = dt * self.speed
        self.rdt = dt
        self.time += self.dt
        self._frame_counter += 1

    # ------------------------------------------------------------------ #
    # Main entry point

    def main(
        self,
        *,
        width: Optional[int] = 1920,
        height: Optional[int] = 1080,
        scale: float = 1.0,
        ratio: Optional[Union[float, str]] = None,
        fps: float = 60.0,
        quality: float = 50.0,
        ssaa: float = 1.0,
        subsample: int = 2,
        output: Optional[Union[Path, str]] = None,
        time: Optional[Union[float, str]] = None,
        speed: float = 1.0,
        freewheel: bool = False,
        raw: bool = False,
        turbo: bool = True,
        buffers: int = 5,
        batch: Optional[int] = None,
        start: float = 0.0,
        device: Union[str, torch.device] = "cuda",
    ) -> Optional[Path]:
        """Export the scene to `output` ("null" renders and discards).

        `device` runs the render on "cuda" (the default; raises without a
        card) or "cpu" (every kernel's plain PyTorch version). `start`
        resumes at a content time in seconds: host state is replayed
        without rendering (a scene with a temporal ring renders the
        replayed frames to rebuild it), then [start, duration) is
        rendered."""
        final_width, final_height = self._setup_run(
            width=width, height=height, scale=scale, ratio=ratio, fps=fps,
            quality=quality, ssaa=ssaa, subsample=subsample, output=output,
            time=time, speed=speed, freewheel=freewheel, raw=raw, device=device)
        if self.realtime:
            raise NotImplementedError(
                "The realtime preview is not ported yet: pass output= "
                "(or freewheel=True) to export")
        export = ExportingHelper(self)
        export.make_sink(output, width=final_width, height=final_height,
                         turbo=turbo, buffers=buffers)
        return self._export_loop(export, batch, start_frame=round(start * self.fps))

    def _setup_run(self, *, width=1920, height=1080, scale=1.0, ratio=None,
                   fps=60.0, quality=50.0, ssaa=1.0, subsample=2, output=None,
                   time=None, speed=1.0, freewheel=False, raw=False,
                   device="cuda") -> tuple[int, int]:
        """Everything main() does before the loop: device, flags, compile
        relay, resize, module setup, duration, SSAA/raw resolution policy."""
        self.initialize()
        device = resolve_device(device)
        if device != self.device:
            self.device = device
            self.invalidate_engine()
        self.exporting = bool(output)
        self.freewheel = (self.exporting or freewheel)
        self.realtime = not self.freewheel
        self.subsample = int(subsample)
        self.quality = float(quality)
        self.speed = float(speed)
        self.fps = float(fps)
        self.time = 0.0
        self.dt = 0.0
        self.rdt = 0.0
        self._frame_counter = 0
        self.relay(ShaderMessage.Shader.Compile)

        final_width, final_height = self.resize(
            width=width, height=height, ratio=ratio, scale=scale)

        for module in self.modules:
            module.setup()

        self.set_duration(_parse_duration(time) if isinstance(time, str) else time)

        # Raw mode (or downscale SSAA): export native render-resolution
        # frames and skip the device downsample (the encoder rescales)
        if self.freewheel and (raw or ssaa < 1):
            self._ssaa = float(ssaa)
            self.resize(*self.render_resolution, scale=1, ssaa=1)
        else:
            self.ssaa = ssaa
        return (final_width, final_height)

    def default_batch_size(self) -> int:
        """Frames per flush: ~0.75 GB of u8 output per batch (128 frames at
        1080p, 32 at 4K)."""
        pixels = self._width * self._height
        return int(np.clip(2 ** 28 // max(1, pixels), 4, 128))

    def _prewarm_modules(self) -> None:
        """Every module's prewarm() before the first frame (the whole-file
        spectrogram and waveform precomputes), in module order."""
        for module in self.modules:
            module.prewarm()

    def _export_loop(self, export: ExportingHelper, batch: Optional[int],
                     start_frame: int = 0):
        total = export.total_frames
        size = int(batch or self.default_batch_size())
        self._prewarm_modules()

        if start_frame:
            # Stateless scenes replay host updates only; a scene with a
            # temporal ring renders the replayed frames (and drops them) to
            # rebuild its history
            feedback = any(isinstance(module, ShaderProgram) and module.texture.temporal > 1
                           for module in self.modules)
            logger.info(f"Resuming export at frame {start_frame} "
                        f"({'render' if feedback else 'host'} replay)")
            replayed = 0
            while replayed < min(start_frame, total):
                if feedback:
                    count = min(size, start_frame - replayed)
                    self.engine.begin_batch()
                    for _ in range(count):
                        self.next(dt=self.frametime)
                    self.engine.flush(count)
                    replayed += count
                    continue
                self._capture_enabled = False
                try:
                    self.next(dt=self.frametime)
                finally:
                    self._capture_enabled = True
                replayed += 1
            total = total - start_frame

        in_flight: list = []
        frame_index = 0
        while frame_index < total and not self.quit:
            count = min(size, total - frame_index)
            self.engine.begin_batch()
            for _ in range(count):
                self.next(dt=self.frametime)
            frames = self.engine.flush(count)
            in_flight.append(to_wire(frames, host=export.wants_host_frames))
            while len(in_flight) > self.PIPELINE_DEPTH:
                export.pipe_batch(in_flight.pop(0))
            frame_index += count

        for staged in in_flight:
            export.pipe_batch(staged)

        result = export.finish()
        export.log_stats(output=result)
        return result

    # ------------------------------------------------------------------ #
    # Module protocol

    def handle(self, message) -> None:
        if isinstance(message, ShaderMessage.Window.Close):
            self.quit = True

    def pipeline(self) -> Iterable[ShaderVariable]:
        """Global uniforms every shader sees (the reference's set)."""
        u = self.uniform  # cached objects — host hot path
        yield u("int", "iLayer", None)  # injected per layer by the engine
        yield u("float", "iTime", self.time)
        yield u("float", "iTau", self.tau)
        yield u("float", "iDuration", self.duration)
        yield u("float", "iDeltatime", self.dt)
        yield u("vec2", "iResolution", self.resolution)
        yield u("float", "iWantAspect", self.aspect_ratio)
        yield u("float", "iQuality", self.quality / 100)
        # Static twin of iQuality for shaders that derive loop trip counts
        # from it (e.g. fractal escape iterations)
        yield StaticUniform("float", "iQualityS", self.quality / 100)
        yield u("float", "iSSAA", self.ssaa)
        yield u("float", "iFramerate", self.fps)
        yield u("int", "iFrame", self.frame)
        yield u("int", "iFrameIndex", self._frame_counter)
        yield u("bool", "iRealtime", self.realtime)
        yield u("vec2", "iMouse", self.mouse_gluv)
        yield u("bool", "iMouseInside", self.mouse_inside)
        for i in range(1, 3):
            yield u("bool", f"iMouse{i}", self.mouse_buttons[i])

    def destroy(self) -> None:
        for module in self.modules:
            if module is not self:
                module.destroy()
