"""
ShaderScene — the root module, time model, batched export and realtime loop.

Port of shaderflow_tpu/scene.py: the scene is its own first module, owns
the frametimer, keyboard and camera modules, the main "iScreen" program and
the SSAA final program, the virtual time model, the resolution model with
fractional SSAA, and `main()`.

With an output, main() exports: it advances module state per frame on the
host, captures uniforms, and renders B frames per flush through the
engine; the device renders batch k while the host captures batch k+1 and
the sink drains batch k-1. Before the first frame, modules prewarm (the
audio precomputes); the runtime follows the longest module duration (the
audio file) unless `time` is given; module ffhooks mux their inputs (the
audio) into FFmpeg outputs; the scene's batch_preludes run in the engine
once per batch.

Without one, main() runs the realtime preview: the scheduler paces one
task at the scene's fps (frameskip stretches dt when a frame is late);
each tick polls the shaders' files, runs the once tasks, steps and
captures a frame (or a micro-batch, _rt_batch_size) and flushes it. With a
window (WindowBackend.Preview) the frames reach it through the display pump
(io/displaypump.py): an SDL window (io/sdlwindow.py), whose events come back
as message relays, or where SDL cannot open one (or SHADERFLOW_PREVIEW=cv2)
OpenCV's window, its keys from the X11 keymap (io/x11keys.py) or waitKey
and its mouse through a callback; with neither, the loop runs headless and
waits on frame k-1 while frame k renders. The window is a fallback of the
display only: the render stays on the device. TAB toggles the HUD (a
module list with the selected module's panel: ui() lines, editable
ui_fields(), ui_plots() sparklines), drawn on a host copy of the shown
frame. `frame_limit` ends a run after that many frames.

The device is an argument: main(..., device="cuda") by default, and
device="cpu" runs every kernel's plain PyTorch version. main(...,
devices=N) shards an export's flushes over N devices (parallel/mesh.py):
the frames of a batch for a scene without temporal feedback, the rows of
every frame for one with it; the first N of `mesh_devices` (by default the
visible cards, or the CPU).
"""

from __future__ import annotations

import math
import os
import sys
import time
from enum import Enum
from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np
import torch

from shaderflow_tpu_torch import logger, resolve_device, switches, tracing
from shaderflow_tpu_torch.engine import RenderEngine, fetch_frame, to_wire
from shaderflow_tpu_torch.exporting import ExportingHelper
from shaderflow_tpu_torch.frametimer import ShaderFrametimer
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.keyboard import ShaderKeyboard
from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.resolution import Resolution
from shaderflow_tpu_torch.scheduler import Scheduler
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


class WindowBackend(Enum):
    Headless = "headless"
    Preview = "preview"   # a window on a display (io/sdlwindow.py)

    @classmethod
    def infer(cls) -> "WindowBackend":
        """WINDOW_BACKEND when set; headless for a command-line export
        (`main ... -o`); a window where a display exists."""
        if (option := os.getenv("WINDOW_BACKEND")):
            return cls(option)
        if ("main" in sys.argv) and any(x in sys.argv for x in ("--output", "-o")):
            return cls.Headless
        if os.getenv("DISPLAY"):
            return cls.Preview
        return cls.Headless


class ShaderScene(ShaderModule):

    frame_limit: Optional[int] = None
    """Stop the realtime loop after N frames (tests, timed demos)."""

    mesh_devices: Optional[list] = None
    """The devices an export with devices=N shards over (its first N); by
    default the visible cards of a run on the card, the CPU device of a run
    on the CPU. A device may repeat: N shards of one card, each on a CUDA
    stream of its own, or N shards of the CPU."""

    _RT_BATCH_MAX = 8

    def __init__(self, backend: Optional[WindowBackend] = None, **kwargs):
        # The scene is its own first module; the registry must exist before
        # ShaderModule.__init__ appends self to it.
        self.modules: list[ShaderModule] = []
        self.backend = WindowBackend(backend) if backend else WindowBackend.infer()

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
        self.title: str = "ShaderFlow"
        self.fullscreen: bool = False

        # Interaction state
        self.mouse_gluv: tuple[float, float] = (0.0, 0.0)
        self.mouse_inside: bool = False
        self.mouse_buttons: dict[int, bool] = {k: False for k in range(1, 6)}
        self.exclusive: bool = False
        self.render_ui: bool = False
        # HUD navigation ([ / ] select the expanded module panel, , / .
        # select an editable field, - / + nudge it) and its mouse state:
        # each drawn row's action, a drag on a field, the pointer, and the
        # shown frame's size (window pixels map into it)
        self._ui_index: int = 0
        self._ui_field_index: int = 0
        self._hud_rows: list = []
        self._hud_dragging: bool = False
        self._mouse_xy: tuple[int, int] = (-1, -1)
        self._shown_frame_size: Optional[tuple[int, int]] = None

        # Realtime loop: the pacing scheduler and its frame task, the
        # window, the display pump, the micro-batch controller's state
        self.scheduler = Scheduler()
        self.vsync = None
        self._window = None
        self._preview = None      # the cv2 module while its preview window is open
        self._keymap = None       # the cv2 preview's key sources (io/x11keys.py)
        self._autorelease = None
        self._display_pump = None
        self._inflight_rt: list = []
        self._pending_preview: list = []
        self._rt_batch_n = 1
        self._rt_batch_active = 1
        self._rt_cost_ema: Optional[float] = None
        self._rt_streak = 0

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
    def cycle(self) -> float:
        """tau in radians: one turn over the runtime."""
        return self.tau * math.tau

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

    @property
    def components(self) -> int:
        """Channels of the final (output) texture."""
        return self._final.texture.components

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
        """Advance one frame of host state: every module's update(), in
        realtime the shaders' file watch and the once tasks (a hot reload
        recompiles here), the engine's capture, then time (frame zero
        renders at t=0)."""
        with tracing.span("scene.step"):
            for module in self.modules:
                if not isinstance(module, ShaderProgram):
                    module.update()
            if self.realtime:
                for module in self.modules:
                    if isinstance(module, ShaderProgram):
                        module.poll_hot_reload()
                self.scheduler.all_once()
            if self.engine is not None and self._capture_enabled:
                with tracing.span("capture"):
                    self.engine.capture_frame()
            if self.vsync is not None:
                # One launch covers _rt_batch_active frame periods: the frame
                # task paces at fps / N (and follows live fps edits)
                self.vsync.fps = self.fps / max(1, self._rt_batch_active)
            self.dt = dt * self.speed
            self.rdt = dt
            self.time += self.dt
            self._frame_counter += 1

    def screenshot(self) -> np.ndarray:
        """Render the current frame once -> (H, W, 3) uint8 on the host; the
        scene's time and frame counter are left as they were."""
        self.engine.begin_batch()
        saved = (self.time, self.dt, self.rdt, self._frame_counter)
        self.next(dt=0.0)
        self.time, self.dt, self.rdt, self._frame_counter = saved
        frames = self.engine.flush(1)
        if not isinstance(frames, torch.Tensor):   # a sharded flush's parts
            return frames.cpu().numpy()[0]
        return fetch_frame(frames[0])

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
        frameskip: bool = True,
        fullscreen: bool = False,
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
        devices: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> Optional[Path]:
        """Export the scene to `output` ("null" renders and discards), or
        without one (and without freewheel) run the realtime preview until
        the window closes, a quit, or `frame_limit` frames.

        `device` runs the render on "cuda" (the default; raises without a
        card) or "cpu" (every kernel's plain PyTorch version). `start`
        resumes an export at a content time in seconds: host state is
        replayed without rendering (a scene with a temporal ring renders
        the replayed frames to rebuild it), then [start, duration) is
        rendered. `frameskip` (realtime): a late frame steps the real time
        it took, else at most one period. `devices` shards an export over
        that many devices (parallel/mesh.py): the frames of each batch for
        a scene without temporal feedback, else the rows of every frame
        (the output height must divide it); the realtime loop ignores
        it. An export is traced in an open tracing session (tracing.py)."""
        setup = dict(width=width, height=height, scale=scale, ratio=ratio, fps=fps,
                     fullscreen=fullscreen, quality=quality, ssaa=ssaa,
                     subsample=subsample, output=output, time=time, speed=speed,
                     freewheel=freewheel, raw=raw, device=device)
        if not (output or freewheel):   # _setup_run's realtime policy
            self._setup_run(**setup)
            switches.announce(self.device)
            return self._realtime_loop(frameskip)
        with tracing.export(batch_trace=switches.batch_trace()):
            with tracing.span("export.setup"):
                final_width, final_height = self._setup_run(**setup)
                switches.announce(self.device)
                export = ExportingHelper(self)
                export.make_sink(output, width=final_width, height=final_height,
                                 turbo=turbo, buffers=buffers)
                export.open_bar()
            return self._export_loop(export, batch, start_frame=round(start * self.fps),
                                     devices=devices)

    def _setup_run(self, *, width=1920, height=1080, scale=1.0, ratio=None,
                   fps=60.0, fullscreen=False, quality=50.0, ssaa=1.0, subsample=2,
                   output=None, time=None, speed=1.0, freewheel=False, raw=False,
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
        self.quit = False
        self.title = f"ShaderFlow • {self.name}"
        self.fullscreen = fullscreen
        self.subsample = int(subsample)
        self.quality = float(quality)
        self.speed = float(speed)
        self.fps = float(fps)
        self.time = 0.0
        self.dt = 0.0
        self.rdt = 0.0
        self._frame_counter = 0
        self.relay(ShaderMessage.Shader.Compile)
        self.scheduler.clear()

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

    def pipeline_depth(self, size: int) -> int:
        """Batches an export keeps in flight before the host drains the
        oldest: the device always has a queued batch when one finishes, and
        the sink's host work overlaps the next batch's compute. 2 while
        three (size, H, W, 3) u8 batches fit in 2.5 GB, else 1; the budget
        is the JAX package's (shaderflow_tpu/scene.py:591-595), sized for
        the v5e's 16 GB and kept as it is. SHADERFLOW_PIPELINE_DEPTH
        overrides it (at least 1)."""
        batch_bytes = size * self._width * self._height * 3
        return switches.pipeline_depth(2 if 3 * batch_bytes <= (5 << 29) else 1)

    def _prewarm_modules(self) -> None:
        """Every module's prewarm() before the first frame (the whole-file
        spectrogram and waveform precomputes), in module order."""
        with tracing.span("prewarm"):
            for module in self.modules:
                module.prewarm()

    def _export_loop(self, export: ExportingHelper, batch: Optional[int],
                     start_frame: int = 0, devices: Optional[int] = None):
        total = export.total_frames
        size = int(batch or self.default_batch_size())
        self._prewarm_modules()

        self.engine.mesh = None
        if devices and devices > 1:
            from shaderflow_tpu_torch.parallel.mesh import (
                available_devices, frame_mesh, supports_frame_sharding)
            pool = (list(self.mesh_devices) if self.mesh_devices is not None
                    else available_devices(self.device))
            available = len(pool)
            if available < devices:
                logger.warning(f"Requested {devices} devices, {available} "
                               f"available — rendering on one chip")
            elif supports_frame_sharding(self):
                # A batch of a multiple of the mesh gives every shard as
                # many frames
                size = max(size, devices) // devices * devices
                self.engine.mesh = frame_mesh(devices, pool)
                logger.info(f"Frame-sharded export over {devices} devices "
                            f"(batch {size}, {size // devices}/chip)")
            elif self.height % devices == 0:
                # Temporal feedback serializes frames; shard pixel rows
                # instead (engine.flush row path, exact by construction)
                self.engine.mesh = frame_mesh(devices, pool)
                logger.info(f"Row-sharded export over {devices} devices "
                            f"(temporal feedback; {self.height // devices} "
                            f"rows/chip)")
            else:
                logger.warning(f"Scene has temporal feedback and height "
                               f"{self.height} does not divide {devices} "
                               f"devices — rendering on one chip")

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

        depth = self.pipeline_depth(size)
        # SHADERFLOW_BATCH_TRACE=1: a line a batch on stderr, in the JAX
        # package's format, from the tracer's spans of the batch: capture is
        # its scene steps, dispatch its flush (the host's enqueue, not
        # device time: nothing waits for the device here), drain the pipes
        # of its loop turn (the wait for the oldest batch's copy to the
        # host and the sink's write: wire.wait and sink.write apart)
        trace = switches.batch_trace()
        in_flight: list = []
        frame_index = 0
        while frame_index < total and not self.quit:
            tracing.batch(frame_index // size)
            count = min(size, total - frame_index)
            self.engine.begin_batch()
            for _ in range(count):
                self.next(dt=self.frametime)
            frames = self.engine.flush(count)
            with tracing.span("wire.stage"):
                in_flight.append(to_wire(frames, host=export.wants_host_frames))
            while len(in_flight) > depth:
                export.pipe_batch(in_flight.pop(0))
            if trace:
                spent = tracing.batch_seconds("scene.step", "engine.flush", "export.pipe")
                print(f"BATCH_TRACE frames={frame_index}+{count} "
                      f"capture={1e3 * spent['scene.step']:.1f}ms "
                      f"dispatch={1e3 * spent['engine.flush']:.1f}ms "
                      f"drain={1e3 * spent['export.pipe']:.1f}ms", file=sys.stderr, flush=True)
            frame_index += count

        tracing.batch(None)
        with tracing.span("export.drain"):
            for staged in in_flight:
                export.pipe_batch(staged)
            result = export.finish()
            export.log_stats(output=result)
        # The run's CUDA graph and its memory pool end with the run, not
        # with the scene (fraggraph.py): a later run records anew
        self.engine.drop_recording()
        return result


    # ------------------------------------------------------------------ #
    # Realtime loop

    def open_window(self):
        """The preview's SDL window (io/sdlwindow.py): a focused-window
        event queue with exact key press and release, modifiers, unicode,
        wheel, resize, file drop and close. None where SDL cannot open one."""
        try:
            from shaderflow_tpu_torch.io.sdlwindow import SDLWindow
            return SDLWindow(self.title, *self.resolution)
        except Exception as error:
            logger.debug(f"SDL window unavailable ({error}); falling back to the cv2 preview")
            return None

    def open_preview(self):
        """The cv2 preview: OpenCV's window, its mouse into
        _cv2_mouse_event -> the cv2 module, or None where it cannot open."""
        try:
            import cv2
            cv2.namedWindow(self.title, cv2.WINDOW_NORMAL)
            cv2.setMouseCallback(self.title, self._cv2_mouse_event)
            return cv2
        except Exception as error:
            logger.debug(f"cv2 preview unavailable ({error}); running headless")
            return None

    def _realtime_loop(self, frameskip: bool) -> None:
        self.engine.mesh = None   # devices=N shards exports only
        # The display: SDL first, the cv2 preview where SDL cannot open (or
        # SHADERFLOW_PREVIEW=cv2; =sdl never takes cv2), else headless. The
        # render runs on the device whichever shows it
        window = preview = None
        if self.backend == WindowBackend.Preview:
            choice = os.environ.get("SHADERFLOW_PREVIEW", "").lower()
            if choice != "cv2":
                window = self.open_window()
            if window is None and choice != "sdl":
                preview = self.open_preview()
        self._window, self._preview = window, preview
        if preview is not None:
            # The cv2 preview's keys: the X11 keymap where an X server is
            # (exact transitions with Shift, Ctrl, Alt), else waitKey codes
            # with releases synthesized (AutoReleaseKeys)
            from shaderflow_tpu_torch.io.x11keys import AutoReleaseKeys, X11Keymap
            self._keymap = X11Keymap()
            self._autorelease = AutoReleaseKeys()
        # A forced micro-batch (SHADERFLOW_RT_BATCH=N) covers N frame periods
        # a launch, so the frame task paces at fps / N; auto mode starts at
        # one frame and _rt_batch_feedback retunes the frequency
        setting = os.environ.get("SHADERFLOW_RT_BATCH", "auto")
        forced = int(setting) if setting.isdigit() else 0
        self._rt_batch_n = 1
        self._rt_batch_active = 1
        self._rt_cost_ema = None
        self._rt_streak = 0
        self.vsync = self.scheduler.new(
            task=self._realtime_frame, frequency=self.fps / max(1, forced),
            frameskip=frameskip, precise=True)
        self._pending_preview = []
        self._inflight_rt = []
        try:
            while self.scheduler.next() is not None:
                if self.quit:
                    break
        finally:
            if self._display_pump is not None:
                self._display_pump.close()
                self._display_pump = None
            for _, done in self._pending_preview + self._inflight_rt:
                if done is not None:
                    done.synchronize()
            self._pending_preview = []
            self._inflight_rt = []
            if self._window is not None:
                self._window.close()
                self._window = None
            if self._preview is not None:
                self._preview.destroyAllWindows()
                self._preview = None
            if self._keymap is not None:
                self._keymap.close()
                self._keymap = None
            self.engine.drop_recording()   # as at an export's end

    def _rendered(self) -> Optional[torch.cuda.Event]:
        """An event behind the frames just flushed (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _realtime_frame(self, dt: float = 0.0) -> None:
        if self.frame_limit is not None and self.frame >= self.frame_limit:
            self.quit = True
            return
        async_display = ((self._window is not None or self._preview is not None)
                         and os.environ.get("SHADERFLOW_SYNC_DISPLAY") != "1")
        n = self._rt_batch_size(auto_ok=async_display)
        if self.frame_limit is not None:
            n = max(1, min(n, self.frame_limit - self.frame))
        self._rt_batch_active = n
        started = time.perf_counter()
        self.engine.begin_batch()
        for _ in range(n):
            self.next(dt=dt / n)
        dispatched = self.engine.flush(n)
        if async_display:
            # Until the display pump has moved its first frame (its stream
            # and page-locked buffers are made then), and on a tick that
            # compiled a kernel, the tick measures set-up, not the loop: the
            # controller must not size batches from it
            warm = self._display_pump is not None and self._display_pump.transferred > 0
            self._async_display_frame(dispatched)
            if warm and not self.engine.last_flush_retraced:
                self._rt_batch_feedback(time.perf_counter() - started, n)
            return
        # Synchronous display (SHADERFLOW_SYNC_DISPLAY=1, and headless): show
        # frame k - depth while the device renders frame k; every frame is
        # shown, paced by the transfer. Depth 1 is the GL swapchain's
        # double buffer; SHADERFLOW_PREVIEW_DEPTH raises it
        depth = max(1, int(os.environ.get("SHADERFLOW_PREVIEW_DEPTH", "1")))
        self._pending_preview.append((dispatched, self._rendered()))
        if len(self._pending_preview) <= depth:
            return
        frames, done = self._pending_preview.pop(0)
        if self._window is not None:
            frame = fetch_frame(frames[-1])
            if self.render_ui:
                frame = self._draw_hud(frame.copy())
            self._window.show(frame)
            self._dispatch_window_events(self._window.poll())
        elif self._preview is not None:
            cv2 = self._preview
            frame = fetch_frame(frames[-1])
            if self.render_ui:
                frame = self._draw_hud(frame.copy())
            cv2.imshow(self.title, frame[..., ::-1])
            self._poll_input(cv2.waitKey(1) & 0xFF)
        elif done is not None:
            done.synchronize()   # headless: wait for frame k - depth, for honest pacing

    # Realtime micro-batching: where one launch's dispatch costs more than
    # a frame period (a remote-attached device), N frames a launch amortize
    # it, at the cost of sampling input once per launch. "auto" starts at 1
    # and grows only while the measured loop cost misses the budget.

    def _rt_batch_size(self, auto_ok: bool) -> int:
        setting = os.environ.get("SHADERFLOW_RT_BATCH", "auto")
        if setting.isdigit():
            return max(1, int(setting))
        if not auto_ok:
            return 1
        return max(1, self._rt_batch_n)

    def _rt_batch_feedback(self, call_seconds: float, n: int) -> None:
        """Adapt the auto micro-batch size from the measured loop cost
        (dispatch and display offer; transfers never block the loop). Three
        consecutive ticks over budget jump N to the predicted size; three
        under 35 % of it halve N."""
        if os.environ.get("SHADERFLOW_RT_BATCH", "auto") != "auto":
            return
        per_frame = call_seconds / max(1, n)
        period = 1.0 / max(1e-6, self.fps)
        ema = per_frame if self._rt_cost_ema is None else self._rt_cost_ema
        ema += 0.25 * (per_frame - ema)
        self._rt_cost_ema = ema
        streak = self._rt_streak
        if ema > 1.05 * period:
            streak = max(1, streak + 1)
        elif ema < 0.35 * period:
            streak = min(-1, streak - 1)
        else:
            streak = 0
        self._rt_streak = streak
        current = max(1, self._rt_batch_n)
        new = current
        if streak >= 3 and current < self._RT_BATCH_MAX:
            # One step to the predicted size: the needed size scales with
            # the miss ratio (next power of two)
            factor = 2 ** max(1, math.ceil(math.log2(ema / period)))
            new = min(self._RT_BATCH_MAX, current * int(factor))
        elif streak <= -3 and current > 1:
            new = current // 2
        if new != current:
            self._rt_batch_n = new
            self._rt_streak = 0
            if self.vsync is not None:
                self.vsync.frequency = self.fps / new
            logger.info(f"Realtime micro-batch -> {new} frames/launch "
                        f"(loop {ema * 1e3:.1f} ms/frame vs {period * 1e3:.1f} ms budget)")

    def _async_display_frame(self, dispatched: torch.Tensor) -> None:
        """The windowed display path: never block the loop on the
        device->host frame transfer (io/displaypump.py, latest frame
        wins). Input is polled every tick. At most three undrained launches
        before the loop waits for the oldest (a swapchain's depth)."""
        if self._display_pump is None:
            from shaderflow_tpu_torch.io.displaypump import DisplayPump
            self._display_pump = DisplayPump()
            self._display_pump.reserve(dispatched[-1])
            self._inflight_rt = []
        self._inflight_rt.append((dispatched, self._rendered()))
        while len(self._inflight_rt) > 3:
            _, done = self._inflight_rt.pop(0)
            if done is not None:
                done.synchronize()
        self._display_pump.offer(dispatched, tag=self._frame_counter - 1)
        frame = self._display_pump.take()
        if frame is not None:
            # The pump may stride a frame on slow links: the window blits it
            # scaled, and the HUD's hit map is in this frame's pixels. The
            # HUD draws on a copy, never into the pump's page-locked slot
            self._shown_frame_size = (frame.shape[1], frame.shape[0])
            if self.render_ui:
                frame = self._draw_hud(frame.copy())
        if self._window is not None:
            if frame is not None:
                self._window.show(frame)
            self._dispatch_window_events(self._window.poll())
        else:
            cv2 = self._preview
            if frame is not None:
                cv2.imshow(self.title, frame[..., ::-1])
            self._poll_input(cv2.waitKey(1) & 0xFF)

    def _dispatch_window_events(self, events: list) -> None:
        """Window events -> message relays (the reference's glfw callback
        surface: key press and release, unicode, mouse move / press /
        release / wheel with the Ctrl, Alt and exclusive drag intercepts,
        resize, file drop, enter, iconify, close). A left press on the HUD
        panel, the drag it starts and the wheel over the panel go to the
        HUD (_hud_mouse) and relay nothing."""
        Mouse = ShaderMessage.Mouse
        Keyboard = ShaderMessage.Keyboard

        def frame_xy(x: int, y: int) -> tuple[int, int]:
            # Window pixels -> the shown frame's pixels (a resized window,
            # a strided frame: both blit scaled), where the HUD's rows are
            if self._window is None:
                return x, y
            ww, wh = self._window.size
            fw, fh = self._shown_frame_size or self.resolution
            return (int(x * fw / max(1, ww)), int(y * fh / max(1, wh)))

        for event in events:
            kind = event[0]
            if kind == "keydown":
                key = event[1]
                if key == ShaderKeyboard.Keys.ESCAPE:
                    self.quit = True
                self.relay(Keyboard.KeyDown(key=key))
            elif kind == "keyup":
                self.relay(Keyboard.KeyUp(key=event[1]))
            elif kind == "unicode":
                self.relay(Keyboard.Unicode(char=event[1]))
            elif kind == "mousemove":
                _, x, y, dx, dy, held = event
                self._mouse_xy = (x, y)
                u, v = self._pixel_to_gluv(x, y)
                du = u - self.mouse_gluv[0]
                dv = v - self.mouse_gluv[1]
                self.mouse_inside = True
                if self._hud_dragging and held:
                    self._hud_mouse("drag", *frame_xy(x, y), dx=dx, dy=dy)
                elif 1 in held or 2 in held:
                    self._handle_drag(x=x, y=y, dx=dx, dy=dy, u=u, v=v, du=du, dv=dv)
                else:
                    self.relay(Mouse.Position(x=x, y=y, dx=dx, dy=dy,
                                              u=u, v=v, du=du, dv=dv))
            elif kind in ("mousedown", "mouseup"):
                _, button, x, y = event
                state = kind == "mousedown"
                if state and button == 1 and self._hud_mouse("press", *frame_xy(x, y)):
                    self._hud_dragging = True
                    continue
                if not state and button == 1 and self._hud_dragging:
                    # Only the left release ends (and is taken by) a HUD
                    # drag: another button's release still relays
                    self._hud_dragging = False
                    continue
                self.mouse_buttons[button] = state
                u, v = self._pixel_to_gluv(x, y)
                cls = Mouse.Press if state else Mouse.Release
                self.relay(cls(button=button, x=x, y=y, u=u, v=v))
            elif kind == "wheel":
                step = float(event[1])
                mx, my = self._mouse_xy
                if mx >= 0 and self._hud_mouse("wheel", *frame_xy(mx, my), dy=int(step)):
                    continue
                self.relay(Mouse.Scroll(dy=int(step), dv=step / 10))
            elif kind == "resize":
                _, width, height = event
                self.resize(width=width, height=height)
                self.relay(ShaderMessage.Window.Resize(width=width, height=height))
            elif kind == "drop":
                self.relay(ShaderMessage.Window.FileDrop(files=[event[1]]))
            elif kind == "enter":
                self.mouse_inside = bool(event[1])
                self.relay(Mouse.Enter(state=bool(event[1])))
            elif kind == "iconify":
                self.relay(ShaderMessage.Window.Iconify(state=bool(event[1])))
            elif kind == "close":
                self.relay(ShaderMessage.Window.Close())

    _mouse_drag_time_factor: float = 4.0
    """Seconds scrubbed when an Alt+drag travels the full window height."""

    def _handle_drag(self, *, x: int, y: int, dx: int, dy: int,
                     u: float, v: float, du: float, dv: float) -> None:
        """Mouse drags with the reference's modifier intercepts: Ctrl+drag
        rolls the camera around its forward axis, exclusive mode free-looks
        (zoom and roll), Alt+drag scrubs time; otherwise the Drag message
        relays to every module."""
        width, height = self.resolution
        if self.keyboard(ShaderKeyboard.Keys.LEFT_CTRL):
            cx, cy = (x - width / 2), (y - height / 2)
            angle = math.atan2(cy + dy, cx + dx) - math.atan2(cy, cx)
            if abs(angle) > math.pi:
                angle -= 2 * math.pi
            self.camera.rotate(self.camera.forward, degrees=math.degrees(angle))
            return
        if self.exclusive:
            self.camera.apply_zoom(dy / 500)
            self.camera.rotate(self.camera.forward, degrees=-dx / 10)
            return
        if self.keyboard(ShaderKeyboard.Keys.LEFT_ALT):
            self.time -= self._mouse_drag_time_factor * (dy / max(1, height))
            return
        self.relay(ShaderMessage.Mouse.Drag(x=x, y=y, dx=dx, dy=dy,
                                            u=u, v=v, du=du, dv=dv))

    def _pixel_to_gluv(self, x: int, y: int) -> tuple[float, float]:
        """Window pixel -> gluv: x in [-aspect, aspect], y in [-1, 1], v up."""
        width, height = self.resolution
        u = (2.0 * ((x + 0.5) / max(1, width)) - 1.0) * self.aspect_ratio
        v = 1.0 - 2.0 * ((y + 0.5) / max(1, height))
        return (u, v)

    # ------------------------------------------------------------------ #
    # The cv2 preview's input

    def _poll_input(self, waitkey_code: int, now: Optional[float] = None) -> None:
        """The cv2 preview's keys, once a frame: the X11 keymap's exact
        transitions (Shift, Ctrl and Alt included) where it is active, else
        waitKey's autorepeat codes (lowercase letters to the key table,
        repeats dropped, a release synthesized when the train goes quiet,
        no modifiers)."""
        Keyboard = ShaderMessage.Keyboard
        keymap = self._keymap
        if keymap is not None and keymap.active:
            downs, ups = keymap.poll()
            for code in downs:
                if code == ShaderKeyboard.Keys.ESCAPE:
                    self.quit = True
                self.relay(Keyboard.KeyDown(key=code))
            for code in ups:
                self.relay(Keyboard.KeyUp(key=code))
            return
        now = time.monotonic() if now is None else now
        if self._autorelease is None:
            from shaderflow_tpu_torch.io.x11keys import AutoReleaseKeys
            self._autorelease = AutoReleaseKeys()
        key = waitkey_code
        if key == 27:  # ESC
            self.quit = True
        elif key != 255:
            if ord("a") <= key <= ord("z"):
                key -= 32  # the key table is uppercase; waitKey gives ASCII
            if self._autorelease.feed(key, now):
                self.relay(Keyboard.KeyDown(key=key))
        for code in self._autorelease.poll(now):
            self.relay(Keyboard.KeyUp(key=code))

    def _cv2_mouse_event(self, event: int, x: int, y: int, flags: int, param=None) -> None:
        """The cv2 preview's mouse callback -> message relays (press and
        release of three buttons, moves, drags, the wheel), the HUD's
        panel first."""
        cv2 = self._preview
        if cv2 is None:
            return
        u, v = self._pixel_to_gluv(x, y)
        du, dv = u - self.mouse_gluv[0], v - self.mouse_gluv[1]
        Mouse = ShaderMessage.Mouse
        self.mouse_inside = True
        buttons = {cv2.EVENT_LBUTTONDOWN: (1, True), cv2.EVENT_LBUTTONUP: (1, False),
                   cv2.EVENT_RBUTTONDOWN: (2, True), cv2.EVENT_RBUTTONUP: (2, False),
                   cv2.EVENT_MBUTTONDOWN: (3, True), cv2.EVENT_MBUTTONUP: (3, False)}
        if event in buttons:
            button, state = buttons[event]
            if state and button == 1 and self._hud_mouse("press", x, y):
                self._hud_dragging = True
                return
            if not state and button == 1 and self._hud_dragging:
                self._hud_dragging = False
                return
            self.mouse_buttons[button] = state
            cls = Mouse.Press if state else Mouse.Release
            self.relay(cls(button=button, x=x, y=y, u=u, v=v))
        elif event == cv2.EVENT_MOUSEMOVE:
            if self._hud_dragging:
                dx = int(round((du / 2 / max(1e-9, self.aspect_ratio)) * self.resolution[0]))
                self._hud_mouse("drag", x, y, dx=dx)
            elif self.mouse_buttons.get(1) or self.mouse_buttons.get(2):
                dx = int(round((du / 2 / max(1e-9, self.aspect_ratio)) * self.resolution[0]))
                dy = int(round((-dv / 2) * self.resolution[1]))
                self._handle_drag(x=x, y=y, dx=dx, dy=dy, u=u, v=v, du=du, dv=dv)
            else:
                self.relay(Mouse.Position(x=x, y=y, u=u, v=v, du=du, dv=dv))
        elif event == getattr(cv2, "EVENT_MOUSEWHEEL", -1):
            step = 1.0 if flags > 0 else -1.0
            self.relay(Mouse.Scroll(dy=int(step), dv=step / 10))

    # ------------------------------------------------------------------ #
    # The HUD (TAB): module panels drawn over the shown frame

    _HUD_WIDTH = 420      # the panel's hit width, frame pixels
    _HUD_ROW0 = 6         # the first row's top edge
    _HUD_ROWH = 16        # row pitch (the putText layout)
    _HUD_PLOT_ROWS = 3    # text rows a sparkline strip takes

    def _ui_panels(self) -> list:
        """The HUD's panels in order: every module, the scene's own panel
        (speed, quality, ssaa) last."""
        return [m for m in self.modules if m is not self] + [self]

    def _ui_selected_module(self):
        panels = self._ui_panels()
        return panels[self._ui_index % len(panels)] if panels else None

    def ui(self) -> list[str]:
        return [f"backend={self.backend.value}  quality={self.quality:.0f}",
                f"exclusive={self.exclusive}  fullscreen={self.fullscreen}"]

    def ui_fields(self) -> list:
        from shaderflow_tpu_torch.module import UIField
        return [
            UIField("speed", lambda: self.speed, lambda v: setattr(self, "speed", v),
                    step=0.1, fmt="{:+.2f}"),
            UIField("quality", lambda: self.quality, lambda v: setattr(self, "quality", v),
                    step=5.0, minimum=0.0, maximum=100.0, fmt="{:.0f}"),
            # The ssaa property's setter (not resize(ssaa=)): it relays
            # RecreateTextures and invalidates the engine, which resize()
            # skips when the output size is unchanged
            UIField("ssaa", lambda: self.ssaa, lambda v: setattr(self, "ssaa", v),
                    step=0.25, minimum=0.25, maximum=4.0, fmt="{:.2f}"),
        ]

    def _ui_nudge(self, direction: float) -> None:
        """Nudge the selected panel's selected field by its step (Shift
        x10, Ctrl x0.1)."""
        module = self._ui_selected_module()
        fields = module.ui_fields() if module is not None else []
        if not fields:
            return
        field = fields[self._ui_field_index % len(fields)]
        scale = 1.0
        if self.keyboard(ShaderKeyboard.Keys.LEFT_SHIFT):
            scale = 10.0
        elif self.keyboard(ShaderKeyboard.Keys.LEFT_CTRL):
            scale = 0.1
        value = field.nudge(direction, scale)
        logger.info(f"(-/+) {type(module).__name__} {field.label} -> {value:g}")

    def _draw_hud(self, frame: np.ndarray) -> np.ndarray:
        """The HUD over an (H, W, 3) uint8 host frame, in place: the scene's
        sizes, time and rates, the module list with the selected panel
        expanded (its ui() lines, ui_fields() rows, ui_plots() sparklines)
        on a darkened box. Text through cv2 where it is installed, else
        pygame.font; whichever window shows the frame."""
        lines = [
            (f"{self.name}  {self.render_resolution} -> {self.resolution} "
             f"@ {self.ssaa:.2f}x SSAA", None),
            (f"t={self.time:6.2f}s  frame={self.frame}  speed={self.speed:.2f}", None),
            (f"fps avg {self.frametimer.framerate_average():6.1f}  "
             f"min {self.frametimer.framerate_minimum:6.1f}  target {self.fps:.0f}", None),
        ]
        # Each row carries its mouse action: a module row selects its
        # panel, a field row its field
        panels = self._ui_panels()
        selected = panels[self._ui_index % len(panels)] if panels else None
        plot_strips: list[tuple] = []  # (first row, values, lo, hi)
        for module_index, module in enumerate(panels):
            marker = ">" if module is selected else " "
            label = "Scene" if module is self else type(module).__name__
            lines.append((f" {marker}{module.uuid:>2} {label}"
                          + (f" ({module.name})" if module.name else ""),
                          ("module", module_index)))
            if module is not selected:
                continue
            try:
                for panel_line in module.ui() or []:
                    lines.append((f"      {panel_line}", None))
                fields = module.ui_fields()
                for index, field in enumerate(fields):
                    edit = "*" if index == self._ui_field_index % len(fields) else " "
                    lines.append((f"     {edit}{field.render()}   (-/+ or drag)",
                                  ("field", index)))
                # A sparkline: a label row and a strip of rows drawn after the text
                for plot in module.ui_plots() or []:
                    values = np.asarray(list(plot.values), np.float32)
                    if values.size < 2:
                        continue
                    lo = plot.lo if plot.lo is not None else float(values.min())
                    hi = plot.hi if plot.hi is not None else float(values.max())
                    lines.append((f"      {plot.label}  [{values[-1]:.3g}]  {lo:.3g}..{hi:.3g}",
                                  None))
                    plot_strips.append((len(lines), values, lo, hi))
                    lines.extend([("", None)] * self._HUD_PLOT_ROWS)
            except Exception as error:
                lines.append((f"      ui() error: {error}", None))
        lines = lines[:28]
        plot_strips = [(row, v, lo, hi) for row, v, lo, hi in plot_strips
                       if row + self._HUD_PLOT_ROWS <= len(lines)]
        # The hit map: row i spans y in [ROW0 + ROWH i, ROW0 + ROWH (i + 1))
        # at x < _HUD_WIDTH (_hud_mouse)
        self._hud_rows = [action for _, action in lines]
        y1 = min(frame.shape[0], self._HUD_ROW0 + self._HUD_ROWH * len(lines) + 6)
        x1 = min(frame.shape[1], self._HUD_WIDTH)
        frame[:y1, :x1] = frame[:y1, :x1] // 2
        try:
            import cv2
            for index, (text, _) in enumerate(lines):
                cv2.putText(frame, text, (8, 18 + 16 * index), cv2.FONT_HERSHEY_SIMPLEX,
                            0.42, (0, 0, 0), 2, cv2.LINE_AA)
                cv2.putText(frame, text, (8, 18 + 16 * index), cv2.FONT_HERSHEY_SIMPLEX,
                            0.42, (255, 255, 255), 1, cv2.LINE_AA)
        except ImportError:
            from shaderflow_tpu_torch.io.sdlwindow import SDLWindow
            SDLWindow.draw_text(frame, [text for text, _ in lines],
                                origin=(8, self._HUD_ROW0), pitch=self._HUD_ROWH)
        for row, values, lo, hi in plot_strips:
            self._raster_plot(frame, row, values, lo, hi)
        return frame

    def _raster_plot(self, frame: np.ndarray, row: int, values: np.ndarray,
                     lo: float, hi: float) -> None:
        """One sparkline strip into the HUD (numpy only)."""
        y0 = self._HUD_ROW0 + self._HUD_ROWH * row + 2
        height = self._HUD_ROWH * self._HUD_PLOT_ROWS - 6
        x0, width = 14, min(self._HUD_WIDTH - 28, frame.shape[1] - 14)
        if y0 + height > frame.shape[0] or width < 8:
            return
        strip = frame[y0:y0 + height, x0:x0 + width]
        strip //= 2  # darkened twice: the plot's bed reads against the box
        columns = np.interp(np.linspace(0, values.size - 1, width),
                            np.arange(values.size), values)
        span = (hi - lo) or 1.0
        ys = np.clip(((hi - columns) / span) * (height - 1), 0, height - 1).astype(np.int32)
        xs = np.arange(width)
        strip[ys, xs] = 255
        strip[np.clip(ys + 1, 0, height - 1), xs] = 255

    def _hud_mouse(self, kind: str, x: int, y: int, dx: int = 0, dy: int = 0) -> bool:
        """The mouse on the HUD's panel, in frame pixels: a press on a
        module row opens its panel, on a field row selects the field; a
        horizontal drag or the wheel nudges the selected field. True when
        the panel took the event (the caller then relays nothing)."""
        rows = self._hud_rows
        if not self.render_ui or not rows:
            return False
        if x >= self._HUD_WIDTH or y < self._HUD_ROW0:
            return False
        row = (y - self._HUD_ROW0) // self._HUD_ROWH
        if row >= len(rows):
            return False
        action = rows[row]
        if kind == "press":
            if action is None:
                return True   # a press on panel text never reaches the scene
            what, index = action
            if what == "module":
                self._ui_index = index
                self._ui_field_index = 0
            else:
                self._ui_field_index = index
            return True
        if kind == "drag":
            if action is not None and action[0] == "field":
                self._ui_field_index = action[1]
            if dx:
                self._ui_nudge(1.0 if dx > 0 else -1.0)
            return True
        if kind == "wheel":
            self._ui_nudge(1.0 if dy > 0 else -1.0)
            return True
        return False

    # ------------------------------------------------------------------ #
    # Module protocol

    def handle(self, message) -> None:
        if isinstance(message, ShaderMessage.Window.Close):
            self.quit = True

        elif isinstance(message, ShaderMessage.Keyboard.KeyDown):
            keys = ShaderKeyboard.Keys
            if message.key == keys.O:
                logger.info("(O  ) Resetting the scene")
                for module in self.modules:
                    module.setup()
                self.time = 0
                if self.engine is not None:
                    self.engine.reset_carry()
            elif message.key == keys.R:
                logger.info("(R  ) Reloading shaders")
                self.relay(ShaderMessage.Shader.Compile)
            elif message.key == keys.TAB:
                self.render_ui = not self.render_ui
            elif message.key == keys.BRACKET_LEFT:
                self._ui_index -= 1
                self._ui_field_index = 0
            elif message.key == keys.BRACKET_RIGHT:
                self._ui_index += 1
                self._ui_field_index = 0
            elif message.key == keys.COMMA:
                self._ui_field_index -= 1
            elif message.key == keys.PERIOD:
                self._ui_field_index += 1
            elif message.key in (keys.MINUS, keys.EQUAL, keys.PLUS):
                # -/+ nudge the selected panel field by its step
                self._ui_nudge(-1.0 if message.key == keys.MINUS else +1.0)
            elif message.key == keys.F1:
                logger.info("(F1 ) Toggling exclusive mode")
                self.exclusive = not self.exclusive
                if self._window is not None:
                    self._window.set_exclusive(self.exclusive)
            elif message.key == keys.F2:
                from datetime import datetime

                from PIL import Image

                import shaderflow_tpu_torch
                stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
                path = (shaderflow_tpu_torch.directories.ensure().user_data_path
                        / "screenshots" / f"({stamp}) {self.name}.png")
                path.parent.mkdir(parents=True, exist_ok=True)
                logger.info(f"(F2 ) Saving screenshot to ({path})")
                Image.fromarray(self.screenshot()).save(path)
            elif message.key == keys.F11:
                logger.info("(F11) Toggling fullscreen")
                self.fullscreen = not self.fullscreen
                if self._window is not None:
                    self._window.set_fullscreen(self.fullscreen)
                elif self._preview is not None:
                    cv2 = self._preview
                    cv2.setWindowProperty(
                        self.title, cv2.WND_PROP_FULLSCREEN,
                        cv2.WINDOW_FULLSCREEN if self.fullscreen else cv2.WINDOW_NORMAL)

        elif isinstance(message, (ShaderMessage.Mouse.Drag, ShaderMessage.Mouse.Position)):
            self.mouse_gluv = (message.u, message.v)

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
