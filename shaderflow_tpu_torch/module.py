"""
ShaderModule — the lifecycle trait everything in a scene implements.

Port of shaderflow_tpu/module.py (the reference module system): a module
registers itself into its scene on construction, exposes build / setup /
update / prewarm / pipeline / handle / ffhook / duration / destroy /
load_state hooks, can relay()
messages to every module, and full_pipeline() concatenates every module's
uniforms, and register CLI commands (`commands` / `register_command`,
dispatched by cli.py as `<Scene> <command>`). The scene itself is the
first module. The realtime HUD reads each module's panel: ui() lines,
ui_fields() (UIField: an editable scalar) and ui_plots() (UIPlot: a
sparkline).
"""

from __future__ import annotations

import itertools
import logging
import weakref
from typing import TYPE_CHECKING, Any, Iterable, Optional

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.variable import ShaderVariable, Uniform

if TYPE_CHECKING:
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    from shaderflow_tpu_torch.scene import ShaderScene

_uuid_counter = itertools.count(1)


class ShaderModule:

    scene: "ShaderScene"
    name: Optional[str] = None

    def __init__(self, scene: Optional["ShaderScene"] = None, name: Optional[str] = None, **kwargs):
        from shaderflow_tpu_torch.scene import ShaderScene  # circular at import time

        self.uuid: int = next(_uuid_counter)
        if name is not None:
            self.name = name

        # The first module constructed is the scene itself
        target = scene if scene is not None else self
        if not isinstance(target, weakref.ProxyTypes):
            self.scene = weakref.proxy(target)
        else:
            self.scene = target

        if not isinstance(self.scene, ShaderScene):
            raise RuntimeError(
                f"Module of type {type(self).__name__!r} must be constructed with "
                f"{type(self).__name__}(scene=<ShaderScene instance>, ...)")

        for key, value in kwargs.items():
            setattr(self, key, value)

        self.scene.modules.append(self)
        self.commands()

        if not isinstance(self, ShaderScene):
            self.build()

    # -- lifecycle hooks ----------------------------------------------------

    def build(self) -> None:
        """Called once when the module is added to a scene."""

    def setup(self) -> None:
        """Called before every run of the main event loop (and on scene reset)."""

    def update(self) -> None:
        """Called once per frame on the host, before the batch renders."""

    def prewarm(self) -> None:
        """One-time heavy work before an export's first frame (whole-file
        audio precomputes); the scene runs it after setup and duration."""

    def pipeline(self) -> Iterable[ShaderVariable]:
        """Yield this module's uniforms for the current frame."""
        return []

    def handle(self, message: Any) -> None:
        """React to a relayed message."""

    def ffhook(self, ffmpeg: "FFmpeg") -> None:
        """Mutate the export FFmpeg command (e.g. add an audio input)."""

    def commands(self) -> None:
        """Register CLI commands on the scene launcher: override and call
        self.register_command(fn)."""

    def register_command(self, fn, name: Optional[str] = None) -> None:
        """Expose `fn` as `<Scene> <command>` on the CLI (cli.py dispatches
        commands other than 'main' here); keyword parameters become flags."""
        command = (name or fn.__name__).replace("_", "-")
        self.scene._commands[command] = fn

    def destroy(self) -> None:
        """Release resources; called when the scene is destroyed."""

    def load_state(self, state: dict) -> None:
        """Take a reference run's module state, name -> numpy array
        (engine.load_reference_state); modules that carry none refuse."""
        raise NotImplementedError(
            f"{type(self).__name__} carries no reference state ({sorted(state)})")

    @property
    def duration(self) -> float:
        """Self-reported content duration (scene runtime = max over modules)."""
        return 0.0

    # -- scene-wide operations ----------------------------------------------

    def uniform(self, type: str, name: str, value: Any) -> ShaderVariable:
        """Cached Uniform for pipeline() hot paths: one object per
        (module, name), mutated in place each frame (the capture loop reads
        .value immediately per yield). A fresh object when the type changes."""
        cache = self.__dict__.setdefault("_uniform_objects", {})
        variable = cache.get(name)
        if variable is None or variable.type != type:
            variable = Uniform(type, name, value)
            cache[name] = variable
        else:
            variable.value = value
        return variable

    def full_pipeline(self) -> Iterable[ShaderVariable]:
        for module in self.scene.modules:
            yield from module.pipeline()

    def relay(self, message: Any) -> "ShaderModule":
        if isinstance(message, type):
            message = message()
        for module in self.scene.modules:
            module.handle(message)
        return self

    def find(self, kind: type) -> Iterable["ShaderModule"]:
        """The scene's modules of type `kind`, in registration order."""
        for module in self.scene.modules:
            if isinstance(module, kind):
                yield module

    # -- logging ------------------------------------------------------------

    @property
    def who(self) -> str:
        return f"(Module {self.uuid:>2} • {type(self).__name__[:14]:<14})"

    def _log(self, level: int, args) -> str:
        """One log line, `who` then the arguments joined by spaces; returns it."""
        message = " ".join(str(x) for x in (self.who, *args))
        logger.log(level, message)
        return message

    def log_info(self, *args) -> str:
        return self._log(logging.INFO, args)

    def log_warn(self, *args) -> str:
        return self._log(logging.WARNING, args)

    def log_error(self, *args) -> str:
        return self._log(logging.ERROR, args)

    def log_debug(self, *args) -> str:
        return self._log(logging.DEBUG, args)

    def log_minor(self, *args) -> str:
        return self._log(logging.DEBUG, args)

    # -- the realtime HUD's panel -------------------------------------------

    def ui(self) -> Iterable[str]:
        """Lines of this module's HUD panel (the realtime preview: TAB
        toggles the HUD, [ and ] select the expanded panel)."""
        return []

    def ui_fields(self) -> list["UIField"]:
        """Editable scalars of this module's panel: with the panel selected,
        ',' / '.' select a field and '-' / '+' nudge it by its step (Shift:
        x10, Ctrl: x0.1); a drag or the wheel on its row does the same."""
        return []

    def ui_plots(self) -> list["UIPlot"]:
        """Sparklines drawn under this module's panel fields."""
        return []


class UIField:
    """One editable scalar on a module's HUD panel."""

    def __init__(self, label: str, get, set, step: float = 0.1,
                 minimum: Optional[float] = None, maximum: Optional[float] = None,
                 fmt: str = "{:+.3f}"):
        self.label = label
        self.get = get
        self.set = set
        self.step = float(step)
        self.minimum = minimum
        self.maximum = maximum
        self.fmt = fmt

    def nudge(self, direction: float, scale: float = 1.0) -> float:
        """Move the value by direction x step x scale, clamped to the
        bounds; returns the new value."""
        value = float(self.get()) + direction * self.step * scale
        if self.minimum is not None:
            value = max(self.minimum, value)
        if self.maximum is not None:
            value = min(self.maximum, value)
        self.set(value)
        return value

    def render(self) -> str:
        return f"{self.label} " + self.fmt.format(float(self.get()))


class UIPlot:
    """One sparkline on a module's HUD panel: `values` oldest to newest;
    `lo` / `hi` pin the y range (None: the values' own)."""

    def __init__(self, label: str, values, lo: Optional[float] = None,
                 hi: Optional[float] = None):
        self.label = label
        self.values = values
        self.lo = lo
        self.hi = hi
