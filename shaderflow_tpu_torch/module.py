"""
ShaderModule — the lifecycle trait everything in a scene implements.

Port of shaderflow_tpu/module.py (the reference module system): a module
registers itself into its scene on construction, exposes build / setup /
update / prewarm / pipeline / handle / ffhook / duration / destroy /
load_state hooks, can relay()
messages to every module, and full_pipeline() concatenates every module's
uniforms. The scene itself is the first module. The realtime HUD hooks and
CLI commands are not ported yet.
"""

from __future__ import annotations

import itertools
import weakref
from typing import TYPE_CHECKING, Any, Iterable, Optional

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

