"""
ShaderTexture — a temporal x layers matrix of images.

Port of shaderflow_tpu/texture.py, the part the ported slices touch: the
(T, L, H, W, C) matrix, resolution tracking (track factor; `final` tracks
the post-SSAA output), components/dtype/temporal/layers, filter and repeat
sampling state, and the pipeline uniforms. Host writes, image uploads,
device sequences and the u8 wire twin come with the slices that stream
textures.

Unlike the reference at the time of the port, the constructor ends by
registering the module (ShaderModule.__init__): the reference's tail of
__init__ sits inside the `matrix` setter (texture.py:117-128).

Convention: arrays store row 0 = top of the image.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from shaderflow_tpu.message import ShaderMessage
from shaderflow_tpu.variable import StaticUniform
from shaderflow_tpu_torch.module import ShaderModule


class ShaderTexture(ShaderModule):

    def __init__(
        self,
        scene=None,
        name: Optional[str] = None,
        *,
        width: int = 1,
        height: int = 1,
        components: int = 4,
        dtype=np.uint8,
        temporal: int = 1,
        layers: int = 1,
        filter: str = "linear",
        repeat_x: bool = True,
        repeat_y: bool = True,
        track: Union[bool, float] = 0.0,
        final: bool = False,
        **kwargs,
    ):
        self._width = int(width)
        self._height = int(height)
        self._components = int(components)
        self._dtype = np.dtype(dtype)
        self._temporal = int(temporal)
        self._layers = int(layers)
        self.filter = filter      # "linear" or "nearest" (sampling not ported yet)
        self.repeat_x = bool(repeat_x)
        self.repeat_y = bool(repeat_y)
        self._track = float(track)
        self.final = bool(final)
        self.matrix: Optional[np.ndarray] = None  # (T, L, H, W, C) float32, row 0 = top
        self.version: int = 0     # bumped on every (re)allocation
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.make()

    # -- sampling state -----------------------------------------------------

    def repeat(self, value: bool) -> "ShaderTexture":
        self.repeat_x = self.repeat_y = bool(value)
        return self

    # -- geometry -----------------------------------------------------------

    @property
    def track(self) -> float:
        return self._track

    @track.setter
    def track(self, value: Union[bool, float]) -> None:
        self._track = float(value)
        self.make()

    @property
    def resolution(self) -> tuple[int, int]:
        """(width, height); tracking textures follow the scene resolution
        (render resolution, or the post-SSAA output when final)."""
        if not self._track:
            return (self._width, self._height)
        base = self.scene.resolution if self.final else self.scene.render_resolution
        return tuple(max(1, int(x * self._track)) for x in base)

    @resolution.setter
    def resolution(self, value: tuple[int, int]) -> None:
        if not self._track:
            width, height = value
            changed = (self._width, self._height) != (int(width), int(height))
            self._width, self._height = int(width), int(height)
            if changed:
                self.make()

    @property
    def components(self) -> int:
        return self._components

    @components.setter
    def components(self, value: int) -> None:
        if self._components != int(value):
            self._components = int(value)
            self.make()

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @dtype.setter
    def dtype(self, value) -> None:
        value = np.dtype(value)
        if self._dtype != value:
            self._dtype = value
            self.make()

    @property
    def temporal(self) -> int:
        return self._temporal

    @temporal.setter
    def temporal(self, value: int) -> None:
        if self._temporal != int(value):
            self._temporal = int(value)
            self.make()

    @property
    def layers(self) -> int:
        return self._layers

    @layers.setter
    def layers(self, value: int) -> None:
        if self._layers != int(value):
            self._layers = int(value)
            self.make()

    # -- storage ------------------------------------------------------------

    def make(self) -> "ShaderTexture":
        """(Re)allocate the host matrix when its shape changed (np.zeros:
        pages are only touched when written)."""
        width, height = self.resolution
        shape = (self._temporal, self._layers, height, width, self._components)
        if self.matrix is None or self.matrix.shape != shape:
            self.matrix = np.zeros(shape, dtype=np.float32)
        self.version += 1
        return self

    # -- module hooks -------------------------------------------------------

    def handle(self, message) -> None:
        if self._track and isinstance(message, ShaderMessage.Shader.RecreateTextures):
            self.make()

    def pipeline(self):
        if not self.name:
            return
        yield self.uniform("vec2", f"{self.name}Size", self.resolution)
        yield StaticUniform("int", f"{self.name}Layers", self._layers)
        yield StaticUniform("int", f"{self.name}Temporal", self._temporal)
