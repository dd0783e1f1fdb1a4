"""
ShaderTexture — a temporal x layers matrix of images.

Port of shaderflow_tpu/texture.py, the part the ported slices touch: the
(T, L, H, W, C) float32 host matrix, resolution tracking (track factor;
`final` tracks the post-SSAA output), components/dtype/temporal/layers,
filter and repeat sampling state, host writes and image uploads, device
sequences (per-frame content the engine indexes by frame, optionally as a
ring of the last L columns), and the pipeline uniforms. The engine uploads
a host-written texture once per version; textures rewritten every frame
(streamed textures, the u8 wire twin) are not ported yet.

Differences from the reference at the time of the port, each a repair:
  * the constructor ends by registering the module (ShaderModule.__init__);
    the reference's tail of __init__ sits inside the `matrix` setter
  * read() returns a copy: a caller mutating it cannot desync the matrix
    from what the engine uploaded
  * write() checks its temporal/layer box and viewport against the matrix
    and raises instead of writing another box or clipping silently

Convention: arrays store row 0 = top of the image; GL writes go bottom-up,
so write() flips them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.variable import StaticUniform
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
        self.filter = filter
        self.repeat_x = bool(repeat_x)
        self.repeat_y = bool(repeat_y)
        self._track = float(track)
        self.final = bool(final)
        self.matrix: Optional[np.ndarray] = None  # (T, L, H, W, C) float32, row 0 = top
        self.version: int = 0     # bumped on every (re)allocation and write
        self.dirty: bool = False  # written since the engine last uploaded it
        self.sequence = None
        """Per-frame device content (F, H, W, C) (offline audio paths): the
        engine indexes it by frame instead of uploading host writes."""
        self.sequence_window: Optional[int] = None  # ring window L (set_sequence)
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.make()

    # -- sampling state -----------------------------------------------------

    @property
    def filter(self) -> str:
        return self._filter

    @filter.setter
    def filter(self, value: str) -> None:
        value = getattr(value, "value", value)  # accept enum-likes
        if value not in ("linear", "nearest"):
            raise ValueError(f"Unknown texture filter {value!r}")
        self._filter = value

    @property
    def linear(self) -> bool:
        return self._filter == "linear"

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
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def size(self) -> tuple[int, int]:
        return self.resolution

    @size.setter
    def size(self, value: tuple[int, int]) -> None:
        self.resolution = value

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
        # the reference's moderngl names: f1 / u1 bytes, f2 half, f4 float
        value = {"f1": np.uint8, "u1": np.uint8, "f2": np.float16,
                 "f4": np.float32}.get(value, value) if isinstance(value, str) else value
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

    # -- input / output -----------------------------------------------------

    def _box(self, temporal: int, layer: int) -> tuple[int, int]:
        """A (temporal, layer) box index, negative from the end, checked."""
        if not (-self._temporal <= temporal < self._temporal
                and -self._layers <= layer < self._layers):
            raise IndexError(
                f"Texture {self.name!r}: box (temporal={temporal}, layer={layer}) "
                f"outside its {self._temporal} x {self._layers} matrix")
        return temporal % self._temporal, layer % self._layers

    @staticmethod
    def _normalize(data) -> np.ndarray:
        """Incoming data in sample space (float32; u8 -> [0, 1])."""
        data = np.asarray(data)
        if data.dtype == np.uint8:
            return data.astype(np.float32) / 255.0
        return data.astype(np.float32)

    def write(
        self,
        data=None,
        *,
        temporal: int = 0,
        layer: int = -1,
        viewport: Optional[tuple[int, int, int, int]] = None,
    ) -> "ShaderTexture":
        """Write pixel data into one (temporal, layer) box.

        viewport=(x, y, w, h) uses GL conventions: x from the left, y from
        the BOTTOM. data is (h, w, c), (h, w) or anything reshapeable; row 0
        of data is the bottom row of the region (GL write order)."""
        if self.matrix is None:
            self.make()
        temporal, layer = self._box(temporal, layer)
        height, width = self.matrix.shape[2], self.matrix.shape[3]
        if viewport is None:
            x, y, w, h = 0, 0, width, height
        else:
            x, y, w, h = (int(v) for v in viewport)
            if w < 0 or h < 0 or x < 0 or y < 0 or x + w > width or y + h > height:
                raise ValueError(
                    f"Texture {self.name!r}: viewport {viewport} outside its "
                    f"{width}x{height} box")
        data = self._normalize(data).reshape(h, w, self._components)
        # GL region rows are bottom-up: flip into the top-down storage
        self.matrix[temporal, layer, height - y - h:height - y, x:x + w] = data[::-1]
        self.version += 1
        self.dirty = True
        return self

    def read(self, temporal: int = 0, layer: int = -1) -> np.ndarray:
        """A copy of one box, (H, W, C) float32, row 0 = top."""
        temporal, layer = self._box(temporal, layer)
        return self.matrix[temporal, layer].copy()

    def clear(self, temporal: int = 0, layer: int = -1) -> "ShaderTexture":
        """Zero one (temporal, layer) box."""
        if self.matrix is None:
            self.make()
        height, width, components = self.matrix.shape[2:]
        return self.write(np.zeros((height, width, components), np.float32),
                          temporal=temporal, layer=layer)

    def from_numpy(self, data: np.ndarray) -> "ShaderTexture":
        """Size the texture to an image array (H, W, C) and upload it."""
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[..., None]
        height, width, components = data.shape
        self._width, self._height = width, height
        self._components = components
        self._dtype = data.dtype if data.dtype == np.uint8 else np.dtype(np.float32)
        self.make()
        self.write(np.flipud(data))  # net effect: image row 0 stays the top
        return self

    def from_image(self, image) -> "ShaderTexture":
        from PIL import Image
        if isinstance(image, (str, Path)):
            with Image.open(image) as handle:
                return self.from_numpy(np.array(handle))
        return self.from_numpy(np.array(image))

    def set_sequence(self, array, quantize: int = 256,
                     window: Optional[int] = None) -> "ShaderTexture":
        """Bind per-frame device content: an (F, H, W, C) tensor (row 0 =
        top), or None to return to host-written content. The frame axis is
        edge-padded up to a multiple of `quantize` (the engine clips its
        frame index to the last frame either way).

        window=L declares a RING sequence: `array` holds one (H, 1, C)
        column per frame, and each frame's texture is the ring of the last
        L columns, (H, L, C), in the layout the host write path of a
        scrolling texture produces."""
        if array is not None and quantize:
            frames = int(array.shape[0])
            target = -(-frames // quantize) * quantize
            if target != frames:
                pad = array[-1:].expand((target - frames,) + tuple(array.shape[1:]))
                array = torch.cat([array, pad], dim=0)
        self.sequence = array
        self.sequence_window = int(window) if (array is not None and window) else None
        if array is not None:
            self._components = int(array.shape[3])
            if not self._track:
                self._width = self.sequence_window or int(array.shape[2])
                self._height = int(array.shape[1])
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
