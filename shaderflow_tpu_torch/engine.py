"""
The batched render engine: host-captured uniforms -> a loop of frames on
one CUDA stream -> one (F, H, W, 3) uint8 batch on the device.

Port of shaderflow_tpu/engine.py. The host advances module state frame by
frame and captures each frame's uniforms (capture_frame); flush() packs a
batch's uniforms into one (F, K) float32 matrix, copies it to the device
once, and renders every frame in a Python loop (the reference's lax.scan):
the main program's fragment returns a TailSpec, and kernel K1 writes the
frame's u8 pixels straight into its slot of a preallocated batch tensor.
Per-frame uniforms are 0-d / 1-d views of the device matrix, so the loop
never waits on the device (no .item(), float() or bool() of device
values); statics (program-specializing uniforms) are host values.

Ported: one main program (temporal 1, one layer) whose fragment returns a
TailSpec or an (H, W, C) render, and the SSAA final pass. Not yet: temporal
feedback carries, multipass programs and texture samplers, batch preludes,
device sequences, streamed textures, frame/row sharding over devices.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from shaderflow_tpu import logger
from shaderflow_tpu_torch.ops import tailfuse
from shaderflow_tpu_torch.ops.downsample import final_pass
from shaderflow_tpu_torch.shader import Frag, ShaderProgram, finish_coords, make_coords
from shaderflow_tpu_torch.texture import ShaderTexture

if TYPE_CHECKING:
    from shaderflow_tpu_torch.scene import ShaderScene


class WireBatch:
    """A frame batch staged for host delivery. On the card, the
    device->host copy into pinned memory is enqueued right behind the
    batch's compute, so it overlaps the host's capture of the next batch;
    fetch() waits for it. With host=False only completion is tracked
    (NullSink: frames never leave the device)."""

    def __init__(self, frames: torch.Tensor, host: bool = True):
        self.frames = frames    # keeps the device batch alive until drained
        self.shape = tuple(frames.shape)
        self.host: Optional[torch.Tensor] = frames if frames.device.type == "cpu" else None
        self.done: Optional[torch.cuda.Event] = None
        if frames.device.type == "cuda":
            if host:
                self.host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
                self.host.copy_(frames, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(frames.device))

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()

    def fetch(self) -> np.ndarray:
        if self.host is None:
            raise ValueError("WireBatch staged without a host copy")
        self.wait()
        return self.host.numpy()


def to_wire(frames: torch.Tensor, host: bool = True) -> WireBatch:
    """Stage a (F, H, W, 3) u8 batch for host delivery (see WireBatch)."""
    return WireBatch(frames, host=host)


def fetch_frame(frame: torch.Tensor) -> np.ndarray:
    """One (H, W, 3) frame on the host (screenshots, previews)."""
    return frame.cpu().numpy()


class FrameUniforms(Mapping):
    """One frame's uniforms, unpacked lazily from its row of the batch's
    packed device matrix. spec entries are (name, offset, size, kind,
    shape); kinds 'i' (int, exact below 2^24) and 'b' (bool) round back to
    int32 on the device — nothing is read back to the host."""

    def __init__(self, row: torch.Tensor, spec: tuple):
        self._row = row
        self._spec = {entry[0]: entry for entry in spec}
        self._values: dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._values:
            _, offset, size, kind, shape = self._spec[name]
            value = self._row[offset:offset + size]
            value = value.reshape(shape) if shape else value[0]
            if kind in ("i", "b"):
                value = torch.round(value).to(torch.int32)
            self._values[name] = value
        return self._values[name]

    def __contains__(self, name) -> bool:
        return name in self._spec

    def __iter__(self):
        return iter(self._spec)

    def __len__(self) -> int:
        return len(self._spec)


class RenderEngine:

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.stale = True
        self._statics: dict[str, Any] = {}
        self._uniform_kinds: dict[str, str] = {}
        self._coords = None
        self._render_size: tuple[int, int] = (0, 0)
        # Per-batch capture state
        self._frame_uniforms: list[dict[str, np.ndarray]] = []

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def invalidate(self) -> None:
        self.stale = True

    # ------------------------------------------------------------------ #
    # Inventory

    def _programs(self) -> list[ShaderProgram]:
        """Render order: reverse module-addition order, final excluded."""
        programs = [m for m in self.scene.modules
                    if isinstance(m, ShaderProgram) and m is not self.scene._final]
        return programs[::-1]

    def _external_textures(self) -> dict[str, ShaderTexture]:
        """Named textures not owned by a program (images, audio, video)."""
        owned = {id(p.texture) for p in self._programs()} | {id(self.scene._final.texture)}
        return {m.name: m for m in self.scene.modules
                if isinstance(m, ShaderTexture) and m.name and id(m) not in owned}

    # ------------------------------------------------------------------ #
    # Build

    def build(self) -> None:
        scene = self.scene
        programs = self._programs()
        if len(programs) != 1:
            raise NotImplementedError(
                f"{len(programs)} programs: multipass scenes (texture samplers "
                "between programs) are not ported yet; one main program is")
        texture = programs[0].texture
        if texture.temporal != 1 or texture.layers != 1:
            raise NotImplementedError(
                f"Program {programs[0].name!r} temporal={texture.temporal} "
                f"layers={texture.layers}: temporal feedback and multi-layer "
                "programs are not ported yet")
        externals = self._external_textures()
        if externals:
            raise NotImplementedError(
                f"Textures {sorted(externals)}: host-written, streamed and "
                "sequence textures are not ported yet")
        if getattr(scene, "batch_preludes", None):
            raise NotImplementedError("Batch preludes are not ported yet")

        self._statics = {v.name: v.value for v in scene.full_pipeline()
                         if v.static and v.value is not None}
        width, height = texture.resolution
        self._render_size = (height, width)
        # Coordinate flavors live for the build (one size, one device)
        self._coords = make_coords(height, width, scene.aspect_ratio, self.device)
        self.stale = False
        out_width, out_height = scene._final.texture.resolution
        logger.debug(f"Engine built: render {width}x{height} -> output "
                     f"{out_width}x{out_height} subsample {scene.subsample} "
                     f"on {self.device}")

    # ------------------------------------------------------------------ #
    # Batch capture (host side, per frame)

    def begin_batch(self) -> None:
        if self.stale:
            self.build()
        self._frame_uniforms = []

    def capture_frame(self) -> None:
        """Snapshot the current frame's uniforms. Called after the scene ran
        every module's update() for this frame."""
        uniforms: dict[str, np.ndarray] = {}
        statics_changed = False
        for variable in self.scene.full_pipeline():
            if variable.value is None:
                continue
            if variable.static:
                if self._statics.get(variable.name) != variable.value:
                    statics_changed = True
                continue
            if variable.type == "sampler2D":
                continue
            uniforms[variable.name] = variable.coerce()
            self._uniform_kinds[variable.name] = (
                "i" if variable.type == "int" else
                "b" if variable.type == "bool" else "f")
        if statics_changed:
            # A static changed mid-run: the next flush rebuilds around it
            self.invalidate()
        self._frame_uniforms.append(uniforms)

    # ------------------------------------------------------------------ #
    # Flush: render the captured frames

    def stack_captures(self, count: Optional[int] = None):
        """Pack the captured per-frame uniforms into one (F, K) float32
        matrix (one host->device copy per batch) plus a static unpack spec.
        A uniform missing from some frames fills from the nearest earlier
        frame that has it (else the first one that does)."""
        count = count if count is not None else len(self._frame_uniforms)
        frames = self._frame_uniforms[:count]
        names = sorted(set().union(*(frame.keys() for frame in frames)))
        first_value = {}
        for frame in frames:
            for name, value in frame.items():
                first_value.setdefault(name, value)
        spec = []
        offset = 0
        for name in names:
            value = np.asarray(first_value[name])
            size = int(value.size)
            shape = value.shape if value.ndim else ()
            spec.append((name, offset, size, self._uniform_kinds.get(name, "f"), shape))
            offset += size
        packed = np.empty((len(frames), offset), np.float32)
        last = dict(first_value)
        for row, frame in enumerate(frames):
            position = 0
            for name in names:
                raw = frame.get(name)
                if raw is None:
                    raw = last[name]
                else:
                    last[name] = raw
                value = np.asarray(raw, np.float32).reshape(-1)
                packed[row, position:position + value.size] = value
                position += value.size
        return packed, tuple(spec)

    def flush(self, count: Optional[int] = None) -> Optional[torch.Tensor]:
        """Render the captured frames -> (F, H, W, 3) uint8 on the device.
        Work is enqueued on the current stream; nothing waits for it."""
        count = count if count is not None else len(self._frame_uniforms)
        if count == 0:
            return None
        if self.stale:
            # A static changed during capture: rebuild; captures stay valid
            self.build()
        packed, spec = self.stack_captures(count)
        packed = torch.from_numpy(packed)
        if self.device.type == "cuda":
            packed = packed.pin_memory().to(self.device, non_blocking=True)

        scene = self.scene
        out_width, out_height = scene._final.texture.resolution
        frames = torch.empty((count, out_height, out_width, 3), dtype=torch.uint8,
                             device=self.device)
        program = self._programs()[0]
        render_h, render_w = self._render_size
        subsample = int(scene.subsample)
        aspect = scene.aspect_ratio
        statics = {**self._statics, "iLayer": 0}
        for index in range(count):
            uniforms = FrameUniforms(packed[index], spec)
            ctx = Frag(coords=finish_coords(self._coords, uniforms["iResolution"]),
                       uniforms=uniforms, statics=statics)
            out = program.render_layer(ctx)
            if isinstance(out, tailfuse.TailSpec):
                # The main program's tail fuses with the final pass: its
                # texture is never materialized
                tailfuse.run_tail_final(out, render_h, render_w, out_height,
                                        out_width, subsample, aspect,
                                        out=frames[index])
            else:
                frames[index].copy_(final_pass(out, out_height, out_width, subsample))
        return frames
