"""
The batched render engine: host-captured uniforms -> a loop of frames on
one CUDA stream -> one (F, H, W, 3) uint8 batch on the device.

Port of shaderflow_tpu/engine.py. The host advances module state frame by
frame and captures each frame's uniforms (capture_frame); flush() packs a
batch's uniforms into one (F, K) float32 matrix, copies it to the device
once, runs the scene's batch preludes once for the batch, and renders
every frame in a Python loop (the reference's lax.scan): the main
program's fragment returns a TailSpec, and kernel K1 writes the frame's u8
pixels straight into its slot of a preallocated batch tensor. Per-frame
uniforms are 0-d / 1-d views of the device matrix, and everything indexed
per frame (sequence rows, prelude planes) is indexed with host Python ints
taken from the captured uniforms, so the loop never waits on the device
(no .item(), float() or bool() of device values); statics
(program-specializing uniforms) are host values.

Textures not owned by a program come in two kinds:
  static    host-written (images): uploaded once, again when their version
            changes between batches
  sequence  per-frame device content (offline audio): row
            clip(iFrameIndex, 0, F - 1) each frame, or the ring of the last
            L columns for a windowed sequence
Batch preludes (scene.batch_preludes, PreludeCtx) run once per flush; a
prelude whose value has leading axis 1 is batch-invariant and cached
across batches, keyed on (name, code), the sequence signature, the render
size and the aspect.

Programs (shaderflow_tpu/engine.py:275-331, :442-492): each frame renders
every program in order (reverse module-addition order, the main program
last) and each program's layers in order, iLayer a static. A program
keeps one (T, L, H, W, C) float32 matrix; a layer's output goes into
temporal slot 0, where later layers and later programs read it through
sf.tex(name, temporal, layer). A program with temporal == 1 starts every
frame from zeros; one with temporal > 1 is carried across frames and
flushes (seeded from its host matrix at each build, so an initial
texture.write(..., temporal=k) seeds the ring) and rolls by one slot after
it renders: the roll moves the ring's origin, not its data (Ring). Only
the last program, when it has temporal == 1 and one layer, fuses a TailSpec
with the final pass; any other TailSpec is evaluated by the plain tail
into the matrix, padded to the program's components. The final pass reads
the main program's slot 1 when it is temporal (the newest box after its
roll), else slot 0.

Not yet: textures written every frame (streamed), frame/row sharding over
devices.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from shaderflow_tpu_torch import logger
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


PRELUDE_KEY = "\0prelude:"
"""Texture-name prefix under which the reference engine keeps cached
batch-invariant prelude fields (load_reference_state)."""


class Ring:
    """A program's (T, L, H, W, C) matrix as the frame loop sees it: a
    temporal ring whose slot t is data[(origin + t) % T]. roll() is
    np.roll(matrix, 1, axis=0) without moving data: slot t then holds what
    slot t - 1 held, and slot 0 the oldest box, which the next render
    overwrites."""

    def __init__(self, data: torch.Tensor, origin: int = 0):
        self.data = data
        self.origin = origin

    def slot(self, temporal: int) -> int:
        return (self.origin + temporal) % self.data.shape[0]

    def __getitem__(self, index):
        temporal, rest = (index[0], index[1:]) if isinstance(index, tuple) else (index, ())
        return self.data[(self.slot(temporal), *rest)]

    def __setitem__(self, index, value) -> None:
        temporal, rest = (index[0], index[1:]) if isinstance(index, tuple) else (index, ())
        self.data[(self.slot(temporal), *rest)] = value

    def roll(self) -> None:
        self.origin = (self.origin - 1) % self.data.shape[0]

    def ordered(self) -> torch.Tensor:
        """The matrix in slot order (a copy), as the reference holds it."""
        return torch.roll(self.data, -self.origin, dims=0)


class PreludeCtx:
    """The context handed to scene.batch_preludes functions, once per flush.

    A prelude computes, for the whole batch at once, work whose per-pixel
    indexing is frame-invariant (e.g. expanding per-frame lookup tables over
    a static index field with kernel K2). Its value's leading axis is the
    batch (frame i reads value[i]) or 1 (batch-invariant: cached across
    batches). Return None to deactivate (frames fall back to their
    per-frame formulation)."""

    def __init__(self, frames: torch.Tensor, sequences: dict, render_size: tuple,
                 aspect: float):
        self.frames = frames          # (B,) int64 frame indices on the device
        self.sequences = sequences    # name -> bound (F_pad, ...) device sequence
        self.render_size = render_size  # (H, W) of the main program
        self.aspect = aspect

    def sequence(self, name: str):
        return self.sequences.get(name)

    def rows(self, name: str):
        """Per-frame rows of a device sequence: seq[clip(frames)] -> (B, ...)."""
        seq = self.sequences.get(name)
        if seq is None:
            return None
        return seq.index_select(0, torch.clamp(self.frames, 0, seq.shape[0] - 1))


def _tensor(array) -> torch.Tensor:
    """A host array as a tensor; numpy bfloat16 (ml_dtypes) goes through its
    bits, which torch.from_numpy does not take."""
    if isinstance(array, torch.Tensor):
        return array
    array = np.ascontiguousarray(array)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def load_reference_state(scene: "ShaderScene", sequences: Optional[dict] = None,
                         textures: Optional[dict] = None,
                         modules: Optional[dict] = None) -> None:
    """Carry a reference engine's state into this scene: `sequences`
    (name -> bound (F_pad, H, W, C) arrays, ring sequences already
    front-padded) replace the module-bound sequences of the same name, and
    `textures` (name -> (T, L, H, W, C) arrays) replace static uploads;
    entries named PRELUDE_KEY + name replace that batch-invariant prelude.
    `modules` (module name -> {field: numpy array}) hands host state to
    the module of that name (ShaderModule.load_state): the piano's
    note-range replay and sequences, the camera's rotation. This system
    has no weights: precomputed sequences, textures and host module state
    are its state, so with them the render path can be held to a tight bar
    independently of FFT or host-math differences."""
    scene.initialize()
    engine = scene.engine
    engine.pinned_sequences = {name: _tensor(v) for name, v in (sequences or {}).items()}
    engine.pinned_textures = {name: _tensor(v) for name, v in (textures or {}).items()
                              if not name.startswith(PRELUDE_KEY)}
    engine.pinned_preludes = {name[len(PRELUDE_KEY):]: _tensor(v)
                              for name, v in (textures or {}).items()
                              if name.startswith(PRELUDE_KEY)}
    by_name = {module.name: module for module in scene.modules if module.name}
    for name, state in (modules or {}).items():
        if name not in by_name:
            raise KeyError(f"No module named {name!r} in the scene")
        by_name[name].load_state(state)
    engine.invalidate()


class RenderEngine:

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.stale = True
        self._statics: dict[str, Any] = {}
        self._uniform_kinds: dict[str, str] = {}
        self._coords = None                      # the main program's coordinates
        self._program_coords: list = []          # each program's, in render order
        self._render_size: tuple[int, int] = (0, 0)
        # Temporal rings carried across frames and flushes: name -> Ring
        self._carry: dict[str, Ring] = {}
        # Device textures: static uploads (name -> (T, L, H, W, C), version)
        # and bound sequences (name -> (source, bound tensor, window))
        self._static_tex: dict[str, torch.Tensor] = {}
        self._static_versions: dict[str, int] = {}
        self._sequences: dict[str, tuple] = {}
        # Batch-invariant prelude values and the state they were computed for
        self._prelude_cache: dict[str, torch.Tensor] = {}
        self._prelude_state = None
        # Reference state carried in by load_reference_state (host tensors)
        self.pinned_sequences: dict[str, torch.Tensor] = {}
        self.pinned_textures: dict[str, torch.Tensor] = {}
        self.pinned_preludes: dict[str, torch.Tensor] = {}
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
        self._static_tex.clear()
        self._static_versions.clear()
        self._sequences.clear()
        self._refresh_textures()

        self._statics = {v.name: v.value for v in scene.full_pipeline()
                         if v.static and v.value is not None}
        # Coordinate flavors live for the build (one set per render size)
        by_size: dict[tuple[int, int], Any] = {}
        self._program_coords = []
        for program in programs:
            width, height = program.texture.resolution
            if (height, width) not in by_size:
                by_size[(height, width)] = make_coords(height, width, scene.aspect_ratio,
                                                       self.device)
            self._program_coords.append(by_size[(height, width)])
        width, height = programs[-1].texture.resolution
        self._render_size = (height, width)
        self._coords = self._program_coords[-1]
        # Temporal rings start from the programs' host matrices
        self._carry = {}
        for program in programs:
            if program.texture.temporal > 1:
                if program.texture.matrix is None:
                    program.texture.make()
                self._carry[program.name] = Ring(torch.from_numpy(
                    program.texture.matrix).to(device=self.device, dtype=torch.float32))
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
        else:
            self._refresh_textures()
        self._frame_uniforms = []

    # ------------------------------------------------------------------ #
    # Textures and sequences

    def _refresh_textures(self) -> None:
        """Bind every external texture for the next batch: sequences by
        identity of the module's tensor (ring windows front-padded with L-1
        zero columns, so the window at frame 0 sees an empty history), host
        textures uploaded when their version changed."""
        device = self.device
        for name, tex in self._external_textures().items():
            if tex.sequence is not None:
                self._static_tex.pop(name, None)
                window = tex.sequence_window or 0
                bound = self._sequences.get(name)
                if bound is None or bound[0] is not tex.sequence or bound[2] != window:
                    if name in self.pinned_sequences:
                        seq = self.pinned_sequences[name].to(device)
                    else:
                        seq = tex.sequence.to(device)
                        if window > 1:
                            pad = seq.new_zeros((window - 1,) + tuple(seq.shape[1:]))
                            seq = torch.cat([pad, seq], dim=0)
                    self._sequences[name] = (tex.sequence, seq, window)
                tex.dirty = False
                continue
            self._sequences.pop(name, None)
            if name in self._static_tex and tex.version == self._static_versions.get(name):
                continue
            if name in self.pinned_textures:
                matrix = self.pinned_textures[name]
            else:
                if tex.matrix is None:
                    tex.make()
                matrix = torch.from_numpy(tex.matrix)
            self._static_tex[name] = matrix.to(device=device, dtype=torch.float32)
            self._static_versions[name] = tex.version
            tex.dirty = False

    def bound_sequences(self) -> dict[str, torch.Tensor]:
        """name -> the device sequence each frame indexes (ring-padded)."""
        return {name: bound[1] for name, bound in self._sequences.items()}

    def _frame_textures(self, frame_index: int) -> dict[str, torch.Tensor]:
        """Every texture one frame reads, (T, L, H, W, C) views: the static
        uploads and the frame's box of each sequence (row
        clip(frame_index), or the ring of the last L columns)."""
        textures = dict(self._static_tex)
        for name, (_, seq, window) in self._sequences.items():
            if window > 1:
                # The slice at k spans columns k-L+1..k (oldest first);
                # rolling by k+2 puts column k at x = (k+1) % L, the host
                # write layout of a scrolling texture
                k = min(max(frame_index, 0), seq.shape[0] - window)
                ring = torch.roll(seq[k:k + window], k + 2, dims=0)
                box = ring[:, :, 0, :].permute(1, 0, 2)
            else:
                box = seq[min(max(frame_index, 0), seq.shape[0] - 1)]
            textures[name] = box[None, None]
        return textures

    # ------------------------------------------------------------------ #
    # Batch preludes

    def _run_preludes(self, frame_indices: list[int]) -> tuple[dict, dict]:
        """Run the scene's batch preludes for one flush -> (per-batch values
        with leading axis B, batch-invariant values with leading axis 1).
        Invariant values are reused while the state they were computed for
        holds; values carried by load_reference_state take precedence."""
        functions = dict(getattr(self.scene, "batch_preludes", None) or {})
        if not functions:
            return {}, {}
        sequences = self.bound_sequences()
        # (name, __code__): scenes re-register fresh closures from the same
        # factory on every build, which share semantics by contract
        state = (tuple(sorted((name, id(getattr(fn, "__code__", fn)))
                              for name, fn in functions.items())),
                 tuple(sorted((name, tuple(seq.shape), str(seq.dtype))
                              for name, seq in sequences.items())),
                 self._render_size, self.scene.aspect_ratio, str(self.device))
        if state != self._prelude_state:
            self._prelude_state = state
            self._prelude_cache = {name: value.to(self.device)
                                   for name, value in self.pinned_preludes.items()}
        frames = torch.as_tensor(frame_indices, dtype=torch.int64).to(self.device)
        ctx = PreludeCtx(frames, sequences, self._render_size, self.scene.aspect_ratio)
        per_batch = {}
        for name, fn in functions.items():
            if name in self._prelude_cache:
                continue
            value = fn(ctx)
            if value is None:
                continue
            if value.shape[0] == 1:
                self._prelude_cache[name] = value
            elif value.shape[0] != len(frame_indices):
                raise ValueError(f"Prelude {name!r}: leading axis {value.shape[0]} "
                                 f"!= batch {len(frame_indices)}")
            else:
                per_batch[name] = value
        return per_batch, self.invariant_preludes()

    def invariant_preludes(self) -> dict[str, torch.Tensor]:
        """The cached batch-invariant prelude values (leading axis 1)."""
        functions = getattr(self.scene, "batch_preludes", None) or {}
        return {name: value for name, value in self._prelude_cache.items()
                if name in functions}

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
        for name, tex in self._external_textures().items():
            if tex.sequence is None and tex.dirty:
                raise NotImplementedError(
                    f"Texture {name!r} was written during the frame loop: "
                    "streamed textures (per-frame host writes) are not "
                    "ported yet; static uploads and device sequences are")

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

    def frame_indices(self, count: Optional[int] = None) -> list[int]:
        """iFrameIndex of each captured frame, host ints (sequence rows)."""
        frames = self._frame_uniforms[:count]
        return [int(frame["iFrameIndex"]) for frame in frames]

    def texture_meta(self) -> dict:
        """Sampler state by texture name: external and program textures."""
        return {**self._external_textures(),
                **{program.name: program.texture for program in self._programs()}}

    def frame_context(self, row: torch.Tensor, spec: tuple, step: int,
                      frame_index: int, per_batch: dict, invariant: dict,
                      coords=None, layer: int = 0, textures: Optional[dict] = None,
                      uniforms: Optional[FrameUniforms] = None) -> Frag:
        """The Frag of one frame and layer (the main program's coordinates
        and the external textures unless given): its packed uniform row on
        the device, its textures (sequence rows at frame_index), and the
        batch's prelude values (frame `step` of each per-batch stack, entry
        0 of each batch-invariant one)."""
        uniforms = uniforms if uniforms is not None else FrameUniforms(row, spec)
        coords = coords if coords is not None else self._coords
        return Frag(coords=finish_coords(coords, uniforms["iResolution"]),
                    uniforms=uniforms, statics={**self._statics, "iLayer": layer},
                    layer=layer,
                    textures=(textures if textures is not None
                              else self._frame_textures(frame_index)),
                    texture_meta=self.texture_meta(),
                    preludes={**{n: v[step] for n, v in per_batch.items()},
                              **{n: v[0] for n, v in invariant.items()}},
                    prelude_stacks={**per_batch, **invariant}, prelude_step=step)

    def carried(self) -> dict[str, torch.Tensor]:
        """The temporal rings as they stand, in slot order (copies)."""
        return {name: ring.ordered() for name, ring in self._carry.items()}

    def render_frame(self, row: torch.Tensor, spec: tuple, step: int, frame_index: int,
                     per_batch: dict, invariant: dict, out: torch.Tensor) -> None:
        """Render one frame into `out` (H, W, 3) u8: every program and
        layer in order (the module docstring), then the final pass."""
        scene = self.scene
        programs = self._programs()
        uniforms = FrameUniforms(row, spec)
        textures = self._frame_textures(frame_index)
        textures.update(self._carry)
        out_width, out_height = scene._final.texture.resolution
        subsample = int(scene.subsample)
        aspect = scene.aspect_ratio
        for program, coords in zip(programs, self._program_coords):
            texture = program.texture
            temporal, layers = texture.temporal, texture.layers
            if temporal > 1:
                matrix = self._carry[program.name]
            else:
                matrix = Ring(torch.zeros((1, layers, coords.height, coords.width,
                                           texture.components),
                                          dtype=torch.float32, device=self.device))
                textures[program.name] = matrix
            for layer in range(layers):
                ctx = self.frame_context(row, spec, step, frame_index, per_batch, invariant,
                                         coords=coords, layer=layer, textures=textures,
                                         uniforms=uniforms)
                result = program.render_layer(ctx)
                if isinstance(result, tailfuse.TailSpec):
                    if program is programs[-1] and temporal == 1 and layers == 1:
                        # The main program's tail fuses with the final pass:
                        # its texture is never materialized
                        tailfuse.run_tail_final(result, coords.height, coords.width,
                                                out_height, out_width, subsample, aspect,
                                                out=out)
                        return
                    result = tailfuse.eval_reference(result, coords.height, coords.width,
                                                     aspect)
                    if result.shape[-1] < texture.components:
                        pad = torch.ones(result.shape[:-1] + (texture.components
                                                              - result.shape[-1],),
                                         dtype=torch.float32, device=result.device)
                        result = torch.cat([result, pad], dim=-1)
                    result = result[..., :texture.components]
                matrix[0, layer] = result
            if temporal > 1:
                matrix.roll()
        # After its roll a temporal main program's newest box sits at slot 1
        main = textures[scene.shader.name]
        slot = 1 if scene.shader.texture.temporal > 1 else 0
        out.copy_(final_pass(main[slot, -1], out_height, out_width, subsample))

    def flush(self, count: Optional[int] = None) -> Optional[torch.Tensor]:
        """Render the captured frames -> (F, H, W, 3) uint8 on the device.
        Work is enqueued on the current stream; nothing waits for it."""
        count = count if count is not None else len(self._frame_uniforms)
        if count == 0:
            return None
        if self.stale:
            # A static changed during capture: rebuild; captures stay valid
            self.build()
        else:
            # Modules bind their sequences on their first update
            self._refresh_textures()
        packed, spec = self.stack_captures(count)
        packed = torch.from_numpy(packed)
        if self.device.type == "cuda":
            packed = packed.pin_memory().to(self.device, non_blocking=True)

        scene = self.scene
        out_width, out_height = scene._final.texture.resolution
        frames = torch.empty((count, out_height, out_width, 3), dtype=torch.uint8,
                             device=self.device)
        frame_indices = self.frame_indices(count)
        per_batch, invariant = self._run_preludes(frame_indices)
        for index in range(count):
            self.render_frame(packed[index], spec, index, frame_indices[index],
                              per_batch, invariant, frames[index])
        return frames
