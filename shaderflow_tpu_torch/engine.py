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

Textures not owned by a program come in three kinds:
  static    host-written (images): uploaded once, again when their version
            changes between batches
  sequence  per-frame device content (offline audio): row
            clip(iFrameIndex, 0, F - 1) each frame, or the ring of the last
            L columns for a windowed sequence
  streamed  host-written during the frame loop (the realtime spectrogram
            and waveform, video frames): capture_frame snapshots each
            frame's content into the batch (a texture promoted mid-batch
            backfills the frames before with its first snapshot); the u8
            wire twin ships as bytes and is normalized on the device
The batch's packed uniforms and stream snapshots go up in one host->device
copy per flush, from a reused page-locked staging buffer (StagingPool).
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
frame from zeros (program_matrix); one with temporal > 1 is carried across
frames and flushes (seeded from its host matrix at each build, so an
initial texture.write(..., temporal=k) seeds the ring) and rolls by one
slot after it renders: the roll moves the ring's origin, not its data
(Ring). Only the main program, when it has temporal == 1 and one layer
(fuses), fuses a TailSpec with the final pass; any other TailSpec is
evaluated by the plain tail into the matrix, padded to the program's
components (store_layer). The final pass (end_frame) reads the main
program's slot 1 when it is temporal (the newest box after its roll), else
slot 0 (final_slot; SHADERFLOW_REF_SLOT0=1 reads slot 0).

The frame loop enqueues most programs' fragments eagerly, every frame.
A build whose fragment is recordable (fraggraph.py: on the card, no mesh,
no temporal ring, one program with one instance whose tail fuses) records
it as one CUDA graph: its first frame runs eagerly, its second is
captured and replayed, and every later frame copies its per-frame inputs
(the uniform row, sequence boxes, stream snapshots, per-batch prelude
values read as tensors) into the graph's fixed slots and replays it; the
tail and the final pass stay eager. The engine records anew
(drop_recording) where what the graph reads in place changes: a static
texture uploaded again, a sequence bound again, a texture that starts
streaming, new batch-invariant preludes, a rebuild; and a run's end
(Scene.main) drops it, so its memory pool does not outlive the run.

Under SKIP_TPU=1 (switches.skip_device) a flush returns black frames on
the host and does no device work: the host loop alone, timed.

Each device renders from a DeviceState. The engine's own (engine.state,
on the current stream) is where textures are bound; a flush is the frame
path over it (render_parts). With a mesh (engine.mesh, parallel/mesh.py:
Scene.main(devices=N)) a flush is split over N shards, each a device (a
card, or a repeated one, on a stream of its own) whose state follows the
engine's. Without a temporal program the shards take the frame path, each
on its part of the batch; with one, every shard steps every frame on a
window of each program's rows through the same frame steps, the windows
gathered into every shard's texture after each layer. The shards' frames
go down into one host batch (WireBatch), each on its own stream.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Mapping
from typing import TYPE_CHECKING, Any, NamedTuple, Optional

import numpy as np
import torch

from shaderflow_tpu_torch import logger, switches, tracing
from shaderflow_tpu_torch.fraggraph import FragmentGraph, recordable
from shaderflow_tpu_torch.ops import tailfuse, tailgen
from shaderflow_tpu_torch.ops.downsample import final_pass
from shaderflow_tpu_torch.ops.stdlib import reciprocal
from shaderflow_tpu_torch.shader import Frag, ShaderProgram, finish_coords, make_coords
from shaderflow_tpu_torch.texture import ShaderTexture

if TYPE_CHECKING:
    from shaderflow_tpu_torch.scene import ShaderScene


def final_slot(temporal: int) -> int:
    """The temporal slot of the main program that the final pass reads:
    after its roll a temporal program's newest box sits at slot 1;
    SHADERFLOW_REF_SLOT0=1 reads slot 0 (the oldest box). Read at each
    build."""
    if switches.ref_slot0():
        return 0
    return 1 if temporal > 1 else 0


class WireBatch:
    """A frame batch staged for host delivery. On the card, the
    device->host copy into pinned memory is enqueued right behind the
    batch's compute, so it overlaps the host's capture of the next batch;
    fetch() waits for it. With host=False only completion is tracked
    (NullSink: frames never leave the device). The parts of a sharded
    flush (ShardedFrames) go into one host batch, each copied on its
    shard's stream into its frames or rows: no part is gathered onto
    another device."""

    def __init__(self, frames, host: bool = True):
        self.frames = frames    # keeps the device batch alive until drained
        self.shape = tuple(frames.shape)
        self.host: Optional[torch.Tensor] = None
        self.done: list[torch.cuda.Event] = []
        if isinstance(frames, ShardedFrames):
            self._stage_parts(frames, host)
        elif frames.device.type == "cpu":
            self.host = frames
        else:
            if host:
                self.host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
                self.host.copy_(frames, non_blocking=True)
            self.done.append(torch.cuda.Event())
            self.done[-1].record(torch.cuda.current_stream(frames.device))

    def _stage_parts(self, frames: "ShardedFrames", host: bool) -> None:
        on_card = any(shard.stream is not None for shard, *_ in frames.parts)
        if host:
            self.host = torch.empty(self.shape, dtype=torch.uint8, pin_memory=on_card)
        for shard, frame_slice, row_slice, part in frames.parts:
            with shard.context():
                if host and row_slice == slice(None):
                    self.host[frame_slice].copy_(part, non_blocking=True)
                elif host:
                    # A row window of every frame: contiguous in each frame
                    for index, frame in enumerate(range(*frame_slice.indices(self.shape[0]))):
                        self.host[frame, row_slice].copy_(part[index], non_blocking=True)
                if shard.stream is not None:
                    self.done.append(torch.cuda.Event())
                    self.done[-1].record(shard.stream)

    def wait(self) -> None:
        with tracing.span("wire.wait"):
            for event in self.done:
                event.synchronize()

    def fetch(self) -> np.ndarray:
        if self.host is None:
            raise ValueError("WireBatch staged without a host copy")
        self.wait()
        return self.host.numpy()


def to_wire(frames, host: bool = True) -> WireBatch:
    """Stage a (F, H, W, 3) u8 batch, or a sharded flush's parts, for host
    delivery (see WireBatch). A batch on the host (the CPU, SKIP_TPU) is
    taken as it is, without a copy."""
    return WireBatch(frames, host=host)


def fetch_frame(frame: torch.Tensor) -> np.ndarray:
    """One (H, W, 3) frame on the host (screenshots, previews)."""
    return frame.cpu().numpy()


class StagingPool:
    """Page-locked host buffers for the per-flush host->device copy. A
    buffer is handed out again only once the event recorded behind its last
    copy has completed; a pageable copy, or a fresh pin_memory() per
    flush, would wait for the stream or pay a page-locked allocation every
    frame of the realtime loop. At most LIMIT buffers: past it the oldest
    copy is waited for."""

    ALIGN = 64
    LIMIT = 4

    def __init__(self):
        self._entries: list[list] = []   # [pinned uint8 tensor, event or None]

    def _take(self, nbytes: int) -> list:
        for entry in self._entries:
            if entry[0].numel() >= nbytes and (entry[1] is None or entry[1].query()):
                return entry
        if len(self._entries) >= self.LIMIT:
            oldest = self._entries.pop(0)
            with tracing.span("staging.wait"):
                oldest[1].synchronize()
            if oldest[0].numel() >= nbytes:
                self._entries.append(oldest)
                return oldest
        size = max(1 << 16, 1 << (max(1, nbytes) - 1).bit_length())
        entry = [torch.empty(size, dtype=torch.uint8, pin_memory=True), None]
        self._entries.append(entry)
        return entry

    def upload(self, arrays: list, device: torch.device) -> list:
        """Host arrays (float32 or uint8) -> device tensors of the same
        shapes and dtypes, through one non-blocking copy on the current
        stream."""
        offsets, total = [], 0
        for array in arrays:
            offsets.append(total)
            total += -(-array.nbytes // self.ALIGN) * self.ALIGN
        entry = self._take(total)
        host = entry[0].numpy()
        for array, offset in zip(arrays, offsets):
            host[offset:offset + array.nbytes] = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
        staged = torch.empty(total, dtype=torch.uint8, device=device)
        staged.copy_(entry[0][:total], non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record(torch.cuda.current_stream(device))
        return [staged[offset:offset + array.nbytes].view(_TORCH_DTYPES[array.dtype])
                .reshape(array.shape) for array, offset in zip(arrays, offsets)]


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8}


def normalize_u8(stack: torch.Tensor) -> torch.Tensor:
    """A u8 wire stream in sample space: value / 255 as the reference's
    compiled program computes it (the division folded into a product with
    the float32 reciprocal)."""
    return stack.to(torch.float32) * reciprocal(255.0)


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
    overwrites (a one-slot matrix stays as it is)."""

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


class DeviceState:
    """What one device renders from: its device, its CUDA stream (None:
    the current one), staging buffers, textures, preludes, pyramids, rings
    and coordinates (the engine's own, or a mesh shard's copies)."""

    def __init__(self, device: torch.device, stream: Optional[torch.cuda.Stream] = None,
                 index: int = 0):
        self.index = index
        self.device = device
        self.stream = stream
        self.staging = StagingPool()
        # Static uploads (name -> (T, L, H, W, C)), bound sequences (name ->
        # (source, tensor, window)), stream snapshots (name -> (F, T, L, H, W, C))
        self.static_tex: dict[str, torch.Tensor] = {}
        self.sequences: dict[str, tuple] = {}
        self.stream_tex: dict[str, torch.Tensor] = {}
        # Batch-invariant prelude values and the state they were computed for
        self.prelude_cache: dict[str, torch.Tensor] = {}
        self.prelude_state = None
        # Static textures' mip pyramids (Frag.tex), held with their tensor
        self.mip_cache: dict = {}
        # Temporal rings carried across frames and flushes: name -> Ring
        self.carry: dict[str, Ring] = {}
        self.program_coords: list = []   # each program's coordinates, in render order
        self.copies: dict = {}           # key -> (the followed tensor, its copy here)
        self.slabs: dict = {}            # (program index, rows) -> Coords of the rows
        # What it rendered: its frames of the last flush; under the row
        # path its row window of each program in the last frame and the
        # rows it rendered, over frames and layers
        self.frames: list[int] = []
        self.windows: dict[str, tuple] = {}
        self.rows_rendered: dict[str, int] = {}

    def context(self) -> contextlib.ExitStack:
        """Its device and stream as the current ones (if it has a stream)."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def take_rings(self, source: "DeviceState") -> None:
        """Copies of `source`'s rings on this device, on the current stream."""
        self.carry = {name: Ring(ring.data.to(self.device, copy=True), ring.origin)
                      for name, ring in source.carry.items()}

    def follow(self, source: "DeviceState") -> None:
        """Before a flush: order this stream after `source`'s (static
        uploads, the modules' sequences), then copy its textures and
        sequences that changed since the last flush, and its rings if none."""
        if source is self:
            return
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(source.device))
        with self.context():
            self.static_tex = {name: self._copy(("tex", name), tensor)
                               for name, tensor in source.static_tex.items()}
            self.sequences = {name: (origin, self._copy(("seq", name), seq), window)
                              for name, (origin, seq, window) in source.sequences.items()}
            if not self.carry:
                self.take_rings(source)
        live = {("tex", name) for name in self.static_tex} | {("seq", name)
                                                             for name in self.sequences}
        self.copies = {key: entry for key, entry in self.copies.items() if key in live}

    def _copy(self, key: tuple, tensor: torch.Tensor) -> torch.Tensor:
        entry = self.copies.get(key)
        if entry is None or entry[0] is not tensor:
            copy = tensor.to(self.device, non_blocking=True)
            if copy is tensor and self.stream is not None:
                # Made on another stream, read on this one: its memory is
                # not reused before the reads queued here are done
                tensor.record_stream(self.stream)
            entry = self.copies[key] = (tensor, copy)
        return entry[1]


class Part(NamedTuple):
    """A state's frames [first, end) of a flush, set up (RenderEngine.stage)."""
    state: DeviceState
    first: int
    end: int
    rows: torch.Tensor
    per_batch: dict
    invariant: dict
    out: torch.Tensor


class ShardedFrames:
    """A sharded flush's (F, H, W, 3) u8 frames, left where each shard
    rendered them: parts (shard, frame slice, row slice, tensor)."""

    def __init__(self, parts: list, shape: tuple):
        self.parts = parts
        self.shape = shape

    def cpu(self) -> torch.Tensor:
        """The whole batch on the host (waits for every part)."""
        return torch.from_numpy(WireBatch(self).fetch())


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
                         modules: Optional[dict] = None,
                         streams: Optional[dict] = None) -> None:
    """Carry a reference engine's state into this scene: `sequences`
    (name -> bound (F_pad, H, W, C) arrays, ring sequences already
    front-padded) replace the module-bound sequences of the same name, and
    `textures` (name -> (T, L, H, W, C) arrays) replace static uploads;
    entries named PRELUDE_KEY + name replace that batch-invariant prelude.
    `streams` (name -> (T, L, H, W, C) float32 arrays) is a streamed
    texture's content as the reference snapshot it last: it becomes the
    texture's host matrix, so the next per-frame write overlays the same
    state. `modules` (module name -> {field: numpy array}) hands host
    state to the module of that name (ShaderModule.load_state): the
    piano's note-range replay and sequences, the camera's rotation, the
    spectrogram's dynamics. This system
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
    # A module and its texture may share a name (the spectrogram's): module
    # state goes to the module
    by_name = {module.name: module for module in scene.modules
               if module.name and not isinstance(module, ShaderTexture)}
    externals = engine._external_textures()
    for name, value in (streams or {}).items():
        if name not in externals:
            raise KeyError(f"No external texture named {name!r} in the scene")
        externals[name].matrix = np.array(value, dtype=np.float32)
        externals[name].wire_u8 = None
    for name, state in (modules or {}).items():
        if name not in by_name:
            raise KeyError(f"No module named {name!r} in the scene")
        by_name[name].load_state(state)
    engine.invalidate()


class RenderEngine:

    # Bytes that sequence binds copied to another device, every engine's
    # (an export's tracing counter sequence.bytes)
    sequence_bytes = 0

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.stale = True
        self._statics: dict[str, Any] = {}
        self._uniform_kinds: dict[str, str] = {}
        self._render_size: tuple[int, int] = (0, 0)
        self.state = DeviceState(self.device)
        self._static_versions: dict[str, int] = {}   # static upload name -> version
        # Reference state carried in by load_reference_state (host tensors)
        self.pinned_sequences: dict[str, torch.Tensor] = {}
        self.pinned_textures: dict[str, torch.Tensor] = {}
        self.pinned_preludes: dict[str, torch.Tensor] = {}
        # Streamed textures: their names (kept across builds), the names
        # that fell back to float32 snapshots, and the batch's snapshots
        self._streamed_names: set[str] = set()
        self._stream_f32: set[str] = set()
        self._frame_streams: dict[str, list[np.ndarray]] = {}
        self.last_flush_retraced = False   # the last flush built a new K1 (a compile)
        # (frames, host seconds) of each flush that built a new K1: its
        # trace, generation and Triton compile (coldstart.py reads them)
        self.compile_events: list[tuple[int, float]] = []
        # Per-batch capture state
        self._frame_uniforms: list[dict[str, np.ndarray]] = []
        # Multi-device sharding (parallel/mesh.py): the mesh, its shards'
        # states (made for one mesh and one build), and the programs that
        # render whole rows on every shard under the row path
        self.mesh = None
        self._shards: list[DeviceState] = []
        self._shards_mesh = None
        self._whole_rows: set[str] = set()
        # The build's recording of its fragment (fraggraph.py), or None
        self._recorder: Optional[FragmentGraph] = None

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def invalidate(self) -> None:
        self.stale = True

    def drop_recording(self) -> None:
        """Drop the recording of the fragment (fraggraph.py), where what it
        reads in place changes: its next frame records anew."""
        if self._recorder is not None:
            self._recorder.reset()

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
        with tracing.span("engine.build"):
            scene = self.scene
            programs = self._programs()
            state = self.state
            state.device = self.device
            state.static_tex.clear()
            self._static_versions.clear()
            state.mip_cache.clear()
            state.sequences.clear()
            self._refresh_textures()

            self._statics = {v.name: v.value for v in scene.full_pipeline()
                             if v.static and v.value is not None}
            state.program_coords = self.coords_on(self.device)
            width, height = programs[-1].texture.resolution
            self._render_size = (height, width)
            # Temporal rings start from the programs' host matrices
            state.carry = {}
            for program in programs:
                if program.texture.temporal > 1:
                    if program.texture.matrix is None:
                        program.texture.make()
                    state.carry[program.name] = Ring(torch.from_numpy(
                        program.texture.matrix).to(device=self.device, dtype=torch.float32))
            # Shards hold copies of this build's state: made anew at the next
            # sharded flush (their rings from these)
            self._shards, self._shards_mesh = [], None
            self._whole_rows = set()
            self._main_slot = final_slot(scene.shader.texture.temporal)
            # The last build's graph and its memory pool go now, not at a
            # collection
            self.drop_recording()
            self._recorder = FragmentGraph() if recordable(self) else None
            self.stale = False
            out_width, out_height = scene._final.texture.resolution
            logger.debug(f"Engine built: render {width}x{height} -> output "
                         f"{out_width}x{out_height} subsample {scene.subsample} "
                         f"on {self.device}")

    def coords_on(self, device: torch.device) -> list:
        """Each program's coordinate flavors on `device`, in render order:
        they live for the build (one set per render size)."""
        by_size: dict[tuple[int, int], Any] = {}
        coords = []
        for program in self._programs():
            width, height = program.texture.resolution
            if (height, width) not in by_size:
                by_size[(height, width)] = make_coords(height, width, self.scene.aspect_ratio,
                                                       device)
            coords.append(by_size[(height, width)])
        return coords

    def shards(self) -> list[DeviceState]:
        """The states of self.mesh's shards, made once for a mesh and a
        build (their program coordinates with them). A mesh naming a device this run
        cannot use raises: a sharded flush never runs on fewer shards than
        its mesh has."""
        if self._shards_mesh is not self.mesh:
            self.leave_mesh()
            count = torch.cuda.device_count() if self.device.type == "cuda" else 0
            for device in self.mesh:
                if device.type != self.device.type:
                    raise ValueError(f"Mesh device {device} on a run on {self.device}")
                if device.type == "cuda" and not (device.index is not None
                                                  and device.index < count):
                    raise RuntimeError(f"Mesh device {device}: {count} cards visible")
            self._shards = [DeviceState(device, torch.cuda.Stream(device)
                                        if device.type == "cuda" else None, index)
                            for index, device in enumerate(self.mesh)]
            for shard in self._shards:
                with shard.context():   # made on the stream that reads them
                    shard.program_coords = self.coords_on(shard.device)
            self._shards_mesh = self.mesh
        return self._shards

    def leave_mesh(self) -> None:
        """Drop the shards; the rings of a row-sharded run come back to
        the engine's device."""
        rings = self.ring_state()
        if rings is not self.state:
            self.state.take_rings(rings)
        self._shards, self._shards_mesh = [], None

    def join_shards(self) -> None:
        """Order the engine's current stream after the work enqueued on
        every shard's stream (before it reads what the shards wrote)."""
        for shard in self._shards:
            if shard.stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(shard.stream)

    def ring_state(self) -> DeviceState:
        """Where the newest rings are: the first shard's under the row path
        (every shard holds them whole; joined first), else the engine's."""
        if self._shards and self._shards[0].carry:
            self.join_shards()
            return self._shards[0]
        return self.state

    # ------------------------------------------------------------------ #
    # Batch capture (host side, per frame)

    def begin_batch(self) -> None:
        if self.stale:
            self.build()
        else:
            self._refresh_textures()
        self._frame_uniforms = []
        self._frame_streams = {name: [] for name in self._streamed_names}

    # ------------------------------------------------------------------ #
    # Textures and sequences

    def _refresh_textures(self) -> None:
        """Bind every external texture for the next batch: sequences by
        identity of the module's tensor (ring windows front-padded with L-1
        zero columns, so the window at frame 0 sees an empty history), host
        textures uploaded when their version changed."""
        device, state = self.device, self.state
        for name, tex in self._external_textures().items():
            if tex.sequence is not None:
                if state.static_tex.pop(name, None) is not None:
                    self.drop_recording()
                self._streamed_names.discard(name)
                window = tex.sequence_window or 0
                bound = state.sequences.get(name)
                if bound is None or bound[0] is not tex.sequence or bound[2] != window:
                    self.drop_recording()
                    with tracing.span("engine.sequences"):
                        source = self.pinned_sequences.get(name, tex.sequence)
                        seq = source.to(device)
                        if seq is not source:
                            RenderEngine.sequence_bytes += source.nbytes
                        if window > 1 and name not in self.pinned_sequences:
                            pad = seq.new_zeros((window - 1,) + tuple(seq.shape[1:]))
                            seq = torch.cat([pad, seq], dim=0)
                    state.sequences[name] = (tex.sequence, seq, window)
                tex.dirty = False
                continue
            if state.sequences.pop(name, None) is not None:
                self.drop_recording()
            if name in self._streamed_names:
                continue
            if name in state.static_tex and tex.version == self._static_versions.get(name):
                continue
            self.drop_recording()
            if name in self.pinned_textures:
                matrix = self.pinned_textures[name]
            else:
                if tex.matrix is None:
                    tex.make()
                matrix = torch.from_numpy(tex.matrix)
            state.static_tex[name] = matrix.to(device=device, dtype=torch.float32)
            self._static_versions[name] = tex.version
            tex.dirty = False

    def bound_sequences(self, state: DeviceState) -> dict[str, torch.Tensor]:
        """name -> the device sequence each frame indexes (ring-padded) on
        `state`'s device."""
        return {name: bound[1] for name, bound in state.sequences.items()}

    def _frame_textures(self, frame_index: int, step: int,
                        state: DeviceState) -> dict[str, torch.Tensor]:
        """Every texture one frame reads on `state`, (T, L, H, W, C) views:
        the static uploads, the frame's box of each sequence (row
        clip(frame_index), or the ring of the last L columns) and snapshot
        `step` of each streamed texture."""
        textures = dict(state.static_tex)
        for name, stack in state.stream_tex.items():
            textures[name] = stack[step]
        for name, (_, seq, window) in state.sequences.items():
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

    def _run_preludes(self, frame_indices: list[int],
                      state: DeviceState) -> tuple[dict, dict]:
        """Run the scene's batch preludes for one flush on `state`'s frames,
        device and cache -> (per-batch values with leading axis B,
        batch-invariant values with leading axis 1). Invariant values are
        reused while the key they were computed for holds; values carried
        by load_reference_state take precedence."""
        with tracing.span("engine.preludes"):
            functions = dict(getattr(self.scene, "batch_preludes", None) or {})
            if not functions:
                return {}, {}
            sequences = self.bound_sequences(state)
            # (name, __code__): scenes re-register fresh closures from the same
            # factory on every build, which share semantics by contract
            key = (tuple(sorted((name, id(getattr(fn, "__code__", fn)))
                                for name, fn in functions.items())),
                   tuple(sorted((name, tuple(seq.shape), str(seq.dtype))
                                for name, seq in sequences.items())),
                   self._render_size, self.scene.aspect_ratio, str(state.device))
            if key != state.prelude_state:
                state.prelude_state = key
                self.drop_recording()
                state.prelude_cache = {name: value.to(state.device)
                                       for name, value in self.pinned_preludes.items()}
            frames = torch.as_tensor(frame_indices, dtype=torch.int64).to(state.device)
            ctx = PreludeCtx(frames, sequences, self._render_size, self.scene.aspect_ratio)
            per_batch = {}
            for name, fn in functions.items():
                if name in state.prelude_cache:
                    continue
                value = fn(ctx)
                if value is None:
                    continue
                if value.shape[0] == 1:
                    state.prelude_cache[name] = value
                elif value.shape[0] != len(frame_indices):
                    raise ValueError(f"Prelude {name!r}: leading axis {value.shape[0]} "
                                     f"!= batch {len(frame_indices)}")
                else:
                    per_batch[name] = value
            return per_batch, self.invariant_preludes(state)

    def invariant_preludes(self, state: DeviceState) -> dict[str, torch.Tensor]:
        """`state`'s cached batch-invariant prelude values (leading axis 1)."""
        functions = getattr(self.scene, "batch_preludes", None) or {}
        return {name: value for name, value in state.prelude_cache.items()
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

        frame_index = len(self._frame_uniforms) - 1
        for name, tex in self._external_textures().items():
            if tex.sequence is not None:
                tex.dirty = False   # bound at the flush (_refresh_textures)
                continue
            streamed = name in self._streamed_names
            if tex.dirty and not streamed:
                # Written during the frame loop: streamed from now on. The
                # frames of this batch before it read its first snapshot
                self._streamed_names.add(name)
                self.state.static_tex.pop(name, None)
                self.drop_recording()
                self._frame_streams[name] = [self._stream_snapshot(name, tex)] * frame_index
                streamed = True
                if frame_index:
                    logger.debug(f"Texture {name} became streamed mid-batch at frame "
                                 f"{frame_index}")
            if streamed:
                self._frame_streams[name].append(self._stream_snapshot(name, tex))
                tex.dirty = False

    def _stream_snapshot(self, name: str, tex) -> np.ndarray:
        """A streamed texture's content this frame: its u8 wire twin (the
        bytes of the write, normalized on the device) while every write of
        it kept one, else a float32 copy of the matrix. A name that once
        falls back stays float32, and its earlier u8 snapshots of the batch
        are converted (a stack never mixes the two)."""
        wire = tex.wire_u8
        if wire is not None and name not in self._stream_f32:
            return wire   # a fresh array per write, never mutated
        if name not in self._stream_f32:
            self._stream_f32.add(name)
            snapshots = self._frame_streams.get(name) or []
            for index, snapshot in enumerate(snapshots):
                if snapshot.dtype == np.uint8:
                    snapshots[index] = snapshot.astype(np.float32) / 255.0
        return tex.matrix.copy()

    # ------------------------------------------------------------------ #
    # Flush: render the captured frames

    def stack_captures(self, count: Optional[int] = None):
        """Pack the captured per-frame uniforms into one (F, K) float32
        matrix (one host->device copy per batch) plus a static unpack spec.
        A uniform missing from some frames fills from the nearest earlier
        frame that has it (else the first one that does). The streamed
        snapshots stack separately (stack_streams)."""
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

    def stack_streams(self, count: Optional[int] = None) -> dict[str, np.ndarray]:
        """name -> (F, T, L, H, W, C) stack of the batch's snapshots of each
        streamed texture (uint8 on the wire, else float32)."""
        count = count if count is not None else len(self._frame_uniforms)
        return {name: np.stack(snapshots[:count])
                for name, snapshots in self._frame_streams.items() if snapshots}

    def upload(self, packed: np.ndarray, streams: dict, state: DeviceState) -> tuple:
        """The batch's packed uniforms and stream stacks on `state`'s
        device, through its staging buffers: one staged copy on the card
        (StagingPool), views of the host arrays on the CPU. u8 streams are
        normalized here, once per batch."""
        names = list(streams)
        if state.device.type == "cuda":
            tensors = state.staging.upload([packed, *(streams[n] for n in names)],
                                           state.device)
        else:
            tensors = [torch.from_numpy(a) for a in (packed, *(streams[n] for n in names))]
        stacks = {name: (normalize_u8(stack) if stack.dtype == torch.uint8 else stack)
                  for name, stack in zip(names, tensors[1:])}
        return tensors[0], stacks

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
                      state: DeviceState, coords=None, layer: int = 0,
                      textures: Optional[dict] = None,
                      uniforms: Optional[FrameUniforms] = None) -> Frag:
        """The Frag of one frame and layer on `state` (its main program's
        coordinates and external textures unless given): its packed uniform
        row on the device, its textures (sequence rows at frame_index,
        streamed snapshot `step`), the batch's prelude values (frame `step`
        of each per-batch stack, entry 0 of each batch-invariant one) and
        the state's mip pyramids."""
        uniforms = uniforms if uniforms is not None else FrameUniforms(row, spec)
        coords = coords if coords is not None else state.program_coords[-1]
        return Frag(coords=finish_coords(coords, uniforms["iResolution"]),
                    uniforms=uniforms, statics={**self._statics, "iLayer": layer},
                    layer=layer,
                    textures=(textures if textures is not None
                              else self._frame_textures(frame_index, step, state)),
                    texture_meta=self.texture_meta(),
                    preludes={**{n: v[step] for n, v in per_batch.items()},
                              **{n: v[0] for n, v in invariant.items()}},
                    prelude_stacks={**per_batch, **invariant}, prelude_step=step,
                    mip_cache=state.mip_cache)

    def carried(self) -> dict[str, torch.Tensor]:
        """The temporal rings as they stand, in slot order (copies on the
        engine's device, from ring_state)."""
        return {name: ring.ordered().to(self.device)
                for name, ring in self.ring_state().carry.items()}

    def program_matrix(self, program: ShaderProgram, textures: dict,
                       state: DeviceState) -> Ring:
        """The matrix `program` renders into on `state`: its ring, or for
        temporal 1 a zero matrix bound in `textures` (the per-frame fill)."""
        texture = program.texture
        if texture.temporal > 1:
            return state.carry[program.name]
        width, height = texture.resolution
        textures[program.name] = Ring(torch.zeros(
            (1, texture.layers, height, width, texture.components),
            dtype=torch.float32, device=state.device))
        return textures[program.name]

    def fuses(self, program: ShaderProgram) -> bool:
        """Whether a TailSpec of `program` fuses with the final pass
        (fuse_tail): the main program, with temporal 1 and one layer."""
        texture = program.texture
        return program is self.scene.shader and texture.temporal == 1 and texture.layers == 1

    def fuse_tail(self, result: tailfuse.TailSpec, coords, out: torch.Tensor) -> None:
        """The main program's tail and final pass: its (H, W, 3) u8 frame."""
        out_width, out_height = self.scene._final.texture.resolution
        tailfuse.run_tail_final(result, coords.height, coords.width, out_height, out_width,
                                int(self.scene.subsample), self.scene.aspect_ratio, out=out)

    def store_layer(self, matrix: Ring, layer: int, program: ShaderProgram, result,
                    coords) -> tuple[int, int]:
        """A layer's result (a TailSpec by the plain tail) into slot 0 of
        its matrix, on the rows it rendered (coords.rows) -> those rows."""
        if isinstance(result, tailfuse.TailSpec):
            result = program.fit(tailfuse.eval_reference(result, coords.height, coords.width,
                                                         self.scene.aspect_ratio))
        first, end = coords.rows or (0, matrix.data.shape[2])
        matrix[0, layer, first:end] = result
        return first, end

    def end_frame(self, textures: dict, out: torch.Tensor, rows: Optional[tuple] = None) -> None:
        """The final pass of the main slot into `out`: the frame or `rows`."""
        out_width, out_height = self.scene._final.texture.resolution
        with tracing.span("tail"):
            out.copy_(final_pass(textures[self.scene.shader.name][self._main_slot, -1],
                                 out_height, out_width, int(self.scene.subsample), rows=rows))

    def render_frame(self, row: torch.Tensor, spec: tuple, step: int, frame_index: int,
                     per_batch: dict, invariant: dict, out: torch.Tensor,
                     state: DeviceState) -> None:
        """Render one frame on `state` into `out` (H, W, 3) u8: every
        program and layer in order, then fuse_tail or end_frame. A recorded
        build (off a mesh) renders from its FragmentGraph's Frag: eagerly,
        then captured and replayed, then replayed."""
        with tracing.span("frame"):
            recorder = self._recorder if state is self.state and self.mesh is None else None
            uniforms = FrameUniforms(row, spec)
            textures = self._frame_textures(frame_index, step, state)
            textures.update(state.carry)
            for program, coords in zip(self._programs(), state.program_coords):
                matrix = self.program_matrix(program, textures, state)
                for layer in range(program.texture.layers):
                    if recorder is not None:   # the one program, one layer
                        ctx = recorder.frame_context(self, row, spec, step, frame_index,
                                                     per_batch, invariant, coords, textures)
                    else:
                        ctx = self.frame_context(row, spec, step, frame_index, per_batch,
                                                 invariant, state, coords=coords, layer=layer,
                                                 textures=textures, uniforms=uniforms)
                    result = program.render_layer(ctx)
                    if isinstance(result, tailfuse.TailSpec) and self.fuses(program):
                        self.fuse_tail(result, coords, out)
                        return
                    self.store_layer(matrix, layer, program, result, coords)
                matrix.roll()
            self.end_frame(textures, out)

    # ------------------------------------------------------------------ #
    # Flush: render the captured frames

    def flush(self, count: Optional[int] = None) -> Optional[torch.Tensor]:
        """Render the captured frames -> (F, H, W, 3) uint8 on the device.
        Work is enqueued on the current stream; nothing waits for it. Under
        SKIP_TPU=1, zeros on the host (switches.skip_device)."""
        count = count if count is not None else len(self._frame_uniforms)
        if count == 0:
            return None
        with tracing.span("engine.flush"):
            tracing.flushed(count)
            return self._flush(count)

    def _flush(self, count: int) -> Optional[torch.Tensor]:
        if switches.skip_device():
            # numpy's zeros, as the JAX package's: pages the sink never
            # reads are never written
            width, height = self.scene._final.texture.resolution
            self.last_flush_retraced = False
            return torch.from_numpy(np.zeros((count, height, width, 3), np.uint8))
        if self.stale:
            # A static changed during capture: rebuild; captures stay valid
            self.build()
        else:
            # Modules bind their sequences on their first update
            self._refresh_textures()
        builds = tailgen.compiled.builds
        started = time.perf_counter()
        if self.mesh is not None:
            from shaderflow_tpu_torch.parallel import mesh
            frames = (mesh.flush_rows if self.state.carry else mesh.flush_frames)(self, count)
        else:
            self.leave_mesh()
            frames = self.render_parts([self.state], [(0, count)], count)[0].out
        self._note_builds(builds, count, started)
        return frames

    def stage(self, states: list[DeviceState], parts: list[tuple[int, int]], count: int,
              out_rows: int) -> tuple[tuple, list[int], list[Part]]:
        """A flush set up over `states`, state i taking frames parts[i]
        into (end - first, out_rows, W, 3) u8: the captures packed once,
        then each state's upload and preludes -> (spec, indices, Parts)."""
        with tracing.span("flush.pack"):
            packed, spec = self.stack_captures(count)
            streams = self.stack_streams(count)
        indices = self.frame_indices(count)
        out_width = self.scene._final.texture.resolution[0]
        staged = []
        for state, (first, end) in zip(states, parts):
            state.frames = indices[first:end]
            if first == end:
                continue
            state.follow(self.state)
            with state.context():
                with tracing.span("flush.upload"):
                    rows, state.stream_tex = self.upload(
                        packed[first:end],
                        {name: stack[first:end] for name, stack in streams.items()}, state)
                per_batch, invariant = self._run_preludes(indices[first:end], state)
                out = torch.empty((end - first, out_rows, out_width, 3), dtype=torch.uint8,
                                  device=state.device)
            staged.append(Part(state, first, end, rows, per_batch, invariant, out))
        return spec, indices, staged

    def render_parts(self, states: list[DeviceState], parts: list[tuple[int, int]],
                     count: int) -> list[Part]:
        """The frame path: frames over `states` (stage), step by step."""
        out_height = self.scene._final.texture.resolution[1]
        spec, indices, staged = self.stage(states, parts, count, out_height)
        for step in range(max(part.end - part.first for part in staged)):
            for part in staged:
                if part.first + step < part.end:
                    with part.state.context():
                        self.render_frame(part.rows[step], spec, step,
                                          indices[part.first + step], part.per_batch,
                                          part.invariant, part.out[step], part.state)
        return staged

    def _note_builds(self, builds: int, count: int, started: float) -> None:
        """After a flush of `count` frames begun at perf_counter `started`:
        whether it built a new K1, and if so its host seconds."""
        self.last_flush_retraced = tailgen.compiled.builds != builds
        if self.last_flush_retraced:
            self.compile_events.append((count, time.perf_counter() - started))

    def reset_carry(self) -> None:
        """Re-seed the temporal rings from their programs' host matrices
        (the scene's reset key), on the engine's state and every shard's."""
        for state in (self.state, *self._shards):
            with state.context():
                for program in self._programs():
                    if program.name in state.carry and program.texture.matrix is not None:
                        state.carry[program.name] = Ring(torch.from_numpy(
                            program.texture.matrix).to(device=state.device,
                                                        dtype=torch.float32))
