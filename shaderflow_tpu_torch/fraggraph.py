"""
The fragment's CUDA graph: a program's per-frame fragment recorded once
per engine build and replayed for every later frame.

Eager PyTorch enqueues a fragment one dispatch at a time (the
visualizer's makes about 280 a frame), so the host's enqueue, not the
card, sets an export's pace. The JAX package traces the same body once
per build and batch shape (one jit over a scan of the frames); a CUDA
graph is the port's counterpart. A fragment is a function of its Frag,
with host values fixed when it runs: what one frame enqueues, every
frame of the build enqueues, on other inputs.

Where (`recordable`): on a CUDA device, without a mesh, with no temporal
rings, for the engine's one program when it has one instance, one layer
and temporal 1. Everything else renders eagerly, as without the graph.

Which frames (FragmentGraph.frame_context, ShaderProgram.render_layer):
the first frame of a recording runs eagerly. It fills the lazy caches
(coordinate grids, mip pyramids, kernel builds, cuBLAS's handles) and
notes which per-frame inputs the fragment reads. The second frame is
captured into the graph, over fixed-address slots of those inputs, and
replayed. Every later frame copies its inputs into the slots (one
device-to-device copy each, inside render_layer) and replays. A frame
the cost walker counts (tools/flopcount.py) runs eagerly.

Inputs. Per frame, read from the slots: the packed uniform row, each
sequence's box at the frame, each streamed texture's snapshot and each
per-batch prelude value read as a tensor (`sf.prelude`). Stable over
the build, used in place: static textures, coordinates, mip pyramids and
the batch-invariant preludes. The engine drops the recording (reset)
where it changes those: a static texture uploaded again, a sequence
bound again, a texture that starts streaming, new batch-invariant
preludes; a rebuild and the end of a run (Scene.main) drop it too, and
with it the graph's memory pool. The recording itself checks only the
uniform layout and each slot's shape. Either starts a new recording: one
eager frame, one capture.

The result: a TailSpec (or a tensor) whose tensors are the graph's
outputs, views of the slots or stable tensors. Each Indexed input on a
prelude stack of the context, at the frame's step, is re-bound at every
replay to the current flush's stack and step; K1 then launches eagerly
in run_tail_final, as without the graph. A per-batch stack's address
changes every flush, so the recording's Frag holds a stand-in of it on
no device (`meta`): a fragment that reads one records no usable result.
The capture refuses, and the program renders eagerly for the rest of
the build, when the capture raises (a fragment that synchronises or
copies from the host) or when the result holds any other tensor than
those above. Nothing fails silently: a refusal is counted and logged.

Counters (class attributes of FragmentGraph, in every export's tracing
counters as fragment.*): `calls` (every render_layer), `replays`,
`captures` and `refusals`. The port's kernel wrappers count eager
launches only: a call captured into the graph launches nothing, and the
graph's own launches are `captures + replays` (each capture replays
once).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import functools
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.ops import tailfuse
from shaderflow_tpu_torch.tools import flopcount

# Device types a fragment is recorded on
RECORD_ON = ("cuda",)

_STREAMS: dict = {}   # device -> the side stream captures run on


def recordable(engine) -> bool:
    """Whether the engine's fragment is recorded: a CUDA device, no mesh,
    no temporal rings, and one program, with one instance, whose tail
    fuses with the final pass (engine.fuses: one layer, temporal 1). A
    program that reads another's texture reads a matrix made anew every
    frame."""
    programs = engine._programs()
    if (engine.device.type not in RECORD_ON or engine.mesh is not None or engine.state.carry
            or len(programs) != 1):
        return False
    return programs[0].instances == 1 and engine.fuses(programs[0])


def _storage(tensor: torch.Tensor) -> int:
    return tensor.untyped_storage().data_ptr()


def result_tensors(result) -> list:
    """Every tensor a fragment's result holds, Indexed stacks aside, in a
    fixed order."""
    if not isinstance(result, tailfuse.TailSpec):
        return [result]
    found = [tensor for planes in result.planes.values() for tensor in planes]
    for bucket in (result.rows, result.cols, result.scalars, result.tables):
        found += bucket.values()
    for sampled in result.colsampled.values():
        found += [*sampled.planes, sampled.positions]
    return found


class _Unread(LookupError):
    """A per-frame input the recording's first frame did not read."""


class Inputs(Mapping):
    """name -> value for a recording's Frag (textures, preludes): every
    name of the frame for containment and iteration, `values` for those
    it may read. `reads`, when given, collects the names read."""

    def __init__(self, names, values: Mapping, reads: Optional[set] = None):
        self.names = tuple(names)
        self.values = values
        self.reads = reads

    def __getitem__(self, name):
        if self.reads is not None and name in self.names:
            self.reads.add(name)
        if name in self.values:
            return self.values[name]
        if name in self.names:
            raise _Unread(f"{name!r} was not read by the frame before the capture")
        raise KeyError(name)

    def __contains__(self, name) -> bool:
        return name in self.names

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


class Watch(TorchFunctionMode):
    """Over a capture: the storages of the tensors its torch calls made
    (`made`: outputs that share no storage with the call's inputs). A
    function mode: a dispatch mode's first use imports seconds of modules."""

    def __init__(self):
        super().__init__()
        self.made: set = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        read = {_storage(leaf) for leaf in tree_leaves((args, kwargs))
                if isinstance(leaf, torch.Tensor)}
        self.made.update(_storage(leaf) for leaf in tree_leaves(out)
                         if isinstance(leaf, torch.Tensor) and not leaf.is_meta
                         and _storage(leaf) not in read)
        return out


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One capture stream a device: cuBLAS keeps its workspace per stream."""
    key = torch.device(device.type, device.index if device.index is not None
                       else torch.cuda.current_device())
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(key)
    return _STREAMS[key]


def capture(draw, device: torch.device) -> tuple:
    """draw() captured into a new CUDA graph on a side stream -> (graph,
    its result). Nothing runs; raises what the capture raised. Only this
    thread is held to the capture's rules: other threads' calls (a sink's
    pinned copies) go on."""
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    current = torch.cuda.current_stream(device)
    stream = _side_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            result = draw()
        finally:
            try:
                graph.capture_end()
            except Exception:
                _release(stream.device, pool)
                raise
    current.wait_stream(stream)
    return graph, result


def _release(device: torch.device, pool) -> None:
    """Hand the memory pool of a capture that failed to end (a fragment
    that synchronised invalidates it) back to the allocator. A graph
    releases its pool only once its capture has ended, so the pool, and
    the memory the capture took, would otherwise stay for the process."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None) or \
        torch._C._cuda_endAllocateCurrentStreamToPool
    try:
        end(device.index, tuple(pool))
    except RuntimeError:
        pass   # the failed end had already stopped allocating to it
    torch._C._cuda_releasePool(device.index, tuple(pool))


class FragmentGraph:
    """The recording of one engine build's program (see the module
    docstring). The engine asks it for each frame's Frag (frame_context)
    and drops the recording where it changes what the fragment reads
    (reset); render_layer hands it the frames it captures or replays
    (render)."""

    calls = 0
    replays = 0
    captures = 0
    refusals = 0

    def __init__(self):
        self.refused = False
        self.reset()

    def reset(self) -> None:
        """Drop the recording, its graph and its slots: the next frame
        starts a new one."""
        self.spec = self.reads = self.pending = None
        self.graph = self.result = self.ctx = self.fresh = self.plain = None
        self.row = None
        self.names: tuple = ()          # the texture names of the recording's frames
        self.textures: dict = {}        # what the recording's Frag reads
        self.texture_slots: dict = {}   # name -> slot, refreshed every frame
        self.prelude_slots: dict = {}
        self.placeholders: dict = {}    # per-batch prelude -> its stack's stand-in
        self.allowed: set = set()       # storages a result may hold
        self.indexed: dict = {}         # the result's Indexed inputs -> prelude name
        self.step, self.stacks = 0, {}

    def _fits(self, spec: tuple, textures: dict, per_batch: dict, invariant: dict) -> bool:
        """Whether this frame's inputs fit the recording: its uniform
        layout, and each slot's and re-bound stack's name and shape (the
        engine resets the recording where the stable inputs change)."""
        if spec != self.spec:
            return False
        for name, slot in self.texture_slots.items():
            value = textures.get(name)
            if not isinstance(value, torch.Tensor) or value.shape != slot.shape:
                return False
        for name, slot in self.prelude_slots.items():
            if name not in per_batch or per_batch[name].shape[1:] != slot.shape:
                return False
        return all(name in per_batch or name in invariant for name in self.indexed.values())

    def frame_context(self, engine, row: torch.Tensor, spec: tuple, step: int,
                      frame_index: int, per_batch: dict, invariant: dict, coords,
                      textures: dict):
        """The Frag the program renders this frame from: a plain one once
        refused or while the cost walker counts (tools/flopcount.py: it
        counts what runs, and a replay runs no op it can see); on a
        recording's first frame one that notes what the fragment reads;
        else the recording's, whose slots render() fills with this
        frame's inputs."""
        if self.refused or flopcount.walking():
            return engine.frame_context(row, spec, step, frame_index, per_batch, invariant,
                                        engine.state, coords=coords, textures=textures)
        if self.reads is not None and not self._fits(spec, textures, per_batch, invariant):
            self.reset()
        if self.reads is None:
            self.spec, self.reads = spec, (set(), set())
            ctx = engine.frame_context(row, spec, step, frame_index, per_batch, invariant,
                                       engine.state, coords=coords,
                                       textures=Inputs(textures, textures, self.reads[0]))
            ctx._preludes = Inputs(ctx._preludes, ctx._preludes, self.reads[1])
            return ctx
        self.step, self.stacks = step, {**per_batch, **invariant}
        if self.ctx is None:
            self._slots(engine, row, step, per_batch, invariant, coords, textures)
            self.fresh = functools.partial(self.context, engine, spec, step, frame_index,
                                           invariant, coords)
            # This frame's plain Frag, should the capture be refused
            self.plain = functools.partial(engine.frame_context, row, spec, step, frame_index,
                                           per_batch, invariant, engine.state, coords=coords,
                                           textures=textures)
            self.ctx = self.fresh()
            self.ctx.recorder = weakref.proxy(self)   # held by the recording: no cycle
            return self.ctx
        self.pending = (row, textures, per_batch)
        return self.ctx

    def _slots(self, engine, row, step, per_batch, invariant, coords, textures) -> None:
        """Fixed-address copies of the per-frame inputs the first frame
        read, holding this frame's values, and the storages a recorded
        result may hold."""
        texture_reads, prelude_reads = self.reads
        self.row = row.clone()
        self.names = tuple(textures)
        # The recording's Frag holds each per-batch stack as a stand-in of
        # its shape on no device: the stack's address changes every flush,
        # so a fragment that reads one fails to record, and an Indexed
        # input on one is re-bound to the real stack at every replay
        self.placeholders = {name: torch.empty(value.shape, dtype=value.dtype, device="meta")
                             for name, value in per_batch.items()}
        for name, value in textures.items():
            if name in engine.state.static_tex:
                self.textures[name] = value
            elif name in texture_reads and isinstance(value, torch.Tensor):
                self.textures[name] = self.texture_slots[name] = value.clone()
            elif name in texture_reads:
                # The program's own matrix: zeros while its only layer renders
                self.textures[name] = type(value)(torch.zeros_like(value.data))
        self.prelude_slots = {name: per_batch[name][step].clone()
                              for name in prelude_reads if name in per_batch}
        stable = [self.row, *self.prelude_slots.values(), *invariant.values(),
                  coords.u_line, coords.v_line, *coords._grids.values(),
                  *(value if isinstance(value, torch.Tensor) else value.data
                    for value in self.textures.values())]
        self.allowed = {_storage(value) for value in stable}

    def context(self, engine, spec, step, frame_index, invariant, coords):
        """A fresh Frag over the slots, the stable inputs and the per-batch
        stacks' stand-ins."""
        ctx = engine.frame_context(self.row, spec, step, frame_index, {}, invariant,
                                   engine.state, coords=coords,
                                   textures=Inputs(self.names, self.textures))
        ctx._preludes = Inputs((*self.placeholders, *invariant),
                               {**ctx._preludes, **self.prelude_slots})
        ctx._prelude_stacks = {**self.placeholders, **invariant}
        return ctx

    def render(self, program, ctx):
        """render_layer's work on a frame of the recording: the capture
        and one replay (a capture runs nothing), or this frame's inputs
        copied into the slots (one device-to-device copy each) and a
        replay."""
        if self.graph is None:
            return self._capture(program)
        (row, textures, per_batch), self.pending = self.pending, None
        self.row.copy_(row)
        for name, slot in self.texture_slots.items():
            slot.copy_(textures[name])
        for name, slot in self.prelude_slots.items():
            slot.copy_(per_batch[name][self.step])
        self.graph.replay()
        FragmentGraph.replays += 1
        return self._bound()

    def _capture(self, program):
        fresh, plain, self.fresh, self.plain = self.fresh, self.plain, None, None
        watch, fault = Watch(), None
        try:
            with watch:
                self.graph, self.result = capture(lambda: program.draw(fresh()),
                                                  self.row.device)
        except Exception as error:   # a fragment that synchronises or copies from the host
            fault = f"{type(error).__name__}: {error}"
        fault = fault or self._check(self.result, watch.made)
        if fault is not None:
            FragmentGraph.refusals += 1
            logger.warning(f"Program {program.name}: its fragment is not recorded ({fault}); "
                           f"it renders eagerly for this build")
            self.reset()
            self.refused = True
            return program.draw(plain())
        FragmentGraph.captures += 1
        self.graph.replay()
        return self._bound()

    def _check(self, result, made: set) -> Optional[str]:
        """Why a captured result cannot be replayed, or None: each tensor a
        graph output, a slot or a stable input; each Indexed input on a
        prelude stack of the frame at its step. Notes the Indexed inputs
        to re-bind."""
        allowed = self.allowed | made
        if isinstance(result, tailfuse.TailSpec):
            stacks = {**self.stacks, **self.placeholders}
            for name, indexed in result.indexed.items():
                prelude = next((key for key, stack in stacks.items()
                                if stack is indexed.stack), None)
                if prelude is None or not isinstance(indexed.index, int) \
                        or indexed.index != self.step:
                    return f"its Indexed input {name!r} is not a prelude stack at the frame's step"
                self.indexed[name] = prelude
        for tensor in result_tensors(result):
            if (not isinstance(tensor, torch.Tensor) or tensor.is_meta
                    or _storage(tensor) not in allowed):
                return "its result holds a tensor made outside the recording"
        return None

    def _bound(self):
        """The recorded result, its Indexed inputs on this flush's stacks
        at this frame's step (the stacks are not held past the frame)."""
        stacks, self.stacks = self.stacks, {}
        if not self.indexed:
            return self.result
        indexed = dict(self.result.indexed)
        for name, prelude in self.indexed.items():
            indexed[name] = tailfuse.Indexed(stacks[prelude], self.step)
        return self.result._replace(indexed=indexed)
