"""
Multi-device exports: each flush sharded over a 1-D mesh of torch devices.

Port of shaderflow_tpu/parallel/mesh.py. The reference splits a batch over
the devices of one jax mesh from one process; so does the port: one
process and one thread drive N shards, each a torch device. A mesh may name
a device more than once: N shards of one card, each on a CUDA stream of its
own, or N times the CPU (the counterpart of XLA's forced host device count).

Frames of a scene without temporal feedback are independent given their
uniforms and textures (all small, and copied to every shard), so the frame
path (flush_frames, the counterpart of shard_frame_renderer) splits a
batch's F frames into N contiguous parts: each shard uploads its part's
uniforms and stream snapshots, runs the batch preludes on its frames and
renders them into a tensor of its own. Nothing crosses between shards, and
a count that does not divide N needs no padding (no compiled shape).

A program with temporal feedback (MotionBlur, Life) reads frame k - 1 in
frame k, so its scene takes the row path (flush_rows, the counterpart of
shard_row_renderer): the frame loop stays global, and every shard renders
the rows [i H / N, (i + 1) H / N) of each program whose height H divides N
(a program whose height does not is rendered whole on every shard, as the
reference replicates such leaves). After each layer the windows are
gathered into every shard's texture (an all-gather), so the next reads (a
neighbour stencil, the ring of past frames, a feedback sample) see the
whole texture; each shard then runs the final pass on its output rows. A
fragment that reaches an op inexact on a window of rows (ops/rows.py lists
them) makes its program render whole on every shard from then on. Every
shard keeps its own rings, whole, between flushes.
"""

from __future__ import annotations

from typing import Optional

import torch

from shaderflow_tpu_torch import logger, resolve_device
from shaderflow_tpu_torch.engine import FrameUniforms, ShardedFrames
from shaderflow_tpu_torch.ops import tailfuse
from shaderflow_tpu_torch.ops.rows import WholeRows, slab
from shaderflow_tpu_torch.shader import make_coords


class Mesh(tuple):
    """A 1-D mesh: the ordered devices of its shards (a device may repeat)."""

    def __new__(cls, devices):
        return super().__new__(cls, tuple(resolve_device(device) for device in devices))

    @property
    def size(self) -> int:
        return len(self)


def available_devices(device="cuda") -> list[torch.device]:
    """The devices a run on `device` shards over: the visible cards in
    order, or the CPU device."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", index) for index in range(torch.cuda.device_count())]
    return [device]


def frame_mesh(n_devices: Optional[int] = None, devices=None, device="cuda") -> Mesh:
    """A 1-D mesh over the first n of `devices` (by default all of
    available_devices(device))."""
    pool = list(devices) if devices is not None else available_devices(device)
    if n_devices:
        if n_devices > len(pool):
            raise ValueError(f"A mesh of {n_devices} devices asked of {len(pool)}")
        pool = pool[:n_devices]
    return Mesh(pool)


def supports_frame_sharding(scene) -> bool:
    """Frame-parallel rendering is exact iff no program carries temporal
    state between frames."""
    from shaderflow_tpu_torch.shader import ShaderProgram
    return all(module.texture.temporal == 1 for module in scene.modules
               if isinstance(module, ShaderProgram))


def frame_parts(count: int, shards: int) -> list[tuple[int, int]]:
    """`count` frames as `shards` contiguous (first, end) parts, the first
    count % shards of them one frame longer."""
    base, extra = divmod(count, shards)
    parts, first = [], 0
    for index in range(shards):
        end = first + base + (index < extra)
        parts.append((first, end))
        first = end
    return parts


def row_window(height: int, shards: int, index: int) -> tuple[int, int]:
    """Shard `index`'s rows of a height that divides `shards`."""
    return index * height // shards, (index + 1) * height // shards


# --------------------------------------------------------------------------- #
# The frame path

def flush_frames(engine, count: int) -> ShardedFrames:
    """Render the captured frames split over the mesh's shards (no program
    is temporal): the engine's frame path (RenderEngine.render_parts) over
    the shards' states and their contiguous parts of the batch."""
    shards = engine.shards()
    out_width, out_height = engine.scene._final.texture.resolution
    parts = engine.render_parts(shards, frame_parts(count, len(shards)), count)
    return ShardedFrames([(part.state, slice(part.first, part.end), slice(None), part.out)
                          for part in parts], (count, out_height, out_width, 3))


# --------------------------------------------------------------------------- #
# The row path

def flush_rows(engine, count: int) -> ShardedFrames:
    """Render the captured frames of a scene with temporal feedback, every
    shard on its rows of every frame (the module docstring), through the
    engine's frame steps (RenderEngine.program_matrix, fuses, fuse_tail,
    store_layer, end_frame)."""
    shards = engine.shards()
    n = len(shards)
    scene = engine.scene
    out_width, out_height = scene._final.texture.resolution
    if out_height % n:
        raise ValueError(f"Row-sharded flush: output height {out_height} does not divide "
                         f"{n} shards")
    main = scene.shader
    subsample = int(scene.subsample)
    render_width, render_height = main.texture.resolution
    # The final pass reads only the main program's rows under its output
    # rows at render == output x subsample (subsample 1 included)
    local_final = (render_height, render_width) == (out_height * subsample,
                                                    out_width * subsample)
    spec, indices, parts = engine.stage(shards, [(0, count)] * n, count, out_height // n)

    for step, frame_index in enumerate(indices):
        frames = []
        for part in parts:
            with part.state.context():
                textures = engine._frame_textures(frame_index, step, part.state)
            textures.update(part.state.carry)
            frames.append((FrameUniforms(part.rows[step], spec), textures))
        fused = [None] * n
        for index, program in enumerate(engine._programs()):
            height = program.texture.resolution[1]
            matrices = []
            for shard, (_, textures) in zip(shards, frames):
                with shard.context():
                    matrices.append(engine.program_matrix(program, textures, shard))
            for layer in range(program.texture.layers):
                sharded = height % n == 0 and program.name not in engine._whole_rows
                for part, (uniforms, textures), matrix in zip(parts, frames, matrices):
                    shard = part.state
                    with shard.context():
                        result, coords = _render_layer(engine, part, index, program, layer,
                                                       uniforms, textures, spec, step,
                                                       frame_index)
                        if isinstance(result, tailfuse.TailSpec) and engine.fuses(program):
                            # Only a whole render returns a tail: K1 writes
                            # the whole frame, the shard keeps its rows
                            fused[shard.index] = torch.empty(
                                (out_height, out_width, 3), dtype=torch.uint8,
                                device=shard.device)
                            engine.fuse_tail(result, coords, fused[shard.index])
                            continue
                        first, end = engine.store_layer(matrix, layer, program, result, coords)
                    shard.windows[program.name] = (first, end)
                    shard.rows_rendered[program.name] = (
                        shard.rows_rendered.get(program.name, 0) + end - first)
                last_read = (program is main and layer == program.texture.layers - 1
                             and program.texture.temporal == 1 and local_final)
                if sharded and not last_read and fused[0] is None:
                    _all_gather(shards, matrices, layer,
                                [row_window(height, n, shard.index) for shard in shards])
            for matrix in matrices:
                matrix.roll()
        for part, (_, textures) in zip(parts, frames):
            shard = part.state
            first, end = row_window(out_height, n, shard.index)
            with shard.context():
                if fused[shard.index] is not None:
                    part.out[step].copy_(fused[shard.index][first:end])
                else:
                    engine.end_frame(textures, part.out[step], rows=(first, end))
    return ShardedFrames([(part.state, slice(0, count),
                           slice(*row_window(out_height, n, part.state.index)), part.out)
                          for part in parts], (count, out_height, out_width, 3))


def _render_layer(engine, part, index: int, program, layer: int, uniforms, textures: dict,
                  spec, step: int, frame_index: int):
    """One layer of a program on a shard's part -> (result, the
    coordinates it rendered at): its rows when the program is sharded,
    else whole. An op that needs whole rows (ops/rows.py) makes the
    program whole for the rest of the build, and the layer renders
    again."""
    shard = part.state
    width, height = program.texture.resolution
    n = len(engine._shards)
    while True:
        rows = None
        coords = shard.program_coords[index]
        if height % n == 0 and program.name not in engine._whole_rows:
            rows = row_window(height, n, shard.index)
            if (index, rows) not in shard.slabs:
                shard.slabs[(index, rows)] = make_coords(height, width, engine.scene.aspect_ratio,
                                                         shard.device, rows=rows)
            coords = shard.slabs[(index, rows)]
        ctx = engine.frame_context(part.rows[step], spec, step, frame_index, part.per_batch,
                                   part.invariant, shard, coords=coords, layer=layer,
                                   textures=textures, uniforms=uniforms)
        try:
            with slab(rows):
                return program.render_layer(ctx), coords
        except WholeRows as reason:
            engine._whole_rows.add(program.name)
            logger.info(f"Row-sharded export: {program.name} renders whole rows on every "
                        f"shard ({reason})")


def _all_gather(shards: list, matrices: list, layer: int, windows: list) -> None:
    """Each shard's window of `layer` in temporal slot 0 (written this
    frame) copied into every other shard's texture. On one card a copy runs
    on the receiving shard's stream after the sending shard's render; across
    cards torch runs it on the sender's stream and orders the receiver's
    after it."""
    events = []
    for shard in shards:
        event = None
        if shard.stream is not None:
            event = torch.cuda.Event()
            event.record(shard.stream)
        events.append(event)
    for receiver, target in zip(shards, matrices):
        for sender, source, event, (first, end) in zip(shards, matrices, events, windows):
            if sender is receiver:
                continue
            into = target.data[target.slot(0), layer, first:end]
            data = source.data[source.slot(0), layer, first:end]
            if receiver.stream is None:
                into.copy_(data)
            elif receiver.device == sender.device:
                receiver.stream.wait_event(event)
                # Read on the receiver's stream: the sender's memory is not
                # reused before the copy is done
                source.data.record_stream(receiver.stream)
                with receiver.context():
                    into.copy_(data, non_blocking=True)
            else:
                with receiver.context(), sender.context():
                    into.copy_(data, non_blocking=True)
