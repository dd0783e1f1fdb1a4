"""
Fused shader-tail stage: per-pixel post-processing + SSAA downsample + uint8
quantization, in one kernel over output tiles.

Port of shaderflow_tpu/ops/tailfuse.py. A pixel program ends with
`sf.tail(fn, **inputs)`: `fn(tp)` is the scene's remaining per-pixel math in
the PLANE dialect (one value per channel, elementwise only — no neighbour
access), written with plain torch ops and Python operators:

    def tail(tp):
        r, g, b = tp.vec3("color")
        v = tp.astuv_x * (1 - tp.astuv_y)
        return r * v, g * v, b * v

The same function runs either on full-resolution tensors (eval_reference,
the plain version: CPU tensors) or traced once into an expression graph and
emitted into kernel K1's Triton template (ops/tailgen.py: CUDA tensors), so
both compute the same thing by construction.

Inputs are classified by make_spec: planes (Hr, Wr) [or (Hr, Wr, C) / a
tuple of channel planes], Row (Hr,), Col (Wr,), 0-d scalars, Table (a
small (bins, C) lookup table read by TailCtx.lookup), Indexed (one plane
of an (N, Hr, Wr) prelude stack, picked by a clipped index) and ColSampled
(row-interpolated (Hr, W_in) planes whose column interpolation happens
inside the tail). Planes may be float32 or bfloat16. The tail's color math
runs in tail_dtype(): float32, or bfloat16 under SHADERFLOW_TAIL_BF16=1
(TailCtx.plane/vec/f serve that dtype; rows, columns, coordinates and
geometry planes read with dtype=torch.float32 stay float32, and pooling,
masking and the u8 quantize run in float32 in either mode).

Two final forms: the exact-pooling regime (render == out * s) pools and
quantizes in K1 itself; the equal-resolution regime (render == out,
subsample s > 1, e.g. ssaa=1 with the default subsample 2) runs K1's
quantize=False form — the tail written as three bfloat16 planes — then the
reference's planar 3-tap stencil and the u8 quantize (final_equal_resolution).
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, NamedTuple

import torch

from shaderflow_tpu_torch import switches, tracing
from shaderflow_tpu_torch.ops.downsample import final_pass, quantize_u8
from shaderflow_tpu_torch.ops.rows import require_whole_rows
from shaderflow_tpu_torch.ops.stdlib import reciprocal


# --------------------------------------------------------------------------- #
# Transcendentals used by tail functions. The reference's polynomial forms,
# not torch.atan2 / torch.pow: the kernel and both reference paths compute
# exactly these.

def _f32(x):
    return x.to(torch.float32) if hasattr(x, "to") else torch.tensor(x, dtype=torch.float32)


def atan2(y, x):
    """Polynomial atan2, range (-pi, pi], max error ~1e-5 rad
    (shaderflow_tpu/ops/tailfuse.py:atan2). Matches IEEE arctan2 on
    infinities; treats -0.0 as +0.0. Computes in f32."""
    x = _f32(x)
    y = _f32(y)
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    # hi == lo: the both-infinite case (inf/inf is NaN) and exact t = 1
    t = torch.where((hi == lo) & (hi > 0.0), 1.0,
                    lo / torch.clamp(hi, min=1e-30))
    s = t * t
    # Minimax polynomial for atan(t), t in [0, 1]
    r = t * (0.99997726 + s * (-0.33262347 + s * (0.19354346
             + s * (-0.11643287 + s * (0.05265332 + s * -0.01172120)))))
    r = torch.where(ay > ax, float(math.pi / 2) - r, r)
    r = torch.where(x < 0.0, float(math.pi) - r, r)
    return torch.where(y < 0.0, -r, r)


def powf(x, p):
    """GLSL pow as exp(p * log(x)): x must be > 0 (x == 0 with p > 0 gives
    0). Computes in f32."""
    x = _f32(x)
    return torch.exp(p * torch.log(x))


def divide(x, value: float):
    """x / value for a constant `value`, as the reference's compiled program
    computes it: in float32 XLA folds the division into a product with the
    float32 reciprocal (stdlib.reciprocal); in bfloat16 it divides (and
    rounds the quotient)."""
    if x.dtype == torch.bfloat16:
        return x / value
    return x * reciprocal(value)


def tail_dtype() -> torch.dtype:
    """Compute dtype of a tail's COLOR math: SHADERFLOW_TAIL_BF16=1 runs the
    per-pixel color chain in bfloat16 (shaderflow_tpu/ops/tailfuse.py:
    tail_dtype). Coordinates, rows, columns, pooling and quantization stay
    float32. Read when a tail is traced or evaluated."""
    return torch.bfloat16 if os.environ.get("SHADERFLOW_TAIL_BF16") == "1" else torch.float32


# --------------------------------------------------------------------------- #
# Input wrappers

class Row(NamedTuple):
    """A per-row input: shape (render_height,) — broadcast along x."""
    value: Any


class Col(NamedTuple):
    """A per-column input: shape (render_width,) — broadcast along y."""
    value: Any


class Table(NamedTuple):
    """A small (bins, channels) lookup table (a 1-D table is one channel),
    read per pixel by TailCtx.lookup; K1 keeps it resident (tiny, cached)."""
    value: Any


class ColSampled(NamedTuple):
    """A texture input column-interpolated inside the tail.

    `planes` are row-interpolated (Hr, W_in) planes (the output of
    ops.sampling.sample_rows_planes_blocked); `u_line` (Wr,) holds
    normalized u in [0, 1]. Column c reads the 2-tap hat interpolation at
    position clip(u[c] * W_in - 0.5, 0, W_in - 1) (CLAMP), so the
    full-resolution sampled planes never reach device memory.
    `texels_per_px` sized the TPU kernel's column window; the port's
    gathers need no window and ignore it."""
    planes: Any
    u_line: Any
    texels_per_px: float


class ColSampledSpec(NamedTuple):
    planes: tuple          # (Hr, W_in) channel planes, float32 or bfloat16
    positions: Any         # (Wr,) float32 texel positions, clipped


class Indexed(NamedTuple):
    """One (Hr, Wr) plane of a stacked (N, Hr, Wr) prelude output, picked
    by `index` clipped to [0, N - 1]; the kernel reads it straight from the
    stack (no per-frame copy)."""
    stack: Any
    index: Any


class TailSpec(NamedTuple):
    """A deferred tail stage: returned by Frag.tail(), consumed by the engine."""
    fn: Callable[["TailCtx"], Any]
    planes: dict          # name -> tuple of (Hr, Wr) tensors (channel planes)
    rows: dict            # name -> (Hr,) tensor
    cols: dict            # name -> (Wr,) tensor
    scalars: dict         # name -> 0-d tensor
    tables: dict = {}     # name -> (bins, C) tensor
    colsampled: dict = {}  # name -> ColSampledSpec
    indexed: dict = {}    # name -> Indexed (index a Python int)


def make_spec(fn: Callable, render_height: int, render_width: int,
              **inputs) -> TailSpec:
    """Classify keyword inputs by shape into the TailSpec buckets."""
    planes, rows, cols, scalars = {}, {}, {}, {}
    tables, colsampled, indexed = {}, {}, {}
    for name, value in inputs.items():
        if isinstance(value, Indexed):
            stack = torch.as_tensor(value.stack)
            if tuple(stack.shape[1:]) != (render_height, render_width):
                raise ValueError(
                    f"Indexed input {name!r}: stack shape {tuple(stack.shape)} != "
                    f"(N, {render_height}, {render_width})")
            indexed[name] = Indexed(stack, value.index)
        elif isinstance(value, ColSampled):
            channels = tuple(torch.as_tensor(p) for p in value.planes)
            w_in = channels[0].shape[1]
            for channel in channels:
                if tuple(channel.shape) != (render_height, w_in):
                    raise ValueError(
                        f"ColSampled input {name!r}: plane shape "
                        f"{tuple(channel.shape)} != ({render_height}, {w_in})")
            u = torch.as_tensor(value.u_line).to(torch.float32).reshape(render_width)
            positions = torch.clamp(u * w_in - 0.5, 0.0, float(w_in - 1))
            colsampled[name] = ColSampledSpec(channels, positions)
        elif isinstance(value, Table):
            table = torch.as_tensor(value.value)
            tables[name] = table[:, None] if table.ndim == 1 else table
        elif isinstance(value, Row):
            rows[name] = torch.as_tensor(value.value).reshape(render_height)
        elif isinstance(value, Col):
            cols[name] = torch.as_tensor(value.value).reshape(render_width)
        elif isinstance(value, (tuple, list)):
            channels = tuple(torch.as_tensor(v) for v in value)
            for channel in channels:
                if tuple(channel.shape) != (render_height, render_width):
                    raise ValueError(
                        f"Tail input {name!r}: channel plane shape "
                        f"{tuple(channel.shape)} != render {(render_height, render_width)}")
            planes[name] = channels
        else:
            value = torch.as_tensor(value)
            if value.ndim == 0:
                scalars[name] = value
            elif value.ndim == 1:
                if value.shape[0] == render_height and render_height != render_width:
                    rows[name] = value
                elif value.shape[0] == render_width and render_height != render_width:
                    cols[name] = value
                else:
                    raise ValueError(
                        f"Ambiguous 1D tail input {name!r} (len {value.shape[0]}); "
                        f"wrap it in tailfuse.Row(...) or tailfuse.Col(...)")
            elif value.ndim == 2:
                planes[name] = (value,)
            elif value.ndim == 3:
                planes[name] = tuple(value[..., c] for c in range(value.shape[-1]))
            else:
                raise ValueError(f"Unsupported tail input {name!r} ndim={value.ndim}")
    return TailSpec(fn, planes, rows, cols, scalars, tables, colsampled, indexed)


def indexed_position(ix: Indexed) -> int:
    """An Indexed input's plane: its index clipped to [0, N - 1]. The index
    is a host value (the engine's frame loop hands Python ints), so picking
    the plane never waits on the device."""
    index = ix.index
    if isinstance(index, torch.Tensor):
        if index.device.type != "cpu":
            raise ValueError("Indexed takes a host index (a Python int), not a "
                             f"tensor on {index.device}: reading it back would "
                             "stall the frame loop")
        index = index.item()
    return min(max(int(index), 0), ix.stack.shape[0] - 1)


def colsampled_taps(positions: torch.Tensor, w_in: int, dtype) -> tuple:
    """The two hat taps of each column -> (x0 int64, x1 int64, w0, w1):
    texels x0 = floor(pos) and x0 + 1 (clamped; its weight is then 0) with
    weights max(1 - |pos - x|, 0), the dense reference's expression,
    rounded through `dtype` (the plane's) when that is bfloat16."""
    x0f = torch.floor(positions)
    w0 = torch.clamp(1.0 - torch.abs(positions - x0f), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(positions - (x0f + 1.0)), min=0.0)
    if dtype == torch.bfloat16:
        w0 = w0.to(torch.bfloat16).to(torch.float32)
        w1 = w1.to(torch.bfloat16).to(torch.float32)
    x0 = x0f.to(torch.int64)
    return x0, torch.clamp(x0 + 1, max=w_in - 1), w0, w1


def materialize_colsampled(spec: TailSpec) -> dict:
    """Column interpolation of the ColSampled inputs -> full (Hr, Wr) f32
    channel planes: plane[:, x0] * w0 + plane[:, x1] * w1. Equal to the
    reference's dense product with the hat-weight matrix: the same two
    nonzero products (exact in f32 for bf16 planes), summed once."""
    extra = {}
    for name, cs in spec.colsampled.items():
        w_in = cs.planes[0].shape[1]
        x0, x1, w0, w1 = colsampled_taps(cs.positions, w_in, cs.planes[0].dtype)
        extra[name] = tuple(plane[:, x0].to(torch.float32) * w0
                            + plane[:, x1].to(torch.float32) * w1
                            for plane in cs.planes)
    return extra


def materialize_indexed(spec: TailSpec) -> dict:
    """Each Indexed input's (Hr, Wr) plane of its stack (a view)."""
    return {name: (ix.stack[indexed_position(ix)],) for name, ix in spec.indexed.items()}


# --------------------------------------------------------------------------- #
# The tail context: what the tail function sees

class TailCtx:
    """Handed to the tail function. Values are 2D (rows, cols) planes
    (full-resolution tensors on the float32 plain path, symbolic values
    while ops/tailgen.py traces the kernel or a bfloat16 tail); the
    function cannot tell which. Render sizes and aspect are Python
    numbers; `dtype` is the color dtype (tail_dtype)."""

    def __init__(self, planes, rows, cols, scalars, row_index, col_index,
                 render_height: int, render_width: int, aspect: float,
                 tables=None):
        self._planes = planes      # name -> tuple of 2D values
        self._rows = rows          # name -> (Hr, 1) column vector
        self._cols = cols          # name -> (1, Wr) row vector
        self._scalars = scalars
        self._tables = tables or {}  # name -> (bins, C) tensor (symbolic when traced)
        self._row_index = row_index  # (Hr, Wr) f32 global row index
        self._col_index = col_index
        self.render_height = render_height
        self.render_width = render_width
        self.aspect = aspect
        self.dtype = tail_dtype()

    # -- inputs --------------------------------------------------------------

    def plane(self, name: str, channel: int = 0, dtype=None):
        """A channel plane in the color dtype, or in an explicit `dtype`:
        GEOMETRY planes (fields gating hard edges) read float32 even in the
        bfloat16 mode."""
        return self._planes[name][channel].to(dtype or self.dtype)

    def vec(self, name: str) -> tuple:
        return tuple(p.to(self.dtype) for p in self._planes[name])

    def channels(self, name: str) -> int:
        """The number of planes of input `name`."""
        return len(self._planes[name])

    # Aliases that make the intent explicit where a tail reads its inputs
    def vec2(self, name: str) -> tuple:
        return self.vec(name)

    def vec3(self, name: str) -> tuple:
        return self.vec(name)

    def row(self, name: str):
        """Per-row input broadcast to the working shape (f32)."""
        return torch.broadcast_to(self._rows[name].to(torch.float32),
                                  self._row_index.shape)

    def col(self, name: str):
        return torch.broadcast_to(self._cols[name].to(torch.float32),
                                  self._col_index.shape)

    def scalar(self, name: str):
        return self._scalars[name]

    def f(self, x):
        """Cast into the color dtype: tails wrap the float32 factors they
        apply to the color chain, so that the chain stays in that dtype."""
        return x.to(self.dtype) if hasattr(x, "to") else torch.tensor(x, dtype=self.dtype)

    def lookup(self, name: str, index_plane, channel: int = 0):
        """Nearest lookup table[clip(trunc(index), 0, bins - 1), channel] of
        a Table input, in float32 (tailfuse.py:323-335's clip and select;
        a select of one value per pixel is a gather)."""
        table = self._tables[name]
        if not isinstance(table, torch.Tensor):   # traced: kernel K1 reads it in-kernel
            return table.lookup(index_plane, channel)
        index = torch.clamp(index_plane.to(torch.int32), 0, table.shape[0] - 1)
        return table[:, channel].to(torch.float32)[index.to(torch.int64)]

    # -- coordinates (ssaa-resolution, GL conventions) ------------------------
    # (i + 0.5) * (1 / n) with the f32 reciprocal, not (i + 0.5) / n: the
    # reference's compiled coordinates (XLA folds a division by a constant
    # into that product), and one value on every path — eager torch on the
    # card also divides by a host scalar through its reciprocal, while K1
    # and torch on the CPU would round a true quotient.

    @property
    def astuv_x(self):
        return (self._col_index + 0.5) * reciprocal(self.render_width)

    @property
    def astuv_y(self):
        """astuv y grows UP the screen: row 0 (top) is y near 1."""
        return 1.0 - (self._row_index + 0.5) * reciprocal(self.render_height)

    @property
    def agluv_x(self):
        return self.astuv_x * 2.0 - 1.0

    @property
    def agluv_y(self):
        return self.astuv_y * 2.0 - 1.0

    @property
    def gluv_x(self):
        return self.agluv_x * self.aspect

    @property
    def gluv_y(self):
        return self.agluv_y


# --------------------------------------------------------------------------- #
# Plain (unfused) evaluation — the semantic definition K1 is held against

def spec_device(spec: TailSpec) -> torch.device:
    """The device of a spec's tensor inputs (CPU when it has none)."""
    tensors = [*spec.rows.values(), *spec.cols.values(), *spec.scalars.values(),
               *(c for channels in spec.planes.values() for c in channels),
               *(ix.stack for ix in spec.indexed.values()),
               *(cs.positions for cs in spec.colsampled.values()),
               *spec.tables.values()]
    return tensors[0].device if tensors else torch.device("cpu")


# How far a bfloat16 tail's eager frames (eval_reference(eager=True)) may
# sit from the reference's: (max u8 steps, min PSNR in dB). Measured on the
# CPU against the JAX fused path at 128x72 and 96x54: 1-2 steps on 8-23 %
# of values, 54.5-58.9 dB (tests/test_torch_bf16.py); one step of room for
# a 1080p frame's rarer tails. A wrong op or operand falls far below.
EAGER_BF16_BAR = (3, 50.0)


def eval_reference(spec: TailSpec, render_height: int, render_width: int,
                   aspect: float, eager: bool = False) -> torch.Tensor:
    """Run the tail on full-resolution tensors -> (Hr, Wr, 3) float32.

    In float32 the tail function runs on the tensors themselves. In
    bfloat16 (tail_dtype) it runs through its traced graph
    (tailgen.evaluate): every bfloat16 op computed in float32 and rounded,
    typed by JAX's promotion rules, not torch's — the values kernel K1
    computes and the reference's compiled program holds.

    eager=True runs the tail function on the tensors in bfloat16 too, with
    no tracer: the 0-d scalars enter as (1, 1) tensors, so that torch
    promotes a bfloat16 value with them to float32 as JAX does. Torch
    rounds every bfloat16 op, also where the reference's upcast reads the
    unrounded value, so its frames may sit one u8 step from K1's: a check
    of the tracer that does not share its typing or rounding rules, held
    to EAGER_BF16_BAR."""
    device = spec_device(spec)
    rows = {k: v.reshape(-1, 1) for k, v in spec.rows.items()}
    cols = {k: v.reshape(1, -1) for k, v in spec.cols.items()}
    shape = (render_height, render_width)
    row_index = torch.arange(render_height, dtype=torch.float32,
                             device=device)[:, None].expand(shape)
    col_index = torch.arange(render_width, dtype=torch.float32,
                             device=device)[None, :].expand(shape)
    sampled = materialize_colsampled(spec)
    planes = {**spec.planes, **sampled, **materialize_indexed(spec)}
    tables = {name: table.to(device) for name, table in spec.tables.items()}
    bf16 = tail_dtype() == torch.bfloat16
    if bf16 and not eager:
        from shaderflow_tpu_torch.ops import tailgen
        env = {("row_index", "", 0): row_index, ("col_index", "", 0): col_index}
        for name, channels in planes.items():
            kind = "colsampled" if name in sampled else "plane"
            env.update({(kind, name, c): plane for c, plane in enumerate(channels)})
        env.update({("row", name, 0): value for name, value in rows.items()})
        env.update({("col", name, 0): value for name, value in cols.items()})
        env.update({("scalar", name, 0): value for name, value in spec.scalars.items()})
        env.update({("table", name, 0): value for name, value in tables.items()})
        graph, outputs = tailgen.trace(spec, render_height, render_width, aspect)
        result = tailgen.evaluate(graph, outputs, env)
    else:
        scalars = ({k: v.reshape(1, 1) for k, v in spec.scalars.items()} if bf16
                   else spec.scalars)
        ctx = TailCtx(planes, rows, cols, scalars, row_index, col_index,
                      render_height, render_width, aspect, tables=tables)
        result = spec.fn(ctx)
    planes = [torch.broadcast_to(torch.as_tensor(p, dtype=torch.float32,
                                                 device=device), shape)
              for p in result[:3]]
    return torch.stack(planes, dim=-1)


def tail_plain(spec: TailSpec, render_height: int, render_width: int,
               out_height: int, out_width: int, subsample: int,
               aspect: float, eager: bool = False) -> torch.Tensor:
    """Plain version of kernel K1: eval_reference + final_pass."""
    rgb = eval_reference(spec, render_height, render_width, aspect, eager)
    return final_pass(rgb, out_height, out_width, int(subsample))


# --------------------------------------------------------------------------- #
# Kernel K1 and its dispatch

def fused_tail_final(spec: TailSpec, render_height: int, render_width: int,
                     out_height: int, out_width: int, subsample: int,
                     aspect: float, out: torch.Tensor = None,
                     quantize: bool = True) -> torch.Tensor:
    """The tail + s x s box pool + GL u8 quantize -> (out_h, out_w, 3) u8,
    written into `out` when given (e.g. one frame's slot of a batch).

    quantize=False (s = 1 only; the equal-resolution regime) writes the
    tail's three planes as bfloat16 (round to nearest even), no pool and
    no quantize -> (3, out_h, out_w) bf16, into `out` when given; the
    caller runs the stencil (final_equal_resolution).

    Requires the exact-pooling regime: render == out * subsample. Kernel
    K1 (Triton, generated by ops/tailgen.py) for CUDA inputs; the plain
    version (tail_plain, planes_plain) for CPU inputs, declared to the cost
    walker as the kernel's launch (tailgen.declared_plain).
    `fused_tail_final.launches` counts launches of the u8 form,
    `fused_tail_final.planes_launches` those of the quantize=False form,
    `fused_tail_final.bf16_launches` those of either form traced with the
    bfloat16 color chain (tail_dtype)."""
    s = int(subsample)
    if (render_height, render_width) != (out_height * s, out_width * s):
        raise ValueError(
            f"fused_tail_final needs render == out * subsample, got render "
            f"{render_width}x{render_height}, out {out_width}x{out_height}, s={s}")
    if not quantize and s != 1:
        raise ValueError(f"fused_tail_final(quantize=False) runs at s = 1, got s={s}")
    device = out.device if out is not None else spec_device(spec)
    if device.type == "cpu":
        from shaderflow_tpu_torch.ops import tailgen
        with tailgen.declared_plain(spec, render_height, render_width, out_height,
                                    out_width, s, aspect, quantize):
            if quantize:
                result = tail_plain(spec, render_height, render_width, out_height,
                                    out_width, s, aspect)
            else:
                result = planes_plain(spec, render_height, render_width, aspect)
        if out is None:
            return result
        out.copy_(result)
        return out
    from shaderflow_tpu_torch.ops import tailgen
    with tracing.span("tail.prepare"):
        launch = tailgen.prepare(spec, render_height, render_width, out_height,
                                 out_width, s, aspect, device, quantize=quantize)
    if out is None:
        shape, dtype = (((out_height, out_width, 3), torch.uint8) if quantize
                        else ((3, out_height, out_width), torch.bfloat16))
        out = torch.empty(shape, dtype=dtype, device=device)
    launch(out)
    if quantize:
        fused_tail_final.launches += 1
    else:
        fused_tail_final.planes_launches += 1
    if tail_dtype() == torch.bfloat16:
        fused_tail_final.bf16_launches += 1
    return out


fused_tail_final.launches = 0
fused_tail_final.planes_launches = 0
fused_tail_final.bf16_launches = 0


def planes_plain(spec: TailSpec, render_height: int, render_width: int,
                 aspect: float) -> torch.Tensor:
    """Plain version of K1's quantize=False form: the tail's three float32
    planes rounded to bfloat16 -> (3, Hr, Wr)."""
    rgb = eval_reference(spec, render_height, render_width, aspect)
    return rgb.permute(2, 0, 1).to(torch.bfloat16)


def stencil_weight(subsample: int) -> float:
    """The equal-resolution stencil's side weight m (the center is 1 - 2m):
    sum_k max(0, -0.5 + (k + 0.5) / s) / s, as a bfloat16 value (the
    reference multiplies bf16 planes by it as a weakly typed constant)."""
    s = int(subsample)
    m = sum(max(0.0, -0.5 + (k + 0.5) / s) for k in range(s)) / s
    return float(torch.tensor(m).to(torch.bfloat16).float())


def final_equal_resolution(planes: torch.Tensor, subsample: int,
                           out: torch.Tensor = None) -> torch.Tensor:
    """The reference's equal-resolution final pass on K1's (3, H, W) bf16
    planes (shaderflow_tpu/ops/tailfuse.py:779-807): per plane the
    separable [m, 1 - 2m, m] stencil with edge replication, rows then
    columns, then quantize_u8 -> (H, W, 3) u8 (into `out` when given). The
    three planes go through each op together (one launch per op).

    Arithmetic as the reference's compiled stencil does it (its optimized
    program, on XLA:CPU): every product and sum rounded to bfloat16, but
    the last sum in float32 — the bf16 rounding of the final sum folds
    into quantize_u8's upcast. Torch's bfloat16 ops compute in float32 and
    round each result, on the CPU and on the card alike."""
    require_whole_rows("final_equal_resolution")
    m = stencil_weight(subsample)
    center = 1.0 - 2.0 * m
    channels, height, width = planes.shape
    if out is None:
        out = torch.empty((height, width, channels), dtype=torch.uint8,
                          device=planes.device)
    up = torch.cat([planes[:, :1], planes[:, :-1]], dim=1)
    down = torch.cat([planes[:, 1:], planes[:, -1:]], dim=1)
    rows = center * planes + m * (up + down)
    left = torch.cat([rows[..., :1], rows[..., :-1]], dim=2)
    right = torch.cat([rows[..., 1:], rows[..., -1:]], dim=2)
    mixed = (center * rows).to(torch.float32) + (m * (left + right)).to(torch.float32)
    out.copy_(quantize_u8(mixed).permute(1, 2, 0))
    return out


def backend_supports_fusion(device="cuda") -> bool:
    """Whether K1 runs for tensors on `device`: on a CUDA card; the CPU
    runs its plain version (fused_tail_final's dispatch). False under
    SHADERFLOW_NO_TAILFUSE=1, as the JAX package's is, since the switch
    takes K1 out of the dispatch (switches.reference_tail)."""
    return not switches.no_tailfuse() and torch.device(device).type == "cuda"


def supports_fusion(render_height: int, render_width: int,
                    out_height: int, out_width: int, subsample: int) -> bool:
    """K1 handles the exact-pooling SSAA regime (render is the output times
    the subsample factor) — the graded configurations."""
    s = int(subsample)
    return s >= 1 and (render_height, render_width) == (out_height * s, out_width * s)


_PLANES: dict = {}


def _frame_planes(height: int, width: int, device: torch.device) -> torch.Tensor:
    """One (3, H, W) bf16 buffer per size, device and stream, reused by
    every frame: frames on one stream run in order, so frame k + 1's K1 (d)
    writes it only after frame k's stencil read it. The shards of a mesh
    on one card render on streams of their own, each with its buffer."""
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    key = (height, width, str(device), stream)
    if key not in _PLANES:
        if len(_PLANES) >= 8:
            _PLANES.pop(next(iter(_PLANES)))
        _PLANES[key] = torch.empty((3, height, width), dtype=torch.bfloat16, device=device)
    return _PLANES[key]


def run_tail_final(spec: TailSpec, render_height: int, render_width: int,
                   out_height: int, out_width: int, subsample: int,
                   aspect: float, out: torch.Tensor = None) -> torch.Tensor:
    """The final pass of a tail, by regime: the exact-pooling regime runs
    K1 (u8); the equal-resolution regime (render == out, s > 1) runs K1's
    quantize=False form into a reused set of bf16 planes, then
    final_equal_resolution; any other regime (the general path: ssaa 1.5,
    3, 4, realtime ssaa < 1) evaluates the tail with eval_reference and
    runs the plain final pass (downsample.final_pass: the banded general
    resample), on the card as on the CPU, as the reference does on every
    backend. Under SHADERFLOW_NO_TAILFUSE=1 every regime takes that route
    on CPU tensors and raises on the card (switches.reference_tail)."""
    with tracing.span("tail"):
        device = out.device if out is not None else spec_device(spec)
        reference = switches.reference_tail(device)
        if not reference and supports_fusion(render_height, render_width, out_height,
                                             out_width, subsample):
            return fused_tail_final(spec, render_height, render_width, out_height,
                                    out_width, subsample, aspect, out=out)
        if (not reference and (render_height, render_width) == (out_height, out_width)
                and int(subsample) > 1):
            planes = fused_tail_final(spec, render_height, render_width, out_height,
                                      out_width, 1, aspect, quantize=False,
                                      out=_frame_planes(out_height, out_width, device))
            return final_equal_resolution(planes, subsample, out=out)
        frame = tail_plain(spec, render_height, render_width, out_height,
                           out_width, subsample, aspect)
        if out is None:
            return frame
        out.copy_(frame)
        return out
