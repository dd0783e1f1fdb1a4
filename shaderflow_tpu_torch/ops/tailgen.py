"""
Kernel K1: the scene's tail function traced into a Triton tile template.

Replaces shaderflow_tpu/ops/tailfuse.py:fused_tail_final (the Pallas TPU
kernel dispatched by run_tail_final), in all its forms: planes (float32 or
bfloat16, upcast at load), rows, columns and scalars; Indexed planes (read
from the prelude stack at the clipped index: the wrapper hands the kernel
the plane's own base pointer); ColSampled planes (the 2-tap hat
interpolation along columns of row-interpolated (Hr, W_in) planes,
computed per pixel from the column's position); Table inputs (small
(bins, C) float32 tables read by a clipped gather, which stays in L1: the
same value the reference's clip and select-accumulate picks); s x s box
pooling, GL u8 quantization, masked partial tiles; and the quantize=False
form (s = 1, the equal-resolution regime), which stores the three results
as bfloat16 planes, rounded to nearest even, instead of u8 pixels.

Why Triton: the body is user Python (a different tail per scene), a fused
elementwise pass plus a tiny s x s reduction and a quantize — what Triton
compiles in-process at first use. A CUDA C++ version would need an nvcc
build per tail.

How: `trace` runs the tail function once on a symbolic TailCtx whose
planes, rows, columns, scalars and coordinate indices are `Sym` proxies.
Python operators and the torch functions in _TORCH_OPS (dispatched through
`__torch_function__`) record an expression graph. `generate` emits that
graph into a fixed tile template that owns everything else: the loads of
the inputs the graph reads, the row/column indices behind the coordinate
properties, the s x s box pool, the 1/s^2 average, floor(clamp(c, 0, 1) *
255 + 0.5), and the stores into the frame's (H, W, 3) slot. `evaluate`
runs the same graph with torch ops (tests hold it equal to the direct
call).

The tile, designed for Hopper: one program owns BH x BW output pixels
and reads their render block once, as s passes of BH render rows of
BW * s contiguous columns (where s is a power of two; else s strided
column passes). Plane channels load through block pointers (16-byte
vectors along the row; tensor descriptors, the copy engine, measured
slower: PERF.md). Every value is computed at its own rank: a row
input loads as [BH, 1], a column as [1, BWC], a scalar and a constant as
0-d values, and the nodes that read only those are computed at that rank,
once a program (0-d) or once a column block (hoisted out of the row
passes), broadcast in registers where they meet a plane. The horizontal
pool is a reshape to [BH, BW, s] and a sum in registers, the vertical one
the sum over the row passes. The u8 frame is written as 32-bit words, four
pixels in three words, where the row pitch and the frame's base are
multiples of 4 bytes (one byte store a channel otherwise). The tile's
height follows from the graph (tile_shape: the live values a thread holds
at the fullest point of the body, weighted by rank, within a register
budget) so that every graded tail compiles with no spill.

Bound on this card: bytes of the SSAA-resolution input planes (each read
exactly once; the output is 1/s^2 as many pixels at 3 bytes) for the
visualizer and fractal tails, the ALU instructions of the graph for the
piano roll's; the full-resolution tail intermediates of the plain path
never reach device memory. A ColSampled plane is read at two texels per
pixel, but its (Hr, W_in) rows are narrower than the render (W_in <= Wr)
and neighbouring pixels share texels, so its device-memory bytes stay
those of the row planes; the TPU kernel's 128-column window prefetch is
not needed for that (gathers go through L1/L2).

ColSampled weights are max(1 - |pos - x|, 0) for x = floor(pos) and
floor(pos) + 1 (the dense reference's expression, not 1 - frac), rounded
to bf16 for bf16 planes; the two products are exact in f32 for bf16
operands and are summed once, so the kernel equals
tailfuse.materialize_colsampled bit for bit.

Host cost: tracing and generating a large tail (the piano roll's: 449
nodes, 57 inputs) takes milliseconds per frame, so prepare() keeps the
traced kernel per tail and input structure (_tail_key): a tail is a pure
function of its code, its closure values and the kinds, names, channel
counts and dtypes of its inputs. Tails whose closure holds a value the key
cannot hash (anything but numbers, strings, tuples of them and numpy
arrays) are traced every frame.

bfloat16 tails (tailfuse.tail_dtype, SHADERFLOW_TAIL_BF16=1): the tracer
types every node as JAX does (Graph: float32, bfloat16, weak Python
numbers, bool) and the template computes each bfloat16 op in float32, then
rounds it to bfloat16 (.to(tl.bfloat16)): the value the reference's
compiled program holds, and the plain version on the card (torch computes
its bfloat16 ops so). An upcast of a rounded op, an output included, reads
the unrounded float32 value, as XLA drops a convert to bfloat16 followed by
a convert back. T1 (shaderflow_tpu_torch/tools/probe_bf16_ops.py) records
which native bfloat16 forms match that on the card (BF16_PROBE_OK).

Bound on this card, for the cost walker (tools/flopcount.py): each
launch declares its graph's ops by class (ALU; sqrt, exp and log on the
special-function units), each counted once at its rank (once a render
pixel, column or row, or once), and its bytes (kernel_cost).

Float rules: launched with enable_fp_fusion=False (no FMA contraction, so
no bfloat16 product skips its rounding inside a fused multiply-add),
division as div_rn and sqrt as sqrt_rn (IEEE-rounded, as torch's;
Triton's default `/` and tl.sqrt are approximate on sm_90 and differ from
torch on about a quarter of random f32 inputs), min/max
propagating NaN (as torch.maximum/minimum), exp/log from libdevice (as
torch's CUDA expf/logf), and fmod kept off a dividend smaller than the
divisor (Triton's libdevice flushes subnormals; the remainder of such a
dividend is itself): the kernel stays within one u8 step of the plain
path (differences come only from the order of the s x s sum).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from shaderflow_tpu_torch.ops.tailfuse import (TailCtx, TailSpec, indexed_position, spec_device,
                                               tail_dtype)
from shaderflow_tpu_torch.tools import flopcount


# --------------------------------------------------------------------------- #
# Tracing

# Value kinds in JAX's promotion order (jnp.promote_types over the types a
# tail meets): "b" bool < "w" a weakly typed float (Python numbers, and what
# is computed from them alone) < "h" bfloat16 < "f" float32. A bfloat16
# value combined with a Python number stays bfloat16, combined with a
# strong float32 value (a 0-d scalar input too) becomes float32: JAX's
# rules, not torch's (torch keeps bf16_tensor * f32_0d_tensor in bfloat16).
_RANK = {"b": 0, "w": 1, "h": 2, "f": 3}
_LOGIC = ("and", "or", "not")
_COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")
# Nodes whose value is one of their operands' (already rounded) values, or
# computed and rounded inside the node: their upcast is exact. A cast to
# bfloat16 ("bf16": tp.plane, tp.vec, tp.f of a float32 value) is one: XLA
# keeps an explicit convert pair and rounds, as it does not for an op's
# result (Graph.rounds)
_SELECTING = ("input", "where", "mod", "full", "lookup", "float", "bf16")
_SFU_OPS = ("sqrt", "exp", "log")
_FREE_OPS = ("input", "float", "bf16", "full")


def promote(*kinds: str) -> str:
    return max(kinds, key=_RANK.__getitem__)


def round_bf16(value: float) -> float:
    """A Python number rounded to the nearest bfloat16 (ties to even)."""
    return float(torch.tensor(float(value), dtype=torch.float32).to(torch.bfloat16))


class Graph:
    """Expression graph of one tail call. nodes[i] = (op, args, kind):
    args are node indices (int) for symbolic operands, or ("const", value)
    for Python scalars; kind is one of _RANK's ("f" float32, "h" bfloat16,
    "w" weak float, "b" bool)."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self.inputs: dict[tuple, int] = {}   # (kind, name, channel) -> node
        self.tables: dict[str, tuple] = {}   # Table name -> (bins, channels) read

    def add(self, op: str, args: tuple, kind: str) -> "Sym":
        self.nodes.append((op, args, kind))
        return Sym(self, len(self.nodes) - 1)

    def input(self, key: tuple, kind: str = "f") -> "Sym":
        if key not in self.inputs:
            self.inputs[key] = self.add("input", key, kind).index
        return Sym(self, self.inputs[key])

    def kind(self, operand) -> str:
        if isinstance(operand, tuple):
            return "b" if isinstance(operand[1], bool) else "w"
        return self.nodes[operand][2]

    def compute_kind(self, index: int) -> str:
        """The type node `index` computes in: its operands promoted (a
        compare's operands, a where's two branches); a cast reads its
        operand in float32."""
        op, args, kind = self.nodes[index]
        if op in _COMPARE:
            return promote(*(self.kind(a) for a in args))
        if op in ("float", "bf16"):
            return "f"
        return kind

    def rounds(self, index: int) -> bool:
        """Whether node `index` is a bfloat16 op computed in float32 and
        then rounded; an upcast of it reads the unrounded float32 value, as
        the reference's compiled program does (XLA drops a convert to
        bfloat16 that a convert back to float32 follows)."""
        op, _, kind = self.nodes[index]
        return kind == "h" and op not in _SELECTING

    def op_counts(self, outputs: list) -> dict:
        """The ops the tail needs, by rank (node_ranks) -> {rank: (ALU ops,
        special-function ops)}: (1, 1) ops count once a render pixel, (0, 1)
        once a render column, (1, 0) once a render row, (0, 0) once. Only
        nodes the outputs read count, and identical nodes (one op on the
        same operands, which the trace records again where a tail repeats a
        subexpression) count once, as the compiler merges them. sqrt, exp
        and log run on the special-function units; loads, casts and
        constants count 0 (tools/flopcount.py's classes)."""
        ranks = node_ranks(self)
        merged, first = [], {}     # node -> the first node identical to it
        for index, (op, args, kind) in enumerate(self.nodes):
            if op != "input":
                args = tuple(merged[a] if isinstance(a, int) else (type(a[1]), a)
                             for a in args)
            merged.append(first.setdefault((op, args, kind), index))
        live, stack = set(), [merged[o] for o in outputs if isinstance(o, int)]
        while stack:
            node = stack.pop()
            if node not in live:
                live.add(node)
                op, args, _ = self.nodes[node]
                if op != "input":
                    stack += [merged[a] for a in args if isinstance(a, int)]
        counts = {rank: [0, 0] for rank in ((1, 1), (0, 1), (1, 0), (0, 0))}
        for node in live:
            op = self.nodes[node][0]
            if op not in _FREE_OPS:
                counts[ranks[node]][op in _SFU_OPS] += 1
        return {rank: tuple(count) for rank, count in counts.items()}


def _operand(graph: Graph, value):
    if isinstance(value, Sym):
        if value.graph is not graph:
            raise ValueError("Sym from another trace")
        return value.index
    if isinstance(value, (bool, np.bool_)):
        return ("const", bool(value))
    if isinstance(value, (int, float, np.integer, np.floating)):
        return ("const", float(value))
    raise NotImplementedError(
        f"Tail value of type {type(value).__name__} in a traced tail: tensors "
        "must enter through tail inputs (planes, Row, Col, scalars), not closures")


def _op(graph: Graph, op: str, *values) -> "Sym":
    args = tuple(_operand(graph, v) for v in values)
    kinds = [graph.kind(a) for a in args]
    if op in _LOGIC:
        if any(k != "b" for k in kinds):
            raise NotImplementedError(f"Bitwise {op} on float tail values")
        result = "b"
    elif op in _COMPARE:
        result = "b"
    else:
        result = promote(*kinds)
        if result == "b":     # arithmetic on booleans counts in float32
            result = "f"
    return graph.add(op, args, result)


class Sym:
    """A symbolic tail value: arithmetic and comparisons record graph nodes."""

    __slots__ = ("graph", "index")

    def __init__(self, graph: Graph, index: int):
        self.graph = graph
        self.index = index

    @property
    def shape(self):
        # Every traced value stands for the whole tile; an empty shape keeps
        # torch's argument parsing happy on the way to __torch_function__
        return ()

    @property
    def dtype(self):
        return {"b": torch.bool, "h": torch.bfloat16}.get(self.graph.nodes[self.index][2],
                                                          torch.float32)

    def to(self, dtype=None, *args, **kwargs):
        kind = self.graph.nodes[self.index][2]
        if dtype in (None, torch.float32):
            return self if kind == "f" else self.graph.add("float", (self.index,), "f")
        if dtype == torch.bfloat16:
            return self if kind == "h" else self.graph.add("bf16", (self.index,), "h")
        raise NotImplementedError(f"Tail cast to {dtype}: kernel K1 computes in "
                                  "float32 and bfloat16")

    def __bool__(self):
        raise TypeError("Tail functions are elementwise: a traced value has no "
                        "truth value (no data-dependent Python control flow)")

    def __float__(self):
        raise TypeError("Tail functions are elementwise: a traced value has no "
                        "Python float")

    def _binary(op, reverse=False):
        def method(self, other):
            if reverse:
                return _op(self.graph, op, other, self)
            return _op(self.graph, op, self, other)
        return method

    __add__ = _binary("add")
    __radd__ = _binary("add", True)
    __sub__ = _binary("sub")
    __rsub__ = _binary("sub", True)
    __mul__ = _binary("mul")
    __rmul__ = _binary("mul", True)
    __truediv__ = _binary("div")
    __rtruediv__ = _binary("div", True)
    __lt__ = _binary("lt")
    __le__ = _binary("le")
    __gt__ = _binary("gt")
    __ge__ = _binary("ge")
    __eq__ = _binary("eq")
    __ne__ = _binary("ne")
    __mod__ = _binary("mod")
    __rmod__ = _binary("mod", True)
    __and__ = _binary("and")
    __rand__ = _binary("and", True)
    __or__ = _binary("or")
    __ror__ = _binary("or", True)
    del _binary

    __hash__ = None

    def __neg__(self):
        return _op(self.graph, "neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _op(self.graph, "abs", self)

    def __invert__(self):
        return _op(self.graph, "not", self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        handler = _TORCH_OPS.get(func)
        if handler is None:
            name = getattr(func, "__name__", repr(func))
            raise NotImplementedError(
                f"torch.{name} in a tail function is not supported by kernel "
                f"K1's template (supported: {sorted(f.__name__ for f in _TORCH_OPS)})")
        graph = next(a.graph for a in (*args, *kwargs.values()) if isinstance(a, Sym))
        return handler(graph, *args, **kwargs)


def _clamp(graph, x, min=None, max=None):
    if min is not None:
        x = _op(graph, "maximum", x, min)
    if max is not None:
        x = _op(graph, "minimum", x, max)
    return x


def _where(graph, condition, a, b) -> "Sym":
    """torch.where: a boolean condition (as torch requires); the branches
    promote as jnp.where's do (boolean only when both branches are)."""
    args = tuple(_operand(graph, v) for v in (condition, a, b))
    if graph.kind(args[0]) != "b":
        raise TypeError("torch.where in a tail needs a boolean condition")
    kinds = {graph.kind(a) for a in args[1:]}
    return graph.add("where", args, "b" if kinds == {"b"} else promote(*kinds))


def _zeros_like(graph, a, **kwargs):
    kind = graph.kind(_operand(graph, a))
    return graph.add("full", (("const", 0.0),), "f" if kind == "b" else kind)


_TORCH_OPS = {
    torch.where: _where,
    torch.clamp: _clamp,
    torch.maximum: lambda g, a, b: _op(g, "maximum", a, b),
    torch.minimum: lambda g, a, b: _op(g, "minimum", a, b),
    torch.abs: lambda g, a: _op(g, "abs", a),
    torch.floor: lambda g, a: _op(g, "floor", a),
    torch.sqrt: lambda g, a: _op(g, "sqrt", a),
    torch.exp: lambda g, a: _op(g, "exp", a),
    torch.log: lambda g, a: _op(g, "log", a),
    torch.remainder: lambda g, a, b: _op(g, "mod", a, b),
    # Shape plumbing: every traced value already stands for the full tile
    torch.broadcast_to: lambda g, a, shape: a,
    torch.zeros_like: _zeros_like,
}


class _SymTable:
    """A Table input while tracing: lookup() records a clipped-gather node
    and registers the table (bins, channels) with the graph."""

    def __init__(self, graph: Graph, name: str, bins: int, channels: int):
        self.graph, self.name = graph, name
        self.bins, self.channels = bins, channels

    def lookup(self, index, channel: int = 0) -> Sym:
        channel = int(channel)
        if not 0 <= channel < self.channels:
            raise IndexError(f"Table {self.name!r} has {self.channels} channels, "
                             f"not channel {channel}")
        self.graph.tables[self.name] = (self.bins, self.channels)
        return self.graph.add(
            "lookup", (_operand(self.graph, index), ("table", self.name, channel)), "f")


def _dtype_kind(tensor) -> str:
    return "h" if tensor.dtype == torch.bfloat16 else "f"


def trace(spec: TailSpec, render_height: int, render_width: int,
          aspect: float) -> tuple[Graph, list]:
    """Run spec.fn on symbolic inputs -> (graph, [3 outputs]); each output
    is a node index or ("const", value). Planes keep their dtype (a
    bfloat16 plane is a bfloat16 input); the context serves the color
    dtype of tail_dtype() at trace time."""
    graph = Graph()
    planes = _LazyInputs(graph, {
        **{n: ("plane", tuple(_dtype_kind(p) for p in c)) for n, c in spec.planes.items()},
        **{n: ("plane", (_dtype_kind(ix.stack),)) for n, ix in spec.indexed.items()},
        **{n: ("colsampled", ("f",) * len(cs.planes)) for n, cs in spec.colsampled.items()}})
    rows = _LazyInputs(graph, {n: ("row", ("f",)) for n in spec.rows}, single=True)
    cols = _LazyInputs(graph, {n: ("col", ("f",)) for n in spec.cols}, single=True)
    scalars = _LazyInputs(graph, {n: ("scalar", ("f",)) for n in spec.scalars}, single=True)
    tables = {name: _SymTable(graph, name, *table.shape)
              for name, table in spec.tables.items()}
    ctx = TailCtx(planes, rows, cols, scalars,
                  graph.input(("row_index", "", 0)),
                  graph.input(("col_index", "", 0)),
                  render_height, render_width, aspect, tables=tables)
    result = spec.fn(ctx)
    outputs = [_operand(graph, value) for value in tuple(result)[:3]]
    if len(outputs) != 3:
        raise ValueError(f"Tail function returned {len(outputs)} planes, need 3")
    return graph, outputs


class _LazyInputs(dict):
    """name -> Sym (or tuple of channel Syms); registers the input node on
    first read, so the kernel loads only what the tail uses. `kinds` maps
    each name to (input kind, value kind of each channel)."""

    def __init__(self, graph: Graph, kinds: dict, single=False):
        super().__init__()
        self._graph, self._kinds = graph, kinds
        self._single = single

    def __missing__(self, name):
        if name not in self._kinds:
            raise KeyError(name)
        kind, channels = self._kinds[name]
        syms = tuple(self._graph.input((kind, name, c), value_kind)
                     for c, value_kind in enumerate(channels))
        value = syms[0] if self._single else syms
        self[name] = value
        return value

    def __contains__(self, name):
        return name in self._kinds


# --------------------------------------------------------------------------- #
# Evaluation with torch: the plain version of a traced tail (bfloat16 mode)
# and the test oracle for the tracer

_TORCH_EVAL = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: _divide(a, b),
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "not": lambda a: ~a,
    "mod": lambda a, b: torch.remainder(a, b) if isinstance(a, torch.Tensor)
    else torch.remainder(torch.as_tensor(a, dtype=torch.float32), b),
    "full": lambda a: a,
    "neg": lambda a: -a,
    "abs": torch.abs,
    "floor": torch.floor,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "float": lambda a: a,
    "bf16": lambda a: a,     # rounded below, as every bfloat16 node
    "maximum": lambda a, b: _extremum(torch.maximum, "min", a, b),
    "minimum": lambda a, b: _extremum(torch.minimum, "max", a, b),
    "where": torch.where,
}


def _divide(a, b):
    """a / b rounded once (IEEE), as K1's div_rn and XLA's division: a
    Python number becomes a 0-d tensor on the other operand's device (eager
    torch on CUDA divides by a host number through its reciprocal)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.div(a, b)


def _extremum(function, bound: str, a, b):
    """torch.maximum/minimum, or clamp where one side is a Python number
    (how a tail writes it: torch.clamp(x, min=0.0))."""
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, **{bound: b})
    if not isinstance(a, torch.Tensor):
        return torch.clamp(b, **{bound: a})
    return function(a, b)


def _round_value(x):
    """Round to bfloat16, held in float32 (tensors or Python numbers)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(torch.float32)
    return round_bf16(x)


def _as_float(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return float(x)


def evaluate(graph: Graph, outputs: list, env: dict) -> list:
    """Evaluate the graph with torch -> the three outputs as float32 values
    (tensors, or Python numbers for constant outputs). env maps input keys
    ("plane", name, channel) / ("colsampled", name, channel) (the
    column-interpolated plane) / ("row", name, 0) / ... / ("row_index", "",
    0) / ("table", name, 0) (the (bins, C) table) to tensors.

    Every value is held in float32; a bfloat16 node is its op computed in
    float32 on its operands' values, then rounded to bfloat16 (the
    unrounded value is what an upcast of it reads), exactly what kernel K1
    emits. Operands are first converted to the type the node computes in:
    Python numbers round to bfloat16 in a bfloat16 op, bfloat16 values
    enter a float32 op as they are (unrounded where the node rounds)."""
    rounded, exact = [], []   # per node: its value, and what an upcast reads
    # the last node that reads each node: full-size values are dropped after it
    last_use = {arg: index for index, (op, args, _) in enumerate(graph.nodes)
                if op != "input" for arg in args if isinstance(arg, int)}
    for output in outputs:
        if isinstance(output, int):
            last_use[output] = len(graph.nodes)

    def operand(arg, kind: str):
        if isinstance(arg, tuple):
            value = arg[1]
            return round_bf16(value) if kind == "h" and not isinstance(value, bool) else value
        arg_kind = graph.nodes[arg][2]
        if kind == "b":
            return rounded[arg]
        if arg_kind == "b":
            return _as_float(rounded[arg])
        if kind == "h":
            return rounded[arg] if arg_kind == "h" else _round_value(rounded[arg])
        return exact[arg] if graph.rounds(arg) else rounded[arg]

    for index, (op, args, kind) in enumerate(graph.nodes):
        if op == "input":
            value = env[args]
            value = value.to(torch.float32) if value.is_floating_point() else value
        elif op == "lookup":
            _, name, channel = args[1]
            table = env[("table", name, 0)]
            position = operand(args[0], "f") if graph.kind(args[0]) != "h" \
                else rounded[args[0]]
            position = torch.clamp(torch.as_tensor(position).to(torch.int32), 0,
                                   table.shape[0] - 1)
            value = table[:, channel].to(torch.float32)[position.to(torch.int64)]
        elif op == "where":
            value = torch.where(operand(args[0], "b"), operand(args[1], kind),
                                operand(args[2], kind))
        else:
            compute = graph.compute_kind(index)
            value = _TORCH_EVAL[op](*(operand(a, compute) for a in args))
        exact.append(value)
        if kind == "h" and op not in ("input", "where", "full"):
            value = _round_value(value)
        rounded.append(value)
        if op != "input":
            for arg in set(a for a in args if isinstance(a, int)):
                if last_use[arg] == index:
                    rounded[arg] = exact[arg] = None
    return [operand(o, "f") for o in outputs]


# --------------------------------------------------------------------------- #
# Code generation

_TRITON_BINARY = {
    "add": "{} + {}", "sub": "{} - {}", "mul": "{} * {}",
    "div": "tl.math.div_rn({}, {})",
    "lt": "{} < {}", "le": "{} <= {}", "gt": "{} > {}", "ge": "{} >= {}",
    "eq": "{} == {}", "ne": "{} != {}",
    "and": "{} & {}", "or": "{} | {}",
    "maximum": "tl.maximum({}, {}, propagate_nan=tl.PropagateNan.ALL)",
    "minimum": "tl.minimum({}, {}, propagate_nan=tl.PropagateNan.ALL)",
}
_TRITON_UNARY = {
    "neg": "-{}", "not": "~{}", "abs": "tl.abs({})", "floor": "tl.floor({})",
    "sqrt": "tl.sqrt_rn({})", "exp": "libdevice.exp({})",
    "log": "libdevice.log({})", "float": "{}",
    "bf16": "{}.to(tl.bfloat16).to(tl.float32)",
}
_ROUND = "{}.to(tl.bfloat16).to(tl.float32)"

# T1's table (tools/probe_bf16_ops.py) on an NVIDIA H100 80GB HBM3 (700 W),
# Triton 3.6.0, 2026-10-16: the probe ops whose native bfloat16 Triton form
# is bit-equal to the op computed in float32 and rounded to bfloat16; sqrt,
# rsqrt, exp, log, tanh, sin and pow through exp/log have no bfloat16
# lowering there. K1 computes every bfloat16 op in float32 and rounds it
# (the native forms of mul and add gave the same bits and no measured
# gain). chip_smoke.py probes again and fails if an op below is not `ok`.
BF16_PROBE_OK = ("mul", "add", "max", "where", "select_f32cmp", "div_array",
                 "div_const", "recip")


def _literal(value: float) -> str:
    """The float32 value torch would use, as Python source."""
    value = float(np.float32(value))
    return repr(value) if math.isfinite(value) else f'float("{value}")'


# Ranks: which axes of the tile a value varies along, (rows, columns). A
# value is computed at its own rank and broadcast in registers only where
# an op meets a value of a higher rank: scalars and constants are 0-d,
# rows [BH, 1], columns [1, BWC], planes [BH, BWC].
_INPUT_RANK = {"plane": (1, 1), "colsampled": (1, 1), "row": (1, 0), "col": (0, 1),
               "scalar": (0, 0), "row_index": (1, 0), "col_index": (0, 1)}
_TILE = (1, 1)


def node_ranks(graph: Graph) -> list:
    """Each node's rank: an input's by its kind, any other node's the union
    of its operands' (a constant is 0-d)."""
    ranks = []
    for op, args, _ in graph.nodes:
        if op == "input":
            ranks.append(_INPUT_RANK[args[0]])
            continue
        rank = (0, 0)
        for arg in args:
            if isinstance(arg, int):
                rank = (rank[0] | ranks[arg][0], rank[1] | ranks[arg][1])
        ranks.append(rank)
    return ranks


def _scope(rank: tuple, subsample: int) -> int:
    """Where a node of `rank` is emitted: 0 once per program (0-d), 1 once
    per column block (columns, hoisted out of the s row passes), 2 in each
    pass of render rows (rows, tile; at s = 1 columns too, in graph order:
    with one pass, hoisting only lengthens their lives)."""
    if rank[0] or (rank[1] and subsample == 1):
        return 2
    return 1 if rank[1] else 0


def emission_order(graph: Graph, subsample: int) -> list:
    """Node indices in the order the template emits them: by scope, then in
    graph order (an operand's scope never follows its user's)."""
    ranks = node_ranks(graph)
    return sorted(range(len(graph.nodes)), key=lambda i: (_scope(ranks[i], subsample), i))


def column_split(subsample: int) -> int:
    """Render columns of one output column that a load reads side by side:
    all s of them where s is a power of two (the tile's render block is then
    contiguous rows, pooled by a reshape), else 1 (the s column
    sub-positions are separate strided passes)."""
    return subsample if subsample & (subsample - 1) == 0 else 1


# Tile rule. A warp reads a row of 128 float32 (32 lanes x one 16-byte
# vector), so a program's render block is [BH, 128] and each of its 4
# warps' threads holds E = BH elements of a plane value, 4 of a column
# value (each warp holds the whole column vector), about one of a row or a
# 0-d value. The compiler issues a pass's plane loads and texel gathers
# before the arithmetic that reads them, so those are live from the start
# of the pass; a ColSampled input holds its two gathered texels and their
# two 64-bit addresses (6 E). E is the largest of 8, 4, 2, 1 whose live
# peak fits K1_REGISTERS, the share of a thread's registers left for
# values after masks and the compiler's temporaries. Measured on the card
# (PERF.md, examples/torch/bench_k1.py): every graded tail compiles to no
# spill under it, and gets the fastest E of those tried with 4 warps; the
# gather-bound visualizer tails E = 1 (more programs a multiprocessor hide
# the gathers' latency), the piano roll's E = 4 (its column values are
# computed once for more rows), the fractals' E = 8.
K1_COLUMNS = 128
K1_WARPS = 4
K1_REGISTERS = 96


def live_peak(graph: Graph, outputs: list, per_thread: int, subsample: int) -> int:
    """Registers a thread holds at the fullest point of the emitted body
    when it holds `per_thread` (E) elements of a plane value: each live
    value weighted by its rank and kind (the tile rule above) plus the
    three pooling sums."""
    ranks = node_ranks(graph)
    order = emission_order(graph, subsample)
    position = {node: p for p, node in enumerate(order)}
    end = len(order)
    last = {node: position[node] for node in order}
    for node in order:
        for arg in graph.nodes[node][1]:
            if isinstance(arg, int):
                last[arg] = max(last[arg], position[node])
    for output in outputs:
        if isinstance(output, int):
            last[output] = end
    weight = {(1, 1): per_thread, (0, 1): 4, (1, 0): 1, (0, 0): 1}
    first_pass = min((position[n] for n in order if _scope(ranks[n], subsample) == 2),
                     default=0)
    delta = [0] * (end + 1)
    for node in order:
        op, args, _ = graph.nodes[node]
        value = weight[ranks[node]]
        if op == "input" and args[0] in ("plane", "colsampled"):
            start = first_pass
            value *= 6 if args[0] == "colsampled" else 1
        else:
            start = position[node]
        delta[start] += value
        delta[last[node] + 1 if last[node] < end else end] -= value
    running = peak = 0
    for p in range(end):
        running += delta[p]
        peak = max(peak, running)
    pooled = 3 * max(per_thread // column_split(subsample), 1) if subsample > 1 else 0
    return peak + pooled


def tile_shape(graph: Graph, outputs: list, subsample: int) -> tuple[int, int, int]:
    """(BH output rows, BW output columns, num_warps) of one K1 program: a
    pure function of the graph's live values (live_peak) and s, by the tile
    rule above: BH = E. BW * s = K1_COLUMNS render columns (64 output
    columns for an s that is not a power of two)."""
    split = column_split(subsample)
    width = K1_COLUMNS // split if split == subsample else K1_COLUMNS // 2
    rows = 8
    while rows > 1 and live_peak(graph, outputs, rows, subsample) > K1_REGISTERS:
        rows //= 2
    return rows, width, K1_WARPS


def generate(graph: Graph, outputs: list, subsample: int,
             colsampled_bf16: frozenset = frozenset(),
             quantize: bool = True) -> tuple[str, list]:
    """Emit the Triton source for this graph -> (source, input keys in
    kernel-argument order). ColSampled inputs also take, per name, their
    (Wr,) positions and their width W_in (arguments pos<j>, win<j>);
    `colsampled_bf16` names those whose planes are bfloat16 (their hat
    weights round to bf16). Table inputs are keys ("table", name, 0): a
    (bins, C) float32 pointer, bins and C baked into the source.
    quantize=False (subsample 1) stores three bf16 planes (3, Ho, Wo).

    Values live in float32 registers: v<i> is node i's value (a bfloat16
    node's rounded to bfloat16), u<i> the unrounded value of a node that
    rounds (Graph.rounds), which upcasts and the outputs read. Each node is
    emitted at its rank (node_ranks) in the outermost scope that holds its
    operands: 0-d values once per program, column values once per column
    block, row and plane values once per row block of render rows."""
    s = int(subsample)
    if not quantize and s != 1:
        raise ValueError(f"K1's quantize=False form runs at s = 1, got s={s}")
    split = column_split(s)
    keys = sorted(k for k in graph.inputs
                  if k[0] in ("plane", "colsampled", "row", "col", "scalar"))
    keys += [("table", name, 0) for name in sorted(graph.tables)]
    scalar_keys = [k for k in keys if k[0] == "scalar"]
    pointer_keys = [k for k in keys if k[0] != "scalar"]
    arg_names = {k: f"in{i}" for i, k in enumerate(pointer_keys)}
    sampled = sorted({k[1] for k in keys if k[0] == "colsampled"})
    ranks = node_ranks(graph)
    width = f"BW * {split}" if split > 1 else "BW"      # BWC: render columns a load reads
    scopes = [[], [], []]     # program, column block, row block

    consts: dict[Any, str] = {}

    def const(value) -> str:
        key = (type(value), value)
        if key not in consts:
            consts[key] = f"k{len(consts)}"
            if isinstance(value, bool):
                scopes[0].append(f"{consts[key]} = tl.full([], {int(value)}, tl.int1)")
            else:
                scopes[0].append(f"{consts[key]} = tl.full([], {_literal(value)}, tl.float32)")
        return consts[key]

    def operand(arg, kind: str) -> str:
        """Node or constant `arg` as a value of type `kind` (see evaluate)."""
        if isinstance(arg, tuple):
            value = arg[1]
            return const(round_bf16(value) if kind == "h" and not isinstance(value, bool)
                         else value)
        arg_kind = graph.nodes[arg][2]
        if kind == "b":
            return f"v{arg}"
        if arg_kind == "b":
            return f"v{arg}.to(tl.float32)"
        if kind == "h":
            return f"v{arg}" if arg_kind == "h" else _ROUND.format(f"v{arg}")
        return f"u{arg}" if graph.rounds(arg) else f"v{arg}"

    def plane_load(key) -> str:
        name = arg_names[key]
        base = name + (" + dy * Wr" if s > 1 else "") + (" + dx" if split != s else "")
        shape, step = ("Wr", "1") if split == s else ("Wo", str(s))
        return (f"tl.load(tl.make_block_ptr({base}, shape=(Ho, {shape}), "
                f"strides=({s} * Wr, {step}), offsets=(pid_r * BH, pid_c * {width}), "
                f"block_shape=(BH, {width}), order=(1, 0)), boundary_check=(0, 1), "
                f"padding_option=\"zero\").to(tl.float32)")

    for j, name in enumerate(sampled):
        # the per-column texels and hat weights of a ColSampled input
        scopes[1] += [
            f"cp{j} = tl.load(pos{j} + ci, mask=col_ok, other=0.0)",
            f"cf{j} = tl.floor(cp{j})",
            f"cw{j}a = tl.maximum(1.0 - tl.abs(cp{j} - cf{j}), 0.0)",
            f"cw{j}b = tl.maximum(1.0 - tl.abs(cp{j} - (cf{j} + 1.0)), 0.0)",
        ]
        if name in colsampled_bf16:
            scopes[1] += [f"cw{j}a = cw{j}a.to(tl.bfloat16).to(tl.float32)",
                          f"cw{j}b = cw{j}b.to(tl.bfloat16).to(tl.float32)"]
        scopes[1] += [f"cx{j}a = cf{j}.to(tl.int32)",
                      f"cx{j}b = tl.minimum(cx{j}a + 1, win{j} - 1)"]

    for index in emission_order(graph, s):
        op, args, kind = graph.nodes[index]
        lines = scopes[_scope(ranks[index], s)]
        target = f"v{index}"
        compute = graph.compute_kind(index)
        if op == "input":
            kind_in, name, channel = args
            if kind_in == "plane":
                expr = plane_load(args)
            elif kind_in == "colsampled":
                j = sampled.index(name)
                row = f"{arg_names[args]} + ri * win{j}"
                expr = (f"tl.load({row} + cx{j}a, mask=row_ok & col_ok, other=0.0)"
                        f".to(tl.float32) * cw{j}a + tl.load({row} + cx{j}b, "
                        f"mask=row_ok & col_ok, other=0.0).to(tl.float32) * cw{j}b")
            elif kind_in == "row":
                expr = f"tl.load({arg_names[args]} + ri, mask=row_ok, other=0.0)"
            elif kind_in == "col":
                expr = f"tl.load({arg_names[args]} + ci, mask=col_ok, other=0.0)"
            elif kind_in == "scalar":
                expr = f"tl.load(scalars + {scalar_keys.index(args)})"
            elif kind_in == "row_index":
                expr = "ri.to(tl.float32)"
            else:
                expr = "ci.to(tl.float32)"
        elif op == "lookup":
            # the index is clipped into the table: every lane reads in bounds
            _, name, channel = args[1]
            bins, channels = graph.tables[name]
            position = f"v{args[0]}" if graph.kind(args[0]) == "h" else operand(args[0], "f")
            index_expr = f"tl.minimum(tl.maximum({position}.to(tl.int32), 0), {bins - 1})"
            expr = (f"tl.load({arg_names[('table', name, 0)]} + {index_expr} * {channels} "
                    f"+ {channel})")
        elif op == "full":
            expr = operand(args[0], kind)
        elif op == "mod":
            # torch.remainder / jnp.mod on floats: fmod, then + b where the
            # remainder is nonzero and its sign differs from b's (fmod is
            # exact; the sum rounds in bfloat16). Triton links libdevice
            # flushing subnormals to zero, so its fmod reads a subnormal
            # dividend as 0; where |a| < |b| fmod(a, b) is a exactly, and
            # the kernel takes a there (a subnormal keeps its value and
            # sign, as in torch's fmod)
            a, b = operand(args[0], compute), operand(args[1], compute)
            r = f"tl.where(tl.abs({a}) < tl.abs({b}), {a}, libdevice.fmod({a}, {b}))"
            plus = f"{r} + {b}" if compute != "h" else _ROUND.format(f"({r} + {b})")
            expr = f"tl.where(({r} != 0.0) & (({r} < 0.0) != ({b} < 0.0)), {plus}, {r})"
        elif op == "where":
            expr = (f"tl.where({operand(args[0], 'b')}, {operand(args[1], kind)}, "
                    f"{operand(args[2], kind)})")
        elif op in _TRITON_BINARY:
            expr = _TRITON_BINARY[op].format(*(operand(a, compute) for a in args))
        else:
            expr = _TRITON_UNARY[op].format(operand(args[0], compute))
        if graph.rounds(index):
            lines.append(f"u{index} = {expr}")
            lines.append(f"{target} = {_ROUND.format(f'u{index}')}")
        else:
            lines.append(f"{target} = {expr}")

    # The three outputs at the full tile (a lower-rank or constant output
    # broadcast in registers), pooled over the render block
    for c, output in enumerate(outputs):
        value = operand(output, "f")
        if not isinstance(output, int) or ranks[output] != _TILE:
            value = f"tl.broadcast_to({value}, (BH, {width}))"
        if s == 1:   # the value itself: 0.0 + x would turn a -0.0 into +0.0
            scopes[2].append(f"acc{c} = {value}")
        elif split > 1:
            scopes[2].append(f"acc{c} += tl.sum(tl.reshape({value}, [BH, BW, {split}]), axis=2)")
        else:
            scopes[2].append(f"acc{c} += {value}")

    params = ["out"] + [arg_names[k] for k in pointer_keys]
    params += [f"pos{j}" for j in range(len(sampled))]
    params += [f"win{j}" for j in range(len(sampled))]
    if scalar_keys:
        params.append("scalars")
    params += ["Ho", "Wo", "Wr", "PACK: tl.constexpr", "BH: tl.constexpr",
               "BW: tl.constexpr"]

    body = ["pid_r = tl.program_id(0)", "pid_c = tl.program_id(1)",
            "oi = pid_r * BH + tl.arange(0, BH)[:, None]      # output rows [BH, 1]",
            "row_ok = oi < Ho"] + scopes[0]
    if s > 1:
        body += [f"acc{c} = tl.zeros([BH, BW], tl.float32)" for c in range(3)]
    depth = 0
    if split != s:
        body.append(f"for dx in tl.static_range({s}):")
        depth = 1
        column = f"(pid_c * BW + tl.arange(0, BW)[None, :]) * {s} + dx"
    else:
        column = f"pid_c * {width} + tl.arange(0, {width})[None, :]"
    body += ["    " * depth + line for line in
             [f"ci = {column}      # render columns [1, BWC]", "col_ok = ci < Wr"] + scopes[1]]
    if s > 1:
        body.append("    " * depth + f"for dy in tl.static_range({s}):")
        depth += 1
        rows = [f"ri = oi * {s} + dy      # render rows [BH, 1]"]
    else:
        rows = ["ri = oi"]
    body += ["    " * depth + line for line in rows + scopes[2]]
    if s > 1:
        # the box average: a product with the exact reciprocal where s^2 is
        # a power of two (the same bits as the division), else div_rn
        area = s * s
        body += [f"acc{c} = acc{c} * {_literal(1.0 / area)}" if split == s else
                 f"acc{c} = tl.math.div_rn(acc{c}, {_literal(area)})" for c in range(3)]
    body += (_STORE_U8 if quantize else _STORE_BF16).splitlines()
    source = f'''"""Generated by shaderflow_tpu_torch/ops/tailgen.py — kernel K1 for one tail."""
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def _quads(q, BH: tl.constexpr, BW: tl.constexpr):
    """Pixels 4g, 4g + 1, 4g + 2, 4g + 3 of each group g of four, as uint32."""
    lo, hi = tl.split(tl.reshape(q.to(tl.uint32), [BH, BW // 4, 2, 2]))
    p0, p2 = tl.split(lo)
    p1, p3 = tl.split(hi)
    return p0, p1, p2, p3


@triton.jit
def tail_kernel({", ".join(params)}):
{chr(10).join("    " + line for line in body)}
'''
    return source, keys


# GL u8 quantize and the (Ho, Wo, 3) store. PACK (the row pitch 3 * Wo and
# the frame's base a multiple of 4 bytes): four pixels make three 32-bit
# words, one store each; else one byte store a channel and pixel.
_STORE_U8 = """q0 = tl.floor(tl.minimum(tl.maximum(acc0, 0.0), 1.0) * 255.0 + 0.5)
q1 = tl.floor(tl.minimum(tl.maximum(acc1, 0.0), 1.0) * 255.0 + 0.5)
q2 = tl.floor(tl.minimum(tl.maximum(acc2, 0.0), 1.0) * 255.0 + 0.5)
if PACK:
    r0, r1, r2, r3 = _quads(q0, BH, BW)
    g0, g1, g2, g3 = _quads(q1, BH, BW)
    b0, b1, b2, b3 = _quads(q2, BH, BW)
    quad = pid_c * (BW // 4) + tl.arange(0, BW // 4)[None, :]
    words = out.to(tl.pointer_type(tl.uint32)) + oi * (Wo * 3 // 4) + quad * 3
    ok = row_ok & (quad * 4 < Wo)
    tl.store(words, r0 | (g0 << 8) | (b0 << 16) | (r1 << 24), mask=ok)
    tl.store(words + 1, g1 | (b1 << 8) | (r2 << 16) | (g2 << 24), mask=ok)
    tl.store(words + 2, b2 | (r3 << 8) | (g3 << 16) | (b3 << 24), mask=ok)
else:
    oj = pid_c * BW + tl.arange(0, BW)[None, :]
    base = out + (oi * Wo + oj) * 3
    ok = row_ok & (oj < Wo)
    tl.store(base, q0.to(tl.uint8), mask=ok)
    tl.store(base + 1, q1.to(tl.uint8), mask=ok)
    tl.store(base + 2, q2.to(tl.uint8), mask=ok)"""

_STORE_BF16 = """oj = pid_c * BW + tl.arange(0, BW)[None, :]
base = out + oi * Wo + oj
ok = row_ok & (oj < Wo)
tl.store(base, acc0.to(tl.bfloat16), mask=ok)
tl.store(base + Ho * Wo, acc1.to(tl.bfloat16), mask=ok)
tl.store(base + 2 * Ho * Wo, acc2.to(tl.bfloat16), mask=ok)"""


def _value_key(value):
    """A hashable stand-in for a closure value, or None if it has none."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return (type(value).__name__, value)
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, tuple):
        items = tuple(_value_key(item) for item in value)
        return None if any(item is None for item in items) else ("tuple", items)
    return None


def _tail_key(spec: TailSpec, *shape) -> tuple:
    """What a traced K1 depends on: the tail's code and closure values, the
    structure of its inputs (kinds, names, channels, dtypes, table shapes)
    and the static arguments; None when a closure value has no key."""
    fn = spec.fn
    code = getattr(fn, "__code__", None)
    if code is None or getattr(fn, "__defaults__", None) or getattr(fn, "__kwdefaults__", None):
        return None
    cells = tuple(_value_key(cell.cell_contents) for cell in fn.__closure__ or ())
    if any(cell is None for cell in cells):
        return None
    structure = (
        tuple((n, tuple(str(c.dtype) for c in spec.planes[n])) for n in sorted(spec.planes)),
        tuple(sorted(spec.rows)), tuple(sorted(spec.cols)), tuple(sorted(spec.scalars)),
        tuple((n, tuple(spec.tables[n].shape)) for n in sorted(spec.tables)),
        tuple((n, len(cs.planes), str(cs.planes[0].dtype), cs.planes[0].shape[1])
              for n, cs in sorted(spec.colsampled.items())),
        tuple(sorted(spec.indexed)))
    return (code, cells, structure) + shape


class Compiled(NamedTuple):
    """One traced and generated K1: input keys in kernel-argument order, the
    Triton kernel, Graph.op_counts(outputs), its tile (tile_shape), the
    file name of its generated source (build.triton_name), and whether its
    next launch is the source's first in this process (Triton's JIT
    compile, or its load from Triton's cache)."""
    keys: list
    kernel: Any
    op_counts: dict
    tile: tuple
    source: str
    first_launch: bool


_PREPARED: dict = {}   # _tail_key -> Compiled
_SOURCES: set = set()  # generated sources bound in this process


def kernel_cost(op_counts: dict, inputs: list, out_shape: tuple, out_dtype: torch.dtype,
                subsample: int, quantize: bool) -> flopcount.Cost:
    """What one K1 launch must do: `op_counts` (Graph.op_counts) each
    times its rank's extent (render pixels, columns, rows, or once), plus
    with quantize, per output channel, the s x s pooling sum (s^2 - 1
    adds), the average (s > 1) and the quantize's max, min, scale, offset
    and floor; bytes of each tensor in `inputs` read once and the output
    written once."""
    out_h, out_w = out_shape[:2] if quantize else out_shape[1:]
    render_h, render_w = out_h * subsample, out_w * subsample
    extent = {(1, 1): render_h * render_w, (0, 1): render_w, (1, 0): render_h, (0, 0): 1}
    alu = sum(extent[rank] * count[0] for rank, count in op_counts.items())
    sfu = sum(extent[rank] * count[1] for rank, count in op_counts.items())
    if quantize:
        alu += out_h * out_w * 3 * (subsample * subsample - 1 + (subsample > 1) + 5)
    moved = math.prod(out_shape) * torch.empty((), dtype=out_dtype).element_size()
    moved += sum(t.numel() * t.element_size() for t in inputs if isinstance(t, torch.Tensor))
    return flopcount.Cost(alu=alu, sfu=sfu, kernel_bytes=moved)


def _check_input(tensor: torch.Tensor, kind: str, name: str, shape: tuple,
                 dtypes: tuple, device: torch.device) -> None:
    if (tensor.device != device or tensor.dtype not in dtypes
            or not tensor.is_contiguous() or tuple(tensor.shape) != shape):
        raise ValueError(
            f"K1 takes contiguous {kind} inputs of shape {shape} and type "
            f"{' or '.join(str(d) for d in dtypes)} on {device}; {name!r} is "
            f"{tensor.dtype} {tuple(tensor.shape)} on {tensor.device} "
            f"contiguous={tensor.is_contiguous()}")


def _generated(spec: TailSpec, render_height: int, render_width: int, subsample: int,
               aspect: float, quantize: bool) -> tuple:
    """Trace and generate K1 for this spec -> (source, keys, op_counts, tile)."""
    graph, outputs = trace(spec, render_height, render_width, aspect)
    bf16 = frozenset(name for name, cs in spec.colsampled.items()
                     if cs.planes[0].dtype == torch.bfloat16)
    source, keys = generate(graph, outputs, subsample, bf16, quantize)
    return source, keys, graph.op_counts(outputs), tile_shape(graph, outputs, subsample)


def compiled(spec: TailSpec, render_height: int, render_width: int, subsample: int,
             aspect: float, quantize: bool, device: torch.device) -> Compiled:
    """The traced, generated and compiled K1 for this spec, kept per
    _tail_key. The key holds the color dtype: a float32 trace must not
    serve a tail traced after SHADERFLOW_TAIL_BF16 flipped.
    `compiled.calls` counts calls and `compiled.builds` cache misses (each a
    Triton compile at its first launch)."""
    from shaderflow_tpu_torch.build import triton_module, triton_name
    compiled.calls += 1
    key = _tail_key(spec, render_height, render_width, subsample, float(aspect),
                    bool(quantize), str(device), str(tail_dtype()))
    if key is not None and key in _PREPARED:
        return _PREPARED[key]
    compiled.builds += 1
    source, keys, op_counts, tile = _generated(spec, render_height, render_width, subsample,
                                               aspect, quantize)
    name = f"{triton_name(source, stem='tail')}.py"
    entry = Compiled(keys, triton_module(source, stem="tail").tail_kernel, op_counts, tile,
                     name, name not in _SOURCES)
    _SOURCES.add(name)
    if key is not None:
        if len(_PREPARED) >= 64:
            _PREPARED.clear()
        _PREPARED[key] = entry._replace(first_launch=False)
    return entry


compiled.calls = 0
compiled.builds = 0


def registers(compiled_kernel) -> tuple[int, int]:
    """(registers a thread, spilled registers) of a compiled Triton kernel
    (K1's launch keeps its last one as `launch.compiled`)."""
    compiled_kernel._init_handles()
    return int(compiled_kernel.n_regs), int(compiled_kernel.n_spills)


def _operands(spec: TailSpec, keys: list, render_height: int, render_width: int,
              device: torch.device) -> list:
    """K1's arguments after `out`, in kernel order, for the input keys of
    its generated source; raises on an input the template does not take."""
    planes = {name: spec.planes[name] for name in spec.planes}
    planes.update({name: (ix.stack[indexed_position(ix)],)   # a view: no copy
                   for name, ix in spec.indexed.items()})
    sampled = sorted({name for kind, name, _ in keys if kind == "colsampled"})
    pointers = []
    scalars = []
    for kind, name, channel in keys:
        if kind == "scalar":
            scalars.append(torch.as_tensor(spec.scalars[name], dtype=torch.float32,
                                           device=device).reshape(()))
            continue
        if kind == "table":
            table = spec.tables[name]
            pointers.append(table.to(device=device, dtype=torch.float32).contiguous())
            continue
        if kind == "plane":
            tensor, shape = planes[name][channel], (render_height, render_width)
        elif kind == "colsampled":
            tensor = spec.colsampled[name].planes[channel]
            shape = (render_height, spec.colsampled[name].planes[0].shape[1])
        elif kind == "row":
            tensor, shape = spec.rows[name], (render_height,)
        else:
            tensor, shape = spec.cols[name], (render_width,)
        dtypes = (torch.float32, torch.bfloat16) if kind in ("plane", "colsampled") \
            else (torch.float32,)
        _check_input(tensor, kind, name, shape, dtypes, device)
        pointers.append(tensor)
    for name in sampled:
        positions = spec.colsampled[name].positions
        _check_input(positions, "ColSampled position", name, (render_width,),
                     (torch.float32,), device)
        pointers.append(positions)
    pointers += [spec.colsampled[name].planes[0].shape[1] for name in sampled]
    if scalars:
        pointers.append(torch.stack(scalars))
    return pointers


def _out_form(out_height: int, out_width: int, quantize: bool) -> tuple:
    """(shape, dtype) of K1's output: u8 frames, or bf16 planes."""
    return (((out_height, out_width, 3), torch.uint8) if quantize
            else ((3, out_height, out_width), torch.bfloat16))


def _launch_cost(op_counts: dict, tile: tuple, pointers: list, out_height: int,
                 out_width: int, subsample: int, quantize: bool) -> tuple:
    """(grid, blocks, block_cost) of one K1 launch: its grid over the
    output, and one program's share of kernel_cost for the cost walker."""
    rows, width, _ = tile
    grid = (math.ceil(out_height / rows), math.ceil(out_width / width))
    blocks = grid[0] * grid[1]
    out_shape, out_dtype = _out_form(out_height, out_width, quantize)

    def block_cost() -> flopcount.Cost:
        return kernel_cost(op_counts, pointers, out_shape, out_dtype, subsample,
                           quantize).scaled(1.0 / blocks)

    return grid, blocks, block_cost


def declared_plain(spec: TailSpec, render_height: int, render_width: int,
                   out_height: int, out_width: int, subsample: int, aspect: float,
                   quantize: bool = True):
    """Around K1's plain version on CPU tensors: the launch the card would
    make (its blocks and block cost, as prepare declares them) declared to
    the active cost walkers, so that a count does not depend on the
    device. Traces only while a walker is active."""
    if not flopcount.walking():
        return contextlib.nullcontext()
    _, keys, op_counts, tile = _generated(spec, render_height, render_width, subsample,
                                          aspect, quantize)
    pointers = _operands(spec, keys, render_height, render_width, spec_device(spec))
    _, blocks, block_cost = _launch_cost(op_counts, tile, pointers, out_height, out_width,
                                         subsample, quantize)
    return flopcount.kernel("K1", blocks, block_cost)


def prepare(spec: TailSpec, render_height: int, render_width: int,
            out_height: int, out_width: int, subsample: int, aspect: float,
            device: torch.device, quantize: bool = True):
    """Trace, generate (compiled once per distinct source) and bind K1 for
    this spec -> launch(out): a closure that enqueues the kernel on the
    current stream, writing the (out_h, out_w, 3) u8 tensor `out` (with
    quantize=False: the (3, out_h, out_w) bf16 planes). Inputs must be
    contiguous on `device`, planes float32 or bfloat16, everything else
    float32 (tables are cast to float32 here); raises on anything the
    template does not take. launch.compiled is the compiled kernel of the
    last launch (registers() reads it), launch.tile the tile it runs. The
    first launch of each generated source in a process (Triton's JIT
    compile, or its load from Triton's cache) adds a "triton" entry to
    build.build_events."""
    if device.index is None:   # "cuda" means the current card
        device = torch.device(device.type, torch.cuda.current_device())
    entry = compiled(spec, render_height, render_width, subsample, aspect, quantize, device)
    pointers = _operands(spec, entry.keys, render_height, render_width, device)
    rows, width, warps = entry.tile
    grid, blocks, block_cost = _launch_cost(entry.op_counts, entry.tile, pointers,
                                            out_height, out_width, subsample, quantize)
    out_shape, out_dtype = _out_form(out_height, out_width, quantize)
    first = entry.first_launch

    def launch(out: torch.Tensor) -> torch.Tensor:
        nonlocal first
        if (out.device != device or out.dtype != out_dtype or not out.is_contiguous()
                or tuple(out.shape) != out_shape):
            raise ValueError(f"K1 writes a contiguous {out_shape} {out_dtype} tensor "
                             f"on {device}, got {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}")
        pack = quantize and out_width % 4 == 0 and out.data_ptr() % 4 == 0
        started = time.perf_counter() if first else 0.0
        with flopcount.kernel("K1", blocks, block_cost), torch.cuda.device(device):
            launch.compiled = entry.kernel[grid](
                out, *pointers, out_height, out_width, render_width, PACK=pack, BH=rows,
                BW=width, num_warps=warps, enable_fp_fusion=False)
        if first:
            from shaderflow_tpu_torch import build
            first = False
            build.build_events.append((entry.source, "triton",
                                       time.perf_counter() - started))
        return out

    launch.compiled = None
    launch.tile = (rows, width, warps)
    return launch
