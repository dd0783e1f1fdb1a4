"""
GLSL fragment front-end: run the reference's `.frag` authoring format on
torch tensors.

Port of shaderflow_tpu/glsl.py. A small recursive-descent parser builds an
AST once (`compile_fragment`); a vectorized interpreter walks it every
frame on the frame's tensors: every pixel is a lane of the (H, W) planes,
and divergent control flow (`if` on per-pixel values, `break`, `return`,
`discard`) becomes mask-merged assignment, as a GPU wave executes it.

The values are those of the reference's compiled program:
  * Python constants stay Python and fold in double precision, as at the
    reference's trace time; everything else is float32, int32 or bool
    (never int64)
  * a division by a constant is a product with its f32 reciprocal
    (`stdlib.reciprocal`), as XLA folds x / c
  * uniforms are the frame's device tensors, so `if (iTime > 1.0)` takes
    the masked branch; statics (iLayer, ...) are host values
  * constant vectors are made once per interpreter and device (`_const`):
    a host->device copy every frame would wait for the stream

Loops with at most UNROLL_LIMIT statically counted trips unroll; bigger or
data-dependent loops run as one masked loop over the carried variables
(`_exec_for_lowered`), the reference's lax.while_loop: it stops when no
lane is active, read on the host every `sync_every` trips (a trip after
every lane stopped is masked and changes nothing).

Scope and limits are the reference's: #define object-like macros, the
scalar/vector/matrix/sampler2D types, const arrays, functions with value
parameters, the full expression grammar, if/for/while/break/continue/
return/discard, the ShaderFlow uniform and texture surface and its stdlib.
Out/inout parameters, structs, switch and dynamic indexed stores raise
GlslError.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from shaderflow_tpu_torch.ops import sampling
from shaderflow_tpu_torch.ops import stdlib as sl
from shaderflow_tpu_torch.ops.sampling import Sampler2D
from shaderflow_tpu_torch.ops.stdlib import reciprocal


class GlslError(Exception):
    pass


class _LowerUnsupported(Exception):
    """Internal: a loop body needs python-time values (temporal texture
    indices, dynamic-store indices, non-arrayable carried state) and cannot
    run as a masked loop — fall back to unrolling."""


# =========================================================================== #
# Lexer + preprocessor

_TOKEN_RE = re.compile(r"""
    (?P<float>   \d+\.\d*(?:[eE][+-]?\d+)?[fF]? | \.\d+(?:[eE][+-]?\d+)?[fF]?
               | \d+[eE][+-]?\d+[fF]? | \d+[fF] )
  | (?P<int>     0[xX][0-9a-fA-F]+ | \d+[uU]? )
  | (?P<ident>   [A-Za-z_]\w* )
  | (?P<op>      \+\+ | -- | \+= | -= | \*= | /= | %= | && | \|\| | == | !=
               | <= | >= | << | >> | [-+*/%<>=!&|^?:;,.(){}\[\]~] )
  | (?P<ws>      \s+ )
""", re.VERBOSE)


def tokenize(source: str, origin: str = "<glsl>") -> list[tuple[str, str, int]]:
    """-> [(kind, text, line)]; comments stripped, #defines applied."""
    # Strip comments, keep newlines for line numbers
    source = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                    source, flags=re.S)
    source = re.sub(r"//[^\n]*", "", source)

    # Preprocessor: object-like #define only (function-like macros of the
    # reference's includes are builtins here); other directives are ignored.
    defines: dict[str, str] = {}
    lines = []
    for line in source.split("\n"):
        stripped = line.strip()
        if stripped.startswith("#"):
            m = re.match(r"#\s*define\s+([A-Za-z_]\w*)\s+(.*)$", stripped)
            if m and not re.match(r"#\s*define\s+[A-Za-z_]\w*\(", stripped):
                defines[m.group(1)] = m.group(2).strip()
            lines.append("")  # keep line count
            continue
        lines.append(line)
    text = "\n".join(lines)

    # Expand defines iteratively at the token level
    def expand(tok_text: str, depth: int = 0) -> list[str]:
        if depth > 16 or tok_text not in defines:
            return [tok_text]
        out = []
        for m in _TOKEN_RE.finditer(defines[tok_text]):
            if m.lastgroup == "ws":
                continue
            out.extend(expand(m.group(0), depth + 1)
                       if m.lastgroup == "ident" else [m.group(0)])
        return out

    tokens: list[tuple[str, str, int]] = []
    line_no = 1
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise GlslError(f"{origin}:{line_no}: bad character {text[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            line_no += m.group(0).count("\n")
            continue
        if kind == "ident" and m.group(0) in defines:
            for piece in expand(m.group(0)):
                pm = _TOKEN_RE.match(piece)
                tokens.append((pm.lastgroup, piece, line_no))
            continue
        tokens.append((kind, m.group(0), line_no))
    return tokens


# =========================================================================== #
# AST (plain tuples: (node_kind, ...))

_TYPES = {"void", "float", "int", "bool", "uint",
          "vec2", "vec3", "vec4", "ivec2", "ivec3", "ivec4",
          "bvec2", "bvec3", "bvec4", "uvec2", "uvec3", "uvec4",
          "mat2", "mat3", "mat4", "sampler2D"}

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%="}


class Parser:
    def __init__(self, tokens: list[tuple[str, str, int]], origin: str):
        self.toks = tokens
        self.i = 0
        self.origin = origin

    # -- token helpers ----------------------------------------------------
    def peek(self, ahead: int = 0) -> tuple[str, str, int]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else ("eof", "", -1)

    def next(self) -> tuple[str, str, int]:
        tok = self.peek()
        self.i += 1
        return tok

    def accept(self, text: str) -> bool:
        if self.peek()[1] == text:
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        kind, got, line = self.next()
        if got != text:
            raise GlslError(f"{self.origin}:{line}: expected {text!r}, got {got!r}")

    def error(self, message: str) -> GlslError:
        return GlslError(f"{self.origin}:{self.peek()[2]}: {message}")

    # -- top level --------------------------------------------------------
    def parse_unit(self) -> list:
        decls = []
        while self.peek()[0] != "eof":
            decls.append(self.parse_toplevel())
        return decls

    def parse_toplevel(self):
        qualifiers = []
        while self.peek()[1] in ("const", "uniform", "in", "out", "highp",
                                 "mediump", "lowp", "precision"):
            qualifiers.append(self.next()[1])
        type_name = self.next()[1]
        if type_name not in _TYPES:
            raise self.error(f"unknown type {type_name!r}")
        name = self.next()[1]
        if self.peek()[1] == "(":
            return self.parse_function(type_name, name)
        return self.parse_global(qualifiers, type_name, name)

    def parse_function(self, ret_type: str, name: str):
        self.expect("(")
        params = []
        if not self.accept(")"):
            while True:
                while self.peek()[1] in ("in", "const", "highp", "mediump", "lowp"):
                    self.next()
                if self.peek()[1] in ("out", "inout"):
                    raise self.error("out/inout parameters are not supported")
                ptype = self.next()[1]
                pname = self.next()[1]
                params.append((ptype, pname))
                if not self.accept(","):
                    break
            self.expect(")")
        body = self.parse_block()
        return ("func", ret_type, name, params, body)

    def parse_global(self, qualifiers, type_name, name):
        size = None
        if self.accept("["):
            size = int(self.next()[1])
            self.expect("]")
        init = None
        if self.accept("="):
            init = self.parse_assignment_expr()
        self.expect(";")
        return ("global", qualifiers, type_name, name, size, init)

    # -- statements -------------------------------------------------------
    def parse_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_statement())
        return ("block", stmts)

    def parse_statement(self):
        kind, text, line = self.peek()
        if text == "{":
            return self.parse_block()
        if text == ";":
            self.next()
            return ("block", [])
        if text == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            then = self.parse_statement()
            otherwise = self.parse_statement() if self.accept("else") else None
            return ("if", cond, then, otherwise)
        if text == "for":
            self.next()
            self.expect("(")
            init = (("expr", None) if self.accept(";")
                    else self.parse_simple_statement())
            cond = None if self.peek()[1] == ";" else self.parse_expression()
            self.expect(";")
            step = None if self.peek()[1] == ")" else self.parse_expression()
            self.expect(")")
            body = self.parse_statement()
            return ("for", init, cond, step, body)
        if text == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            body = self.parse_statement()
            return ("for", ("expr", None), cond, None, body)
        if text == "return":
            self.next()
            value = None if self.peek()[1] == ";" else self.parse_expression()
            self.expect(";")
            return ("return", value)
        if text == "break":
            self.next()
            self.expect(";")
            return ("break",)
        if text == "continue":
            self.next()
            self.expect(";")
            return ("continue",)
        if text == "discard":
            self.next()
            self.expect(";")
            return ("discard",)
        return self.parse_simple_statement()

    def parse_simple_statement(self):
        """Declaration or expression statement, consuming the trailing ';'."""
        qualifiers = []
        while self.peek()[1] in ("const", "highp", "mediump", "lowp"):
            qualifiers.append(self.next()[1])
        if self.peek()[1] in _TYPES and self.peek(1)[0] == "ident" \
                and self.peek(2)[1] not in ("(",):
            type_name = self.next()[1]
            decls = []
            while True:
                name = self.next()[1]
                size = None
                if self.accept("["):
                    size = int(self.next()[1])
                    self.expect("]")
                init = self.parse_assignment_expr() if self.accept("=") else None
                decls.append((name, size, init))
                if not self.accept(","):
                    break
            self.expect(";")
            return ("decl", type_name, decls)
        if qualifiers:
            raise self.error("qualifier without declaration")
        expr = self.parse_expression()
        self.expect(";")
        return ("expr", expr)

    # -- expressions (precedence climbing) --------------------------------
    def parse_expression(self):
        expr = self.parse_assignment_expr()
        while self.accept(","):
            expr = ("comma", expr, self.parse_assignment_expr())
        return expr

    def parse_assignment_expr(self):
        left = self.parse_ternary()
        if self.peek()[1] in _ASSIGN_OPS:
            op = self.next()[1]
            right = self.parse_assignment_expr()
            return ("assign", op, left, right)
        return left

    def parse_ternary(self):
        cond = self.parse_binary(0)
        if self.accept("?"):
            then = self.parse_assignment_expr()
            self.expect(":")
            otherwise = self.parse_assignment_expr()
            return ("ternary", cond, then, otherwise)
        return cond

    _PRECEDENCE = [["||"], ["&&"], ["|"], ["^"], ["&"],
                   ["==", "!="], ["<", ">", "<=", ">="],
                   ["<<", ">>"], ["+", "-"], ["*", "/", "%"]]

    def parse_binary(self, level: int):
        if level >= len(self._PRECEDENCE):
            return self.parse_unary()
        left = self.parse_binary(level + 1)
        while self.peek()[1] in self._PRECEDENCE[level]:
            op = self.next()[1]
            right = self.parse_binary(level + 1)
            left = ("binary", op, left, right)
        return left

    def parse_unary(self):
        text = self.peek()[1]
        if text in ("-", "+", "!", "~"):
            self.next()
            return ("unary", text, self.parse_unary())
        if text in ("++", "--"):
            self.next()
            return ("prefix", text, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        expr = self.parse_primary()
        while True:
            text = self.peek()[1]
            if text == ".":
                self.next()
                member = self.next()[1]
                expr = ("member", expr, member)
            elif text == "[":
                self.next()
                index = self.parse_expression()
                self.expect("]")
                expr = ("index", expr, index)
            elif text == "(" and expr[0] in ("ident", "arraytype"):
                self.next()
                args = []
                if not self.accept(")"):
                    while True:
                        args.append(self.parse_assignment_expr())
                        if not self.accept(","):
                            break
                    self.expect(")")
                expr = ("call", expr, args)
            elif text in ("++", "--"):
                self.next()
                expr = ("postfix", text, expr)
            else:
                return expr

    def parse_primary(self):
        kind, text, line = self.next()
        if kind == "float":
            return ("num", float(text.rstrip("fF")))
        if kind == "int":
            return ("num", int(text.rstrip("uU"), 0))
        if kind == "ident":
            if text in ("true", "false"):
                return ("num", text == "true")
            if text in _TYPES and self.peek()[1] == "[":
                # array constructor type: int[9](...)
                self.expect("[")
                size = int(self.next()[1])
                self.expect("]")
                return ("arraytype", text, size)
            return ("ident", text)
        if text == "(":
            expr = self.parse_expression()
            self.expect(")")
            return expr
        raise GlslError(f"{self.origin}:{line}: unexpected token {text!r}")


# =========================================================================== #
# Values

_VEC_SIZE = {"vec2": 2, "vec3": 3, "vec4": 4, "ivec2": 2, "ivec3": 3,
             "ivec4": 4, "bvec2": 2, "bvec3": 3, "bvec4": 4,
             "uvec2": 2, "uvec3": 3, "uvec4": 4}
_MAT_SIZE = {"mat2": 2, "mat3": 3, "mat4": 4}
_SWIZZLE = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3,
            "s": 0, "t": 1, "p": 2, "q": 3}
_NUMPY_DTYPE = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def _is_py(value) -> bool:
    return isinstance(value, (int, float, bool))


def _py_dtype(value) -> torch.dtype:
    """JAX's dtype of a Python number: bool, int32 or float32."""
    if isinstance(value, bool):
        return torch.bool
    return torch.int32 if isinstance(value, int) else torch.float32


class GV:
    """A GLSL value: `kind` + `data`.

    Scalars ('float'/'int'/'bool') hold a Python number OR a tensor of
    pixel shape (H, W) (or ()); vectors ('vecN'/'ivecN'/'bvecN') hold a
    tensor whose LAST axis is the component axis ((N,) constants,
    (H, W, N) per-pixel fields); matrices hold (..., N, N) (row, column);
    'sampler' holds a Sampler2D; 'camera' holds the camera rays; 'array'
    holds a (K,) element tensor with the element kind after the colon."""
    __slots__ = ("kind", "data")

    def __init__(self, kind: str, data: Any):
        self.kind = kind
        self.data = data

    def __repr__(self) -> str:
        return f"GV({self.kind}, {type(self.data).__name__})"

    @property
    def is_python(self) -> bool:
        return _is_py(self.data)

    @property
    def components(self) -> int:
        return _VEC_SIZE.get(self.kind, 1)


def _is_scalar_kind(kind: str) -> bool:
    return kind in ("float", "int", "bool")


def _promote_num(a: GV, b: GV) -> str:
    if "float" in (a.kind, b.kind):
        return "float"
    if "int" in (a.kind, b.kind):
        return "int"
    return a.kind


def _vec_dtype(kind: str) -> torch.dtype:
    return (torch.int32 if kind.startswith("i") else
            torch.bool if kind.startswith("b") else torch.float32)


# =========================================================================== #
# Interpreter

class _Env:
    def __init__(self, parent: Optional["_Env"] = None):
        self.vars: dict[str, GV] = {}
        self.parent = parent

    def lookup(self, name: str) -> Optional[GV]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        return None

    def owner(self, name: str) -> Optional["_Env"]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        return None

    def declare(self, name: str, value: GV) -> None:
        self.vars[name] = value


def _mask_and(a, b):
    """None = all lanes; False = no lanes; True = all lanes; else a tensor."""
    if a is None:
        return b
    if b is None:
        return a
    if a is False or b is False:
        return False
    if a is True:
        return b
    if b is True:
        return a
    return torch.logical_and(a, b)


def _mask_andnot(a, b):
    """a & ~b (b None/False -> a)."""
    if a is False:
        return False
    if b is None or b is False:
        return a
    if b is True:
        return False
    return _mask_and(a, torch.logical_not(b))


def _mask_or(a, b):
    if a is None or b is None:
        raise GlslError("internal: or on unset mask")
    if isinstance(a, bool) and isinstance(b, bool):
        return a or b
    return torch.logical_or(a, b)


def _sticky_or(current, addition):
    """Accumulate a sticky flag mask: current is False (never taken),
    True (taken everywhere) or a tensor; addition is None (taken under the
    full active set), True or a tensor."""
    if addition is None or addition is True or current is True:
        return True
    if current is False:
        return addition if addition is not False else False
    if addition is False:
        return current
    return torch.logical_or(current, addition)


def _kind_dtype(kind: str) -> Optional[torch.dtype]:
    """Carry dtype for a GLSL kind; None = not carried (sampler/camera)."""
    if kind == "float" or kind.startswith("vec") or kind in _MAT_SIZE \
            or kind == "array:float":
        return torch.float32
    if kind in ("int", "uint") or kind.startswith(("ivec", "uvec")) \
            or kind == "array:int":
        return torch.int32
    if kind == "bool" or kind.startswith("bvec"):
        return torch.bool
    return None


def _add_store_target(target, out: set) -> None:
    while target[0] in ("member", "index"):
        target = target[1]
    if target[0] == "ident":
        out.add(target[1])


def _collect_mutated(node, out: set) -> None:
    """All identifiers the AST can store into (assignment/inc-dec targets)."""
    if isinstance(node, tuple):
        kind = node[0] if node and isinstance(node[0], str) else None
        if kind == "assign":
            _add_store_target(node[2], out)
        elif kind in ("prefix", "postfix"):
            _add_store_target(node[2], out)
        for child in node[1:] if kind else node:
            _collect_mutated(child, out)
    elif isinstance(node, list):
        for child in node:
            _collect_mutated(child, out)


def _expr_is_pure(node) -> bool:
    """No stores / no user-call opacity: safe to pre-evaluate a condition.
    Builtin calls (length, dot, ...) are pure; user calls are opaque."""
    if isinstance(node, tuple):
        kind = node[0] if node and isinstance(node[0], str) else None
        if kind in ("assign", "prefix", "postfix", "comma"):
            return False
        if kind == "call":
            callee = node[1]
            if callee[0] != "ident" or callee[1] not in _BUILTINS:
                return False
            return all(_expr_is_pure(arg) for arg in node[2])
        return all(_expr_is_pure(child) for child in (node[1:] if kind else node))
    if isinstance(node, list):
        return all(_expr_is_pure(child) for child in node)
    return True


class _Flow:
    """Per-frame control-flow state: the active mask plus sticky
    return/break/continue/discard masks (False = not taken, True = taken
    everywhere, tensor = per-pixel)."""

    def __init__(self):
        self.mask = None          # None = fully active
        self.returned = False
        self.break_mask = False
        self.continue_mask = False
        self.ret_value: Optional[GV] = None
        self.discarded = False

    def active(self):
        m = _mask_andnot(self.mask, self.returned)
        m = _mask_andnot(m, self.break_mask)
        return _mask_andnot(m, self.continue_mask)

    def fully_inactive(self) -> bool:
        return (self.returned is True or self.break_mask is True
                or self.continue_mask is True)


class Interpreter:
    """Executes one parsed translation unit against a Frag context."""

    # Loops with at most this many statically counted trips unroll (constant
    # folding, Python temporal indices keep working); bigger or data-dependent
    # loops run as one masked loop that stops when every lane has.
    UNROLL_LIMIT = 32
    # A masked loop reads on the host whether any lane is still active every
    # this many trips: each read waits for the device (about 0.12 ms on an
    # H100 against about 1 ms a trip of a 3840x2160 loop), and a loop that
    # ends runs up to this many - 1 masked trips first. Of 1, 2, 4, 8, 16
    # and 32, 4 loses least on both of chip_smoke.py's views (PERF.md).
    SYNC_EVERY = 4
    # The trip cap of a loop whose trip count is not known statically
    MAX_TRIPS = 65536

    def __init__(self, unit: list, origin: str):
        self.origin = origin
        self.functions: dict[str, tuple] = {}
        self.globals_ast: list[tuple] = []
        for decl in unit:
            if decl[0] == "func":
                self.functions[decl[2]] = decl
            else:
                self.globals_ast.append(decl)
        if "main" not in self.functions:
            raise GlslError(f"{origin}: no void main() defined")
        self.sync_every = self.SYNC_EVERY
        self.device = torch.device("cpu")
        self._constants: dict[tuple, torch.Tensor] = {}
        # The last run's masked loops: trips run and host reads of the
        # active mask
        self.stats = {"lowered_loops": 0, "trips": 0, "syncs": 0}

    # ------------------------------------------------------------------ #
    # Tensors of the frame's device

    def _const(self, value, dtype: torch.dtype) -> torch.Tensor:
        """A constant tensor on the frame's device, made once per value,
        dtype and device (a per-frame host->device copy would wait for the
        stream). Shared: never written in place."""
        array = np.asarray(value, _NUMPY_DTYPE[dtype])
        key = (dtype, self.device, array.shape, array.tobytes())
        tensor = self._constants.get(key)
        if tensor is None:
            tensor = torch.from_numpy(array.copy()).to(self.device)
            self._constants[key] = tensor
        return tensor

    def _arr(self, value, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """jnp.asarray(value[, dtype]): tensors cast, Python numbers (and
        lists of them) as constants of JAX's dtype."""
        if isinstance(value, torch.Tensor):
            return value if dtype is None or value.dtype == dtype else value.to(dtype)
        if isinstance(value, (list, tuple)):
            if all(_is_py(v) for v in value):
                return self._const(value, dtype or _py_dtype(value[0]))
            items = [self._arr(v, dtype) for v in value]
            return torch.stack(torch.broadcast_tensors(*items))
        return self._const(value, dtype or _py_dtype(value))

    def _f32(self, value) -> torch.Tensor:
        return self._arr(value, torch.float32)

    def _dev(self, value):
        """A library result on the frame's device: an all-constant call can
        come back on the host."""
        if isinstance(value, torch.Tensor) and value.device != self.device:
            if value.dtype in _NUMPY_DTYPE:
                return self._const(value.numpy(), value.dtype)
            return value.to(self.device)
        return value

    def _pixelwise(self, value):
        """Scalar payload -> something broadcastable against a (..., N)
        vector: a component axis appended to (H, W) planes."""
        if _is_py(value):
            return value
        arr = self._arr(value)
        return arr[..., None] if arr.ndim > 0 else arr

    def _mask_arr(self, mask) -> torch.Tensor:
        """Flow mask (None/bool/tensor) -> a bool tensor for a loop carry."""
        if mask is None or mask is True:
            return self._const(True, torch.bool)
        if mask is False:
            return self._const(False, torch.bool)
        return self._arr(mask, torch.bool)

    # ------------------------------------------------------------------ #
    def run(self, sf) -> torch.Tensor:
        self.sf = sf
        self.device = sf.device
        self.stats = {"lowered_loops": 0, "trips": 0, "syncs": 0}
        self.height, self.width = sf.astuv.shape[:2]
        root = _Env()
        root.declare("fragColor", GV("vec4", self._const([0.0] * 4, torch.float32)))
        root.declare("fragCoord", GV("vec2", sf.stxy))
        root.declare("gl_FragCoord", GV("vec2", sf.stxy))
        for decl in self.globals_ast:
            _, _qual, type_name, name, size, init = decl
            flow = _Flow()
            value = (self.eval(init, root, flow) if init is not None
                     else self._default_value(type_name, size))
            root.declare(name, self._coerce_decl(type_name, size, value))
        flow = _Flow()
        self.exec_block(self.functions["main"][4], _Env(root), flow)
        if flow.discarded is not False:
            sf.discard(flow.discarded if flow.discarded is not True
                       else torch.ones((self.height, self.width), dtype=torch.bool,
                                       device=self.device))
        color = root.lookup("fragColor")
        data = self._f32(color.data)
        return torch.broadcast_to(data, (self.height, self.width, 4)).contiguous()

    # ------------------------------------------------------------------ #
    # Statements

    def exec_stmt(self, stmt, env: _Env, flow: _Flow) -> None:
        op = stmt[0]
        if op == "block":
            self.exec_block(stmt, _Env(env), flow)
        elif op == "expr":
            if stmt[1] is not None:
                self.eval(stmt[1], env, flow)
        elif op == "decl":
            _, type_name, decls = stmt
            for name, size, init in decls:
                value = (self.eval(init, env, flow) if init is not None
                         else self._default_value(type_name, size))
                env.declare(name, self._coerce_decl(type_name, size, value))
        elif op == "if":
            self.exec_if(stmt, env, flow)
        elif op == "for":
            self.exec_for(stmt, env, flow)
        elif op == "return":
            value = self.eval(stmt[1], env, flow) if stmt[1] is not None else None
            active = flow.active()
            if value is not None:
                if flow.ret_value is None:
                    flow.ret_value = value
                else:
                    flow.ret_value = self._merge(flow.ret_value, value, active)
            flow.returned = _sticky_or(flow.returned, active)
        elif op == "break":
            flow.break_mask = _sticky_or(flow.break_mask, flow.active())
        elif op == "continue":
            flow.continue_mask = _sticky_or(flow.continue_mask, flow.active())
        elif op == "discard":
            active = flow.active()
            flow.discarded = _sticky_or(flow.discarded, active)
            flow.returned = _sticky_or(flow.returned, active)
        else:
            raise GlslError(f"{self.origin}: unhandled statement {op!r}")

    def exec_block(self, block, env: _Env, flow: _Flow) -> None:
        for stmt in block[1]:
            if flow.fully_inactive():
                return
            self.exec_stmt(stmt, env, flow)

    def exec_if(self, stmt, env: _Env, flow: _Flow) -> None:
        _, cond_ast, then, otherwise = stmt
        cond = self.eval(cond_ast, env, flow)
        if cond.is_python:
            if cond.data:
                self.exec_stmt(then, _Env(env), flow)
            elif otherwise is not None:
                self.exec_stmt(otherwise, _Env(env), flow)
            return
        cond_mask = self._arr(cond.data, torch.bool)
        saved = flow.mask
        flow.mask = _mask_and(saved, cond_mask)
        self.exec_stmt(then, _Env(env), flow)
        if otherwise is not None:
            flow.mask = _mask_and(saved, torch.logical_not(cond_mask))
            self.exec_stmt(otherwise, _Env(env), flow)
        flow.mask = saved

    def exec_for(self, stmt, env: _Env, flow: _Flow) -> None:
        _, init, cond_ast, step, body = stmt
        loop_env = _Env(env)
        self.exec_stmt(init, loop_env, flow)

        trips = self._shadow_trip_count(stmt, loop_env)
        if trips is None or trips > self.UNROLL_LIMIT:
            cond_is_python = True
            if trips is None and cond_ast is not None \
                    and _expr_is_pure(cond_ast):
                probe = self.eval(cond_ast, loop_env, flow)
                cond_is_python = probe.is_python
            if trips is not None or not cond_is_python:
                try:
                    self._exec_for_lowered(stmt, loop_env, flow, trips)
                    return
                except _LowerUnsupported:
                    if trips is None:
                        raise GlslError(
                            f"{self.origin}: data-dependent loop needs "
                            "python-time values in its body and cannot be "
                            "unrolled either") from None
        self._exec_for_unrolled(stmt, loop_env, flow, trips)

    def _exec_for_unrolled(self, stmt, loop_env: _Env, flow: _Flow,
                           trips: Optional[int]) -> None:
        _, init, cond_ast, step, body = stmt
        saved_mask = flow.mask
        break_saved = flow.break_mask
        continue_saved = flow.continue_mask
        # Lanes sitting out the enclosing scope (outer break/continue) must
        # stay inactive for this whole loop; `returned` is sticky on the flow
        # itself so active() keeps excluding it.
        entry_mask = _mask_andnot(_mask_andnot(saved_mask, break_saved),
                                  continue_saved)
        flow.break_mask = False
        flow.continue_mask = False
        iteration = 0
        while True:
            if trips is not None and iteration >= trips:
                break
            if trips is None and iteration >= self.MAX_TRIPS:
                raise GlslError(f"{self.origin}: loop exceeded 65536 iterations")
            cond = (self.eval(cond_ast, loop_env, flow)
                    if cond_ast is not None else GV("bool", True))
            if cond.is_python:
                if not cond.data:
                    break
                flow.mask = _mask_andnot(entry_mask, flow.break_mask)
            else:
                flow.mask = _mask_andnot(
                    _mask_and(entry_mask, self._arr(cond.data, torch.bool)),
                    flow.break_mask)
            if flow.break_mask is True or flow.returned is True:
                break
            flow.continue_mask = False
            self.exec_stmt(body, _Env(loop_env), flow)
            # `continue` jumps to the step expression: continued lanes rejoin
            # here; broken/returned lanes stay excluded via active().
            flow.continue_mask = False
            if step is not None:
                self.eval(step, loop_env, flow)
            iteration += 1
        flow.continue_mask = continue_saved
        flow.break_mask = break_saved
        flow.mask = saved_mask

    def _shadow_trip_count(self, stmt, loop_env: _Env) -> Optional[int]:
        """Statically count loop trips by simulating init/cond/step with
        Python numbers (per-pixel masking can turn the loop counter into a
        tensor mid-loop, so the live condition cannot control the Python
        loop). Returns None when the condition stays Python-evaluable (the
        live loop just uses it)."""
        _, init, cond_ast, step, _body = stmt
        if cond_ast is None:
            return None

        # Identify the loop variable from init: decl or assignment
        name = None
        start = None
        if init[0] == "decl":
            decls = init[2]
            if len(decls) == 1 and decls[0][2] is not None:
                name = decls[0][0]
                value = loop_env.lookup(name)
                if value is not None and value.is_python:
                    start = value.data
        elif init[0] == "expr" and init[1] is not None and init[1][0] == "assign":
            target = init[1][2]
            if target[0] == "ident":
                name = target[1]
                value = loop_env.lookup(name)
                if value is not None and value.is_python:
                    start = value.data
        if name is None or start is None:
            return None

        def shadow_eval(ast, current) -> Any:
            kind = ast[0]
            if kind == "num":
                return ast[1]
            if kind == "ident":
                if ast[1] == name:
                    return current
                value = loop_env.lookup(ast[1])
                if value is not None and value.is_python:
                    return value.data
                if ast[1] in _CONSTANTS:
                    return _CONSTANTS[ast[1]]
                raise GlslError("shadow: non-static name " + ast[1])
            if kind == "binary":
                a = shadow_eval(ast[2], current)
                b = shadow_eval(ast[3], current)
                return _PY_BINOPS[ast[1]](a, b)
            if kind == "unary":
                value = shadow_eval(ast[2], current)
                return {"-": lambda v: -v, "+": lambda v: v,
                        "!": lambda v: not v}[ast[1]](value)
            if kind == "call" and ast[1][0] == "ident" and ast[1][1] == "float":
                return float(shadow_eval(ast[2][0], current))
            if kind == "call" and ast[1][0] == "ident" and ast[1][1] == "int":
                return int(shadow_eval(ast[2][0], current))
            raise GlslError("shadow: unsupported " + kind)

        def shadow_step(current) -> Any:
            if step is None:
                raise GlslError("shadow: missing step")
            s = step
            if s[0] in ("prefix", "postfix"):
                target = s[2]
                if target[0] == "ident" and target[1] == name:
                    return current + (1 if s[1] == "++" else -1)
                raise GlslError("shadow: step on other var")
            if s[0] == "assign" and s[2][0] == "ident" and s[2][1] == name:
                if s[1] == "=":
                    return shadow_eval(s[3], current)
                delta = shadow_eval(s[3], current)
                return _PY_BINOPS[s[1][0]](current, delta)
            raise GlslError("shadow: unsupported step")

        try:
            current = start
            trips = 0
            while shadow_eval(cond_ast, current):
                trips += 1
                if trips > self.MAX_TRIPS:
                    raise GlslError(f"{self.origin}: loop exceeds 65536 trips")
                current = shadow_step(current)
            return trips
        except GlslError as error:
            if "65536" in str(error):
                raise
            return None  # fall back to the live Python-evaluable condition

    # ------------------------------------------------------------------ #
    # Masked loops: big/data-dependent loops run their body once a trip on
    # the carried variables and the sticky flow masks; per-lane `break`/
    # `return`/condition failure drop lanes out of the active mask, and the
    # loop stops when no lane is active (read every `sync_every` trips) or
    # at its cap. The reference traces the same body once into
    # lax.while_loop (shaderflow_tpu/glsl.py:906-1073).

    def _exec_for_lowered(self, stmt, loop_env: _Env, flow: _Flow,
                          trips: Optional[int]) -> None:
        _, _init, cond_ast, step, body = stmt

        saved_mask = flow.mask
        break_saved = flow.break_mask
        continue_saved = flow.continue_mask
        entry_mask = _mask_andnot(_mask_andnot(saved_mask, break_saved),
                                  continue_saved)

        mutated: set = set()
        _collect_mutated(body, mutated)
        if step is not None:
            _collect_mutated(step, mutated)
        cond_stores: set = set()
        if cond_ast is not None:
            _collect_mutated(cond_ast, cond_stores)
        mutated |= cond_stores
        kinds: dict[str, str] = {}
        for name in sorted(mutated):
            owner = loop_env.owner(name)
            if owner is None:
                continue  # declared inside the body: loop-local
            gv = owner.vars[name]
            if _kind_dtype(gv.kind) is None:
                raise _LowerUnsupported(f"cannot carry {gv.kind} {name!r}")
            kinds[name] = gv.kind

        cap = trips if trips is not None else self.MAX_TRIPS
        # A condition that stores (`while (i++ < n)`) runs under the entry
        # mask, not the active one: its trips after every lane stopped are
        # not masked, so such a loop reads the active mask every trip.
        every = 1 if cond_stores else max(1, int(self.sync_every))

        def carried(kind: str, data) -> torch.Tensor:
            dtype = _kind_dtype(kind)
            if dtype is None:
                raise _LowerUnsupported(f"cannot carry a {kind} value")
            return self._arr(data, dtype)

        values = {name: carried(kind, loop_env.owner(name).vars[name].data)
                  for name, kind in kinds.items()}
        state = {"_ret": self._mask_arr(flow.returned),
                 "_brk": self._mask_arr(False),
                 "_dis": self._mask_arr(flow.discarded)}
        ret = (None if flow.ret_value is None else
               GV(flow.ret_value.kind, carried(flow.ret_value.kind, flow.ret_value.data)))

        def materialize():
            """Write the carry into the owner envs; -> restore list."""
            originals = []
            for name, kind in kinds.items():
                owner = loop_env.owner(name)
                originals.append((owner, name, owner.vars[name]))
                owner.vars[name] = GV(kind, values[name])
            return originals

        def restore(originals) -> None:
            for owner, name, gv in originals:
                owner.vars[name] = gv

        def make_flow() -> _Flow:
            f = _Flow()
            f.mask = entry_mask
            f.returned = state["_ret"]
            f.break_mask = state["_brk"]
            f.discarded = state["_dis"]
            f.ret_value = ret
            return f

        def eval_cond_mask(f: _Flow):
            if cond_ast is None:
                return None
            cond = self.eval(cond_ast, loop_env, f)
            if cond.is_python:
                return None if cond.data else False
            return self._arr(cond.data, torch.bool)

        def any_active() -> bool:
            """The reference's cond_fn: is any lane still active? (A host
            read of a device value when the mask is a tensor.)"""
            originals = materialize()
            try:
                active = _mask_and(entry_mask, eval_cond_mask(make_flow()))
                active = _mask_andnot(active, state["_ret"])
                active = _mask_andnot(active, state["_brk"])
            finally:
                restore(originals)
            if active is None or active is False:
                return active is None
            self.stats["syncs"] += 1
            return bool(active.any())

        def trip() -> None:
            nonlocal ret
            originals = materialize()
            try:
                f = make_flow()
                f.mask = _mask_and(entry_mask, eval_cond_mask(f))
                f.continue_mask = False
                self.exec_stmt(body, _Env(loop_env), f)
                # `continue` rejoins at the step expression (C semantics)
                f.continue_mask = False
                if step is not None:
                    self.eval(step, loop_env, f)
                state["_ret"] = self._mask_arr(f.returned)
                state["_brk"] = self._mask_arr(f.break_mask)
                state["_dis"] = self._mask_arr(f.discarded)
                if f.ret_value is not None:
                    ret = GV(f.ret_value.kind, carried(f.ret_value.kind, f.ret_value.data))
                for name, kind in kinds.items():
                    live = loop_env.owner(name).vars[name]
                    if live.kind != kind:
                        raise _LowerUnsupported(f"{name!r} changed kind {kind}->{live.kind}")
                    values[name] = carried(kind, live.data)
            finally:
                restore(originals)

        self.stats["lowered_loops"] += 1
        iteration = 0
        try:
            while iteration < cap:
                if iteration % every == 0 and not any_active():
                    break
                trip()
                iteration += 1
        except (GlslError, TypeError, ValueError, IndexError, RuntimeError) as error:
            raise _LowerUnsupported(str(error)) from None
        self.stats["trips"] += iteration

        for name in kinds:
            loop_env.owner(name).vars[name] = GV(kinds[name], values[name])
        flow.returned = state["_ret"]
        flow.discarded = state["_dis"]
        if ret is not None:
            flow.ret_value = ret
        flow.break_mask = break_saved
        flow.continue_mask = continue_saved
        flow.mask = saved_mask

    # ------------------------------------------------------------------ #
    # Stores

    def _merge(self, old: GV, new: GV, mask) -> GV:
        if mask is None or mask is True:
            return new
        if mask is False:
            return old
        new = self._convert(new, old.kind) if old.kind != new.kind else new
        mask_data = mask
        if not _is_scalar_kind(old.kind):
            mask_data = self._arr(mask)[..., None]
        merged = torch.where(mask_data, self._arr(new.data), self._arr(old.data))
        return GV(old.kind, merged)

    def store(self, target, value: GV, env: _Env, flow: _Flow) -> None:
        active = flow.active()
        if target[0] == "ident":
            name = target[1]
            owner = env.owner(name)
            if owner is None:
                raise GlslError(f"{self.origin}: assignment to undeclared {name!r}")
            old = owner.vars[name]
            if old.kind != value.kind:
                value = self._convert(value, old.kind)
            owner.vars[name] = self._merge(old, value, active)
            return
        if target[0] == "member":
            base_ast, member = target[1], target[2]
            base = self.eval(base_ast, env, flow)
            if base.kind not in _VEC_SIZE:
                raise GlslError(f"{self.origin}: cannot assign member of {base.kind}")
            idx = [_SWIZZLE[c] for c in member]
            new_base = self._swizzle_store(base, idx, value, active)
            self.store(base_ast, new_base, env, _Flow())  # already masked
            return
        if target[0] == "index":
            base_ast, index_ast = target[1], target[2]
            base = self.eval(base_ast, env, flow)
            index = self.eval(index_ast, env, flow)
            if not index.is_python:
                raise GlslError(f"{self.origin}: dynamic indexed store unsupported")
            if base.kind in _VEC_SIZE:
                new_base = self._swizzle_store(base, [int(index.data)], value, active)
            elif base.kind.startswith("array"):
                data = self._arr(base.data).clone()
                data[int(index.data)] = self._arr(value.data)
                new_base = GV(base.kind, data)
            else:
                raise GlslError(f"{self.origin}: cannot index-store {base.kind}")
            self.store(base_ast, new_base, env, _Flow())
            return
        raise GlslError(f"{self.origin}: invalid assignment target {target[0]!r}")

    def _swizzle_store(self, base: GV, idx: list[int], value: GV, mask) -> GV:
        n = base.components
        data = self._arr(base.data, torch.float32 if base.kind.startswith("vec") else None)
        value_data = self._arr(value.data)
        if len(idx) == 1:
            new_components = {idx[0]: value_data}
        else:
            new_components = {j: value_data[..., k] for k, j in enumerate(idx)}
        columns = []
        for j in range(n):
            old_j = data[..., j]
            if j in new_components:
                new_j = new_components[j]
                if mask is None or mask is True:
                    merged = torch.broadcast_to(
                        new_j, torch.broadcast_shapes(new_j.shape, old_j.shape))
                elif mask is False:
                    merged = old_j
                else:
                    merged = torch.where(mask, new_j, old_j)
                columns.append(merged)
            else:
                columns.append(old_j)
        shape = torch.broadcast_shapes(*(c.shape for c in columns))
        columns = [torch.broadcast_to(c.to(data.dtype), shape) for c in columns]
        return GV(base.kind, torch.stack(columns, dim=-1))

    # ------------------------------------------------------------------ #
    # Expressions

    def eval(self, ast, env: _Env, flow: _Flow) -> GV:
        op = ast[0]
        if op == "num":
            value = ast[1]
            if isinstance(value, bool):
                return GV("bool", value)
            return GV("int" if isinstance(value, int) else "float", value)
        if op == "ident":
            return self.resolve(ast[1], env)
        if op == "binary":
            return self.eval_binary(ast[1], self.eval(ast[2], env, flow),
                                    self.eval(ast[3], env, flow))
        if op == "unary":
            return self.eval_unary(ast[1], self.eval(ast[2], env, flow))
        if op == "ternary":
            cond = self.eval(ast[1], env, flow)
            if cond.is_python:
                return self.eval(ast[2] if cond.data else ast[3], env, flow)
            a = self.eval(ast[2], env, flow)
            b = self.eval(ast[3], env, flow)
            kind = a.kind if not _is_scalar_kind(a.kind) else _promote_num(a, b)
            a = self._convert(a, kind)
            b = self._convert(b, kind)
            mask = self._arr(cond.data, torch.bool)
            if kind in _VEC_SIZE:
                mask = mask[..., None] if mask.ndim > 0 else mask
            return GV(kind, torch.where(mask, self._arr(a.data), self._arr(b.data)))
        if op == "assign":
            _, aop, target, value_ast = ast
            value = self.eval(value_ast, env, flow)
            if aop != "=":
                current = self.eval(target, env, flow)
                value = self.eval_binary(aop[0], current, value)
            self.store(target, value, env, flow)
            return value
        if op in ("prefix", "postfix"):
            _, pop, target = ast
            current = self.eval(target, env, flow)
            one = GV("int", 1)
            updated = self.eval_binary("+" if pop == "++" else "-", current, one)
            self.store(target, updated, env, flow)
            return updated if op == "prefix" else current
        if op == "member":
            return self.eval_member(ast, env, flow)
        if op == "index":
            base = self.eval(ast[1], env, flow)
            index = self.eval(ast[2], env, flow)
            return self.eval_index(base, index)
        if op == "call":
            return self.eval_call(ast, env, flow)
        if op == "comma":
            self.eval(ast[1], env, flow)
            return self.eval(ast[2], env, flow)
        raise GlslError(f"{self.origin}: unhandled expression {op!r}")

    # -- identifier resolution --------------------------------------------
    def resolve(self, name: str, env: _Env) -> GV:
        value = env.lookup(name)
        if value is not None:
            return value
        if name in _CONSTANTS:
            return GV("float", _CONSTANTS[name])
        sf = self.sf
        if name in ("astuv", "agluv", "stuv", "gluv", "stxy", "glxy"):
            return GV("vec2", getattr(sf, name))
        if name == "sgluv":
            return GV("vec2", sf.gluv)
        if name in ("instance", "gl_InstanceID"):
            return GV("int", sf.instance)  # vertex/default.glsl:5
        # uniforms
        uniform = sf._uniforms.get(name, sf._statics.get(name))
        if uniform is not None:
            return self._wrap_uniform(uniform)
        # textures ('name' or 'name<T>x<L>')
        sampler = self._try_sampler(name)
        if sampler is not None:
            return sampler
        raise GlslError(f"{self.origin}: unknown identifier {name!r}")

    def _wrap_uniform(self, value) -> GV:
        if isinstance(value, bool):
            return GV("bool", value)
        if isinstance(value, int):
            return GV("int", value)
        if isinstance(value, float):
            return GV("float", value)
        arr = self._arr(value)
        if arr.ndim == 0:
            kind = ("bool" if arr.dtype == torch.bool else
                    "float" if arr.dtype.is_floating_point else "int")
            return GV(kind, arr)
        if arr.ndim == 1 and arr.shape[0] in (2, 3, 4):
            return GV(f"vec{arr.shape[0]}", arr)
        raise GlslError(f"{self.origin}: cannot map uniform of shape {tuple(arr.shape)}")

    def _try_sampler(self, name: str) -> Optional[GV]:
        sf = self.sf
        if name in sf._textures:
            return GV("sampler", sf.tex(name))
        m = re.fullmatch(r"(\w+?)(\d+)x(\d+)", name)
        if m and m.group(1) in sf._textures:
            return GV("sampler", sf.tex(m.group(1), temporal=int(m.group(2)),
                                        layer=int(m.group(3))))
        # `iTexT` alias = temporal T, last layer (reference texture.py:359-360)
        m = re.fullmatch(r"(\w+?)(\d+)", name)
        if m and m.group(1) in sf._textures:
            return GV("sampler", sf.tex(m.group(1), temporal=int(m.group(2))))
        return None

    # -- operators ---------------------------------------------------------
    def eval_binary(self, op: str, a: GV, b: GV) -> GV:
        if op in ("&&", "||"):
            if a.is_python and b.is_python:
                return GV("bool", (a.data and b.data) if op == "&&"
                          else (a.data or b.data))
            fn = torch.logical_and if op == "&&" else torch.logical_or
            return GV("bool", fn(self._arr(a.data, torch.bool),
                                 self._arr(b.data, torch.bool)))

        # matrices
        if a.kind in _MAT_SIZE or b.kind in _MAT_SIZE:
            return self._matrix_binary(op, a, b)

        if op in ("<", ">", "<=", ">=", "==", "!="):
            va, vb = self._align(a, b)
            if _is_py(va) and _is_py(vb):
                return GV("bool", _PY_BINOPS[op](va, vb))
            return GV("bool", _PY_BINOPS[op](self._arr(va), self._arr(vb)))

        kind = self._result_kind(a, b)
        va, vb = self._align(a, b)
        if op == "%":
            if kind == "float":
                result = self._dev(sl.glsl_mod(va, vb))
            elif _is_py(va) and _is_py(vb):
                result = va % vb
            else:
                result = torch.remainder(self._arr(va), self._arr(vb))
        elif op == "/" and kind == "int" and a.kind == "int" and b.kind == "int":
            if _is_py(va) and _is_py(vb):
                result = int(va / vb) if vb != 0 else 0
            else:
                result = torch.floor_divide(self._arr(va, torch.int32),
                                            self._arr(vb, torch.int32))
        elif _is_py(va) and _is_py(vb):
            result = _PY_BINOPS[op](va, vb)
        elif op == "/" and _is_py(vb) and not isinstance(vb, bool) and vb != 0:
            # XLA folds a division by a constant into a product with its
            # f32 reciprocal
            result = self._arr(va) * reciprocal(vb)
        else:
            result = _PY_BINOPS[op](self._arr(va), self._arr(vb))
        return GV(kind, result)

    def _result_kind(self, a: GV, b: GV) -> str:
        if a.kind in _VEC_SIZE and b.kind in _VEC_SIZE:
            if a.components != b.components:
                raise GlslError(f"{self.origin}: {a.kind} vs {b.kind}")
            return a.kind if a.kind.startswith("vec") else b.kind
        if a.kind in _VEC_SIZE:
            return a.kind
        if b.kind in _VEC_SIZE:
            return b.kind
        return _promote_num(a, b)

    def _align(self, a: GV, b: GV):
        """Payloads ready for a componentwise binary op."""
        va, vb = a.data, b.data
        if a.kind in _VEC_SIZE and _is_scalar_kind(b.kind):
            vb = self._pixelwise(vb)
        elif b.kind in _VEC_SIZE and _is_scalar_kind(a.kind):
            va = self._pixelwise(va)
        return va, vb

    def _matrix_binary(self, op: str, a: GV, b: GV) -> GV:
        """Matrix products as left-to-right sums of products (XLA's order
        for these small contractions); matrices are (..., row, column)."""
        if op != "*":
            raise GlslError(f"{self.origin}: matrix op {op!r} unsupported")
        if a.kind in _MAT_SIZE and b.kind in _VEC_SIZE:
            m, v = self._arr(a.data), self._arr(b.data)
            return GV(b.kind, torch.stack(
                [_sum(m[..., i, j] * v[..., j] for j in range(m.shape[-1]))
                 for i in range(m.shape[-2])], dim=-1))
        if a.kind in _VEC_SIZE and b.kind in _MAT_SIZE:
            v, m = self._arr(a.data), self._arr(b.data)
            return GV(a.kind, torch.stack(
                [_sum(v[..., i] * m[..., i, j] for i in range(m.shape[-2]))
                 for j in range(m.shape[-1])], dim=-1))
        if a.kind in _MAT_SIZE and b.kind in _MAT_SIZE:
            x, y = self._arr(a.data), self._arr(b.data)
            n = x.shape[-1]
            rows = [torch.stack([_sum(x[..., i, k] * y[..., k, j] for k in range(n))
                                 for j in range(y.shape[-1])], dim=-1)
                    for i in range(x.shape[-2])]
            return GV(a.kind, torch.stack(rows, dim=-2))
        if _is_scalar_kind(b.kind):
            return GV(a.kind, self._arr(a.data) * self._scalar(b.data))
        if _is_scalar_kind(a.kind):
            return GV(b.kind, self._scalar(a.data) * self._arr(b.data))
        raise GlslError(f"{self.origin}: matrix op {a.kind} * {b.kind}")

    def _scalar(self, value):
        return value if _is_py(value) else self._arr(value)

    def eval_unary(self, op: str, value: GV) -> GV:
        if op == "+":
            return value
        if op == "-":
            return GV(value.kind, -value.data if value.is_python
                      else -self._arr(value.data))
        if op == "!":
            return GV("bool", (not value.data) if value.is_python
                      else torch.logical_not(self._arr(value.data, torch.bool)))
        raise GlslError(f"{self.origin}: unary {op!r} unsupported")

    # -- members / swizzles ------------------------------------------------
    def eval_member(self, ast, env: _Env, flow: _Flow) -> GV:
        base = self.eval(ast[1], env, flow)
        member = ast[2]
        if base.kind == "camera":
            return self._camera_member(base.data, member)
        if base.kind in _VEC_SIZE:
            if any(c not in _SWIZZLE for c in member):
                raise GlslError(f"{self.origin}: bad swizzle .{member}")
            idx = [_SWIZZLE[c] for c in member]
            data = self._arr(base.data)
            scalar_kind = ("int" if base.kind.startswith("i") else
                           "bool" if base.kind.startswith("b") else "float")
            if len(idx) == 1:
                return GV(scalar_kind, data[..., idx[0]])
            if idx == list(range(idx[0], idx[-1] + 1)):
                picked = data[..., idx[0]:idx[-1] + 1]
            else:
                picked = data[..., idx]
            prefix = "i" if base.kind.startswith("i") else \
                     "b" if base.kind.startswith("b") else ""
            return GV(f"{prefix}vec{len(idx)}", picked)
        raise GlslError(f"{self.origin}: member .{member} on {base.kind}")

    def _camera_member(self, rays, member: str) -> GV:
        vec3_fields = {"origin", "target", "position", "forward", "up", "right"}
        vec2_fields = {"gluv", "agluv", "stuv", "astuv", "stxy", "glxy"}
        alias = {"upward": "up"}
        member_l = alias.get(member, member)
        if member_l in vec2_fields:
            return GV("vec2", getattr(rays, member_l))
        if member_l in vec3_fields:
            return GV("vec3", self._arr(getattr(rays, member_l), torch.float32))
        if member_l == "out_of_bounds":
            return GV("bool", rays.out_of_bounds)
        if member_l == "ray" or member_l == "direction":
            return GV("vec3", sl.normalize(rays.target - rays.origin))
        # scalar camera uniforms: zoom, isometric, orbital, dolly, ...
        uniform_name = "iCamera" + "".join(
            part.capitalize() for part in member.split("_"))
        value = self.sf._uniforms.get(uniform_name,
                                      self.sf._statics.get(uniform_name))
        if value is not None:
            return self._wrap_uniform(value)
        raise GlslError(f"{self.origin}: camera has no member .{member}")

    def eval_index(self, base: GV, index: GV) -> GV:
        if base.kind in _VEC_SIZE:
            data = self._arr(base.data)
            scalar_kind = ("int" if base.kind.startswith("i") else
                           "bool" if base.kind.startswith("b") else "float")
            if index.is_python:
                return GV(scalar_kind, data[..., int(index.data)])
            # jnp.take_along_axis: negative indices wrap, out-of-range
            # ones read NaN
            n = data.shape[-1]
            idx = self._arr(index.data, torch.int32).to(torch.int64)
            idx = torch.where(idx < 0, idx + n, idx)
            inside = (idx >= 0) & (idx < n)
            picked = torch.gather(torch.broadcast_to(data, idx.shape + data.shape[-1:]),
                                  -1, idx.clamp(0, n - 1)[..., None])[..., 0]
            if picked.dtype.is_floating_point:
                picked = torch.where(inside, picked, float("nan"))
            return GV(scalar_kind, picked)
        if base.kind.startswith("array:"):
            elem_kind = base.kind.split(":")[1]
            data = self._arr(base.data)
            if index.is_python:
                return GV(elem_kind, data[int(index.data)])
            # jnp.take(..., mode="clip") on the flattened array
            flat = data.reshape(-1)
            idx = self._arr(index.data, torch.int32).to(torch.int64)
            return GV(elem_kind, flat[idx.clamp(0, flat.numel() - 1)])
        if base.kind in _MAT_SIZE:
            if not index.is_python:
                raise GlslError(f"{self.origin}: dynamic matrix index")
            return GV(f"vec{_MAT_SIZE[base.kind]}",
                      self._arr(base.data)[..., int(index.data), :])
        raise GlslError(f"{self.origin}: cannot index {base.kind}")

    # -- calls -------------------------------------------------------------
    def eval_call(self, ast, env: _Env, flow: _Flow) -> GV:
        callee = ast[1]
        if callee[0] == "arraytype":
            _, elem_type, size = callee
            args = [self.eval(a, env, flow) for a in ast[2]]
            if len(args) != size:
                raise GlslError(f"{self.origin}: array ctor arity")
            dtype = torch.int32 if elem_type == "int" else torch.float32
            return GV(f"array:{elem_type}", self._arr([a.data for a in args], dtype))
        name = callee[1]

        # GetCamera(iCamera): bind the camera struct into the caller scope
        if name == "GetCamera":
            target = ast[2][0]
            if target[0] != "ident":
                raise GlslError(f"{self.origin}: GetCamera needs a name")
            cam_name = target[1]
            env.declare(cam_name, GV("camera", self.sf.get_camera(cam_name)))
            return GV("void", None)

        args = [self.eval(a, env, flow) for a in ast[2]]

        # Constructors
        if name in _VEC_SIZE:
            return self._construct_vec(name, args)
        if name in _MAT_SIZE:
            return self._construct_mat(name, args)
        if name in ("float", "int", "bool", "uint"):
            return self._cast_scalar(name, args[0])

        # User-defined functions
        if name in self.functions:
            return self.call_user(self.functions[name], args)

        # <Name>Texture(t, l, uv) metaprogrammer accessors: plain texture()
        # on the (t, l) box (reference texture.py:363-367)
        m = re.fullmatch(r"(\w+?)Texture", name)
        if m and m.group(1) in self.sf._textures:
            t, layer, uv = args
            if not (t.is_python and layer.is_python):
                raise GlslError(
                    f"{self.origin}: {name}(t, l, uv) needs statically "
                    "countable t/l (a python loop counter or literal)")
            sampler = self.sf.tex(m.group(1), temporal=int(t.data),
                                  layer=int(layer.data))
            return self._pad_vec4(sampling.sample(sampler, self._arr(uv.data)))

        builtin = _BUILTINS.get(name)
        if builtin is not None:
            return builtin(self, args)
        raise GlslError(f"{self.origin}: unknown function {name!r}")

    def call_user(self, func, args: list[GV]) -> GV:
        _, ret_type, name, params, body = func
        if len(args) != len(params):
            raise GlslError(f"{self.origin}: {name} expects {len(params)} args")
        env = _Env()
        for (ptype, pname), arg in zip(params, args):
            env.declare(pname, self._coerce_decl(ptype, None, arg))
        flow = _Flow()
        self.exec_block(body, env, flow)
        if ret_type == "void":
            return GV("void", None)
        if flow.ret_value is None:
            raise GlslError(f"{self.origin}: {name} returned no value")
        return self._convert(flow.ret_value, ret_type)

    # -- constructors / conversions ---------------------------------------
    def _construct_vec(self, kind: str, args: list[GV]) -> GV:
        n = _VEC_SIZE[kind]
        dtype = _vec_dtype(kind)
        parts = []
        for arg in args:
            if arg.kind in _VEC_SIZE:
                data = self._arr(arg.data)
                for j in range(arg.components):
                    parts.append(data[..., j])
            else:
                parts.append(arg.data)
        if len(parts) == 1:
            parts = parts * n
        if len(parts) != n:
            raise GlslError(f"{self.origin}: {kind} constructor with "
                            f"{len(parts)} components")
        if all(_is_py(p) for p in parts):
            return GV(kind, self._const(parts, dtype))
        columns = torch.broadcast_tensors(*(self._arr(p, dtype) for p in parts))
        return GV(kind, torch.stack(columns, dim=-1))

    def _construct_mat(self, kind: str, args: list[GV]) -> GV:
        n = _MAT_SIZE[kind]
        if len(args) == 1 and _is_scalar_kind(args[0].kind):
            return GV(kind, self._const(np.eye(n), torch.float32) * self._scalar(args[0].data))
        flat = []
        for arg in args:
            if arg.kind in _VEC_SIZE:
                data = self._arr(arg.data)
                flat.extend(data[..., j] for j in range(arg.components))
            else:
                flat.append(arg.data)
        if len(flat) != n * n:
            raise GlslError(f"{self.origin}: {kind} constructor arity")
        # GLSL matrices are column-major: mat2(a,b,c,d) has columns (a,b),(c,d)
        if all(_is_py(p) for p in flat):
            return GV(kind, self._const(np.asarray(flat).reshape(n, n).T, torch.float32))
        cols = [torch.stack([self._f32(flat[c * n + r]) for r in range(n)], dim=-1)
                for c in range(n)]
        return GV(kind, torch.stack(cols, dim=-1))  # (..., row, col)

    def _cast_scalar(self, kind: str, value: GV) -> GV:
        kind = "int" if kind == "uint" else kind
        if value.is_python:
            py = {"float": float, "int": int, "bool": bool}[kind]
            return GV(kind, py(value.data))
        arr = self._arr(value.data)
        dtype = {"float": torch.float32, "int": torch.int32, "bool": torch.bool}[kind]
        if kind == "int" and arr.dtype.is_floating_point:
            arr = torch.trunc(arr)
        return GV(kind, arr.to(dtype))

    def _convert(self, value: GV, kind: str) -> GV:
        if value.kind == kind:
            return value
        if _is_scalar_kind(kind) and _is_scalar_kind(value.kind):
            return self._cast_scalar(kind, value)
        if kind in _VEC_SIZE and _is_scalar_kind(value.kind):
            return self._construct_vec(kind, [value])
        if kind in _VEC_SIZE and value.kind in _VEC_SIZE \
                and _VEC_SIZE[kind] == _VEC_SIZE[value.kind]:
            return GV(kind, self._arr(value.data, _vec_dtype(kind)))
        raise GlslError(f"{self.origin}: cannot convert {value.kind} -> {kind}")

    def _default_value(self, type_name: str, size: Optional[int]) -> GV:
        if size is not None:
            dtype = torch.int32 if type_name == "int" else torch.float32
            return GV(f"array:{type_name}", self._const([0] * size, dtype))
        if type_name in _VEC_SIZE:
            return GV(type_name, self._const([0] * _VEC_SIZE[type_name],
                                             _vec_dtype(type_name)))
        if type_name in _MAT_SIZE:
            return GV(type_name, self._const(np.eye(_MAT_SIZE[type_name]), torch.float32))
        if type_name == "int":
            return GV("int", 0)
        if type_name == "bool":
            return GV("bool", False)
        return GV("float", 0.0)

    def _coerce_decl(self, type_name: str, size: Optional[int], value: GV) -> GV:
        if size is not None:
            if not value.kind.startswith("array"):
                raise GlslError(f"{self.origin}: array initializer expected")
            return GV(f"array:{type_name}", value.data)
        if type_name == "sampler2D":
            if value.kind != "sampler":
                raise GlslError(f"{self.origin}: sampler2D initializer expected")
            return value
        return self._convert(value, type_name)

    # -- texturing ---------------------------------------------------------
    def _sampler_arg(self, value: GV) -> Sampler2D:
        if value.kind == "sampler":
            return value.data
        raise GlslError(f"{self.origin}: expected a sampler")

    def _pad_vec4(self, data) -> GV:
        """GL pads missing texture components with (0, 0, 0, 1)."""
        data = self._arr(data)
        channels = data.shape[-1]
        if channels == 4:
            return GV("vec4", data)
        fill = [data[..., j] for j in range(channels)]
        zeros = torch.zeros_like(data[..., 0])
        while len(fill) < 3:
            fill.append(zeros)
        fill.append(torch.ones_like(zeros))
        return GV("vec4", torch.stack(fill, dim=-1))


def _sum(terms):
    """Left-to-right sum of an iterable of tensors."""
    total = None
    for term in terms:
        total = term if total is None else total + term
    return total


# =========================================================================== #
# Builtin function table

_CONSTANTS = {"PI": sl.PI, "TAU": sl.TAU, "EULER": math.e,
              "E": math.e, "PHI": (1 + 5 ** 0.5) / 2}

_PY_BINOPS: dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "<": lambda a, b: a < b, ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}


def _componentwise(fn, fn_py=None, library: bool = False):
    """Builtin applying componentwise over any mix of scalars/vectors,
    keeping Python scalars Python where the reference does. `fn` is a torch
    function (Python payloads become f32 constants, as jnp functions take
    them) or, with `library`, a stdlib function that takes Python numbers
    itself (the reference calls it with them)."""
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        if fn_py is not None and all(a.is_python for a in args):
            return GV("float", float(fn_py(*(a.data for a in args))))
        kind = "float"
        for a in args:
            if a.kind in _VEC_SIZE:
                kind = a.kind if not a.kind.startswith(("i", "b")) else \
                    "vec" + a.kind[-1]
                break
        payloads = []
        for a in args:
            if _is_scalar_kind(a.kind) and kind in _VEC_SIZE:
                payloads.append(interp._pixelwise(a.data))
            else:
                payloads.append(interp._f32(a.data) if not a.is_python else a.data)
        if not library:
            payloads = [interp._f32(p) if _is_py(p) else p for p in payloads]
        return GV(kind, interp._dev(fn(*payloads)))
    return impl


def _vec_reduce(fn, out_kind="float"):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        return GV(out_kind, interp._dev(fn(*(interp._f32(a.data) for a in args))))
    return impl


def _bi_texture(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    return interp._pad_vec4(sampling.sample(sampler, interp._arr(args[1].data)))


def _bi_texel_fetch(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    return interp._pad_vec4(sampling.texel_fetch(sampler, interp._arr(args[1].data)))


def _bi_texture_size(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    height, width = sampler.data.shape[:2]
    return GV("ivec2", interp._const([width, height], torch.int32))


def _space_texture(attr: str):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        sampler = interp._sampler_arg(args[0])
        uv = interp._arr(args[1].data)
        return interp._pad_vec4(getattr(sampling, attr)(sampler, uv))
    return impl


def _bi_agtexture(interp: Interpreter, args: list[GV]) -> GV:
    sampler = interp._sampler_arg(args[0])
    uv = interp._arr(args[1].data)
    return interp._pad_vec4(
        sampling.agtexture(sampler, uv, interp.sf.uniform("iWantAspect")))


def _bi_rotate2d(interp: Interpreter, args: list[GV]) -> GV:
    # shaderflow.glsl:75 mat2(c,-s,s,c) is COLUMN-major: columns (c,-s),(s,c)
    # -> the (row, col) matrix is [[c, s], [-s, c]]
    angle = args[0].data
    if args[0].is_python:
        cos, sin = math.cos(angle), math.sin(angle)
        return GV("mat2", interp._const([[cos, sin], [-sin, cos]], torch.float32))
    angle = interp._arr(angle)
    cos, sin = torch.cos(angle).to(torch.float32), torch.sin(angle).to(torch.float32)
    row0 = torch.stack([cos, sin], dim=-1)
    row1 = torch.stack([-sin, cos], dim=-1)
    return GV("mat2", torch.stack([row0, row1], dim=-2))


def _bi_rotate2deg(interp: Interpreter, args: list[GV]) -> GV:
    angle = (math.radians(args[0].data) if args[0].is_python
             else torch.deg2rad(interp._f32(args[0].data)))
    return _bi_rotate2d(interp, [GV("float", angle)])


def _bi_zoom(interp: Interpreter, args: list[GV]) -> GV:
    uv = interp._arr(args[0].data)
    factor = args[1].data
    anchor = interp._arr(args[2].data) if len(args) > 2 else None
    return GV("vec2", sl.zoom(uv, interp._pixelwise(factor), anchor))


def _coordinate_map(fn):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        payloads = [interp._arr(args[0].data)]
        payloads += [a.data for a in args[1:]]
        return GV("vec2", interp._dev(fn(*payloads)))
    return impl


def _bi_mix(interp: Interpreter, args: list[GV]) -> GV:
    a, b, t = args
    kind = a.kind if a.kind in _VEC_SIZE else (
        b.kind if b.kind in _VEC_SIZE else "float")
    da = interp._pixelwise(a.data) if _is_scalar_kind(a.kind) and kind in _VEC_SIZE else a.data
    db = interp._pixelwise(b.data) if _is_scalar_kind(b.kind) and kind in _VEC_SIZE else b.data
    dt = interp._pixelwise(t.data) if _is_scalar_kind(t.kind) and kind in _VEC_SIZE else t.data
    if all(isinstance(v, (int, float)) for v in (da, db, dt)):
        return GV("float", da * (1 - dt) + db * dt)
    return GV(kind, sl.mix(interp._f32(da), interp._f32(db), dt))


def _sd(fn):
    def impl(interp: Interpreter, args: list[GV]) -> GV:
        return GV("float", interp._dev(fn(*(interp._f32(a.data) if not a.is_python
                                            else a.data for a in args))))
    return impl


def _clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _pow(x, y):
    """jnp.power: a Python exponent stays a scalar (torch, like XLA, turns
    pow(x, 2) into x * x)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32)
    return torch.pow(x, y)


_BUILTINS: dict[str, Callable[[Interpreter, list[GV]], GV]] = {
    # angle & trig
    "sin": _componentwise(torch.sin, math.sin), "cos": _componentwise(torch.cos, math.cos),
    "tan": _componentwise(torch.tan, math.tan), "asin": _componentwise(torch.arcsin),
    "acos": _componentwise(torch.arccos),
    "atan": _componentwise(lambda y, x=None: torch.arctan(y) if x is None
                           else torch.arctan2(y, x)),
    "sinh": _componentwise(torch.sinh), "cosh": _componentwise(torch.cosh),
    "tanh": _componentwise(torch.tanh),
    "radians": _componentwise(torch.deg2rad, math.radians),
    "degrees": _componentwise(torch.rad2deg, math.degrees),
    # exponential
    "pow": _componentwise(_pow, math.pow, library=True), "exp": _componentwise(torch.exp),
    "log": _componentwise(torch.log), "exp2": _componentwise(torch.exp2),
    "log2": _componentwise(torch.log2), "sqrt": _componentwise(torch.sqrt, math.sqrt),
    "inversesqrt": _componentwise(lambda x: torch.reciprocal(torch.sqrt(x))),
    # common
    "abs": _componentwise(torch.abs, abs), "sign": _componentwise(torch.sign),
    "floor": _componentwise(torch.floor, math.floor),
    "ceil": _componentwise(torch.ceil, math.ceil),
    "fract": _componentwise(sl.fract, library=True),
    "mod": _componentwise(sl.glsl_mod, library=True),
    "min": _componentwise(torch.minimum, min), "max": _componentwise(torch.maximum, max),
    "clamp": _componentwise(_clip),
    "mix": _bi_mix, "lerp": _bi_mix,
    "step": _componentwise(lambda e, x: (x >= e).to(torch.float32)),
    "smoothstep": _componentwise(sl.smoothstep, library=True),
    "round": _componentwise(torch.round),
    "trunc": _componentwise(torch.trunc),
    # geometric
    "length": _vec_reduce(sl.length), "distance": _vec_reduce(sl.distance),
    "dot": _vec_reduce(sl.dot),
    "cross": _vec_reduce(sl.cross, out_kind="vec3"),
    "normalize": lambda interp, args: GV(args[0].kind,
                                         sl.normalize(interp._arr(args[0].data))),
    "reflect": _vec_reduce(sl.reflect, out_kind="vec3"),
    # texturing
    "texture": _bi_texture, "texture2D": _bi_texture,
    "texelFetch": _bi_texel_fetch, "textureSize": _bi_texture_size,
    "stexture": _space_texture("stexture"), "gtexture": _space_texture("gtexture"),
    "astexture": _space_texture("astexture"), "agtexture": _bi_agtexture,
    # shaderflow.glsl
    "rotate2d": _bi_rotate2d,
    "rotate2deg": _bi_rotate2deg,
    "zoom": _bi_zoom,
    "stuv2gluv": _coordinate_map(sl.stuv2gluv),
    "gluv2stuv": _coordinate_map(sl.gluv2stuv),
    "agluv2gluv": _coordinate_map(sl.agluv2gluv),
    "gluv2agluv": _coordinate_map(sl.gluv2agluv),
    "stuv2stxy": _coordinate_map(sl.stuv2stxy),
    "stxy2stuv": _coordinate_map(sl.stxy2stuv),
    "astuv2stuv": _coordinate_map(sl.astuv2stuv),
    "stuv2astuv": _coordinate_map(sl.stuv2astuv),
    "atan1": _vec_reduce(sl.atan1), "atan1n": _vec_reduce(sl.atan1n),
    "atan2": _componentwise(torch.arctan2),
    "atan2n": _componentwise(lambda y, x: torch.arctan2(y, x) * reciprocal(sl.TAU)),
    "atan_normalized": _componentwise(sl.atan_normalized, library=True),
    "palette": _vec_reduce(sl.palette, out_kind="vec3"),
    "palette_magma": lambda interp, args: GV("vec3", sl.palette_magma(
        interp._f32(args[0].data))),
    "hsv2rgb": _vec_reduce(sl.hsv2rgb, out_kind="vec3"),
    "rgb2hsv": _vec_reduce(sl.rgb2hsv, out_kind="vec3"),
    "noise21": _vec_reduce(sl.noise21),
    "noise22": _vec_reduce(sl.noise22, out_kind="vec2"),
    "smin": _componentwise(sl.smin, library=True),
    "smax": _componentwise(sl.smax, library=True),
    "proportion": _componentwise(sl.proportion, library=True),
    "smoothlerp": _componentwise(sl.smoothlerp, library=True),
    "isBlackKey": _componentwise(sl.is_black_key, library=True),
    "isWhiteKey": _componentwise(sl.is_white_key, library=True),
    # signed distance library (shaderflow.glsl:270-350)
    "sdLine": _sd(sl.sd_line), "sdLineSegment": _sd(sl.sd_line_segment),
    "sdSphere": _sd(sl.sd_sphere), "sdPlane": _sd(sl.sd_plane),
    "sdBox": _sd(sl.sd_box), "sdOctahedron": _sd(sl.sd_octahedron),
    "sdUnion": _sd(sl.sd_union), "sdSmoothUnion": _sd(sl.sd_smooth_union),
    "sdSubtraction": _sd(sl.sd_subtraction),
    "sdSmoothSubtraction": _sd(sl.sd_smooth_subtraction),
    "sdIntersection": _sd(sl.sd_intersection),
    "sdSmoothIntersection": _sd(sl.sd_smooth_intersection),
    "blend": _vec_reduce(sl.blend, out_kind="vec4"),
    "alphaComposite": _vec_reduce(sl.alpha_composite, out_kind="vec4"),
    "saturate_color": _vec_reduce(sl.saturate, out_kind="vec3"),
}


# =========================================================================== #
# Entry point

def looks_like_glsl(source: str) -> bool:
    """Routes sources in ShaderProgram: GLSL main is `void main()`, Python
    shaders are `def main(sf)`."""
    return bool(re.search(r"\bvoid\s+main\s*\(", source))


def compile_fragment(source: str, origin: str = "<glsl>") -> Callable:
    """Parse GLSL fragment source -> pixel function main(sf) -> (H, W, 4).

    The parse happens once here (syntax errors surface immediately, as the
    reference's compile-time GLSL errors do); the returned callable
    interprets the AST on each frame's tensors."""
    tokens = tokenize(source, origin)
    unit = Parser(tokens, origin).parse_unit()
    interpreter = Interpreter(unit, origin)

    def main(sf):
        return interpreter.run(sf)

    main.__name__ = f"glsl_main[{origin}]"
    main.glsl_interpreter = interpreter
    return main
