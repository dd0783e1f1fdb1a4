"""
Analytic operation and byte counts for the port's roofline bounds (T3).

Counterpart of tools/flopcount.py, the JAX package's jaxpr walker, whose
pin is the Pallas fixture of tests/test_flopcount.py:64 (`kern`,
pallas_call :72): x * 2 + 1 over a grid of 4 (32, 128) blocks. Here that
fixture is a CUDA C++ kernel (csrc/fixture.cu, `fixture` below) with its
plain version, and the walker counts two kinds of work:

  * plain PyTorch: every ATen op run inside a `Walker` (a
    TorchDispatchMode) is classed as tools/flopcount.py:36-65 classes
    primitives:
      alu    elementwise ops, one per output element
      sfu    transcendentals (exp, log, sqrt, sin, ...: the card's special
             function units), one per output element
      mma    matrix products and convolutions, 2 * M * N * K
      reductions count one ALU op per input element; layout, indexing and
      dtype conversions count 0.
    A Python loop multiplies its body by running it: the counterpart of
    the `scan` rule there.
  * hand-written kernels: each wrapper declares, in `kernel(...)`, the
    cost of one block of its grid (ops by class, the block's bytes); the
    walker adds body x blocks, as tools/flopcount.py:164-191 does for a
    pallas_call, and skips the ATen ops run inside (the plain version on
    the CPU), so a count does not depend on the device. A kernel's
    data-dependent loop (K3's escape loop) is reported per trip, with its
    multiplier, in Cost.unknown_loops (`unknown_whiles` there); the caller
    closes it with a measured trip count.

Bytes: `io_bytes` is the floor of the top-level inputs and outputs
(count_fn), `kernel_bytes` the declared traffic of hand-written kernels
(each input read once, each output written once). Every count is a floor.

`roofline` turns a count into the least time the card could take: the
larger of its bytes over the memory rate and its operations over the peak
rate of their unit. ALU operations go at one float32 instruction per lane
and clock: the data sheet's 67 TFLOP/s counts a fused multiply-add as two
operations, and the port's kernels forbid that contraction (K1 launches
with enable_fp_fusion=False, the CUDA C++ kernels build with -fmad=false),
so each mul and each add is its own instruction.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# Peaks of one H100 SXM (NVIDIA's data sheet; Hopper white paper)
HBM_BYTES_PER_S = 3.35e12     # device memory
# 128 float32 lanes per SM x 132 SMs x the 1.98 GHz boost clock: one
# uncontracted instruction per lane and clock
ALU_OPS_PER_S = 128 * 132 * 1.98e9
MMA_FLOPS_PER_S = 67e12       # float32 matrix products, an FMA counted as two
# 16 special-function units per SM x 132 SMs x the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# Elementwise ATen ops: one ALU op per output element
ALU = {
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "maximum", "minimum",
    "neg", "abs", "sign", "floor", "ceil", "round", "trunc", "frac", "clamp",
    "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "__and__", "__or__", "__xor__",
    "__invert__", "reciprocal", "square", "lerp", "addcmul", "addcdiv",
    "masked_fill", "isnan", "isinf", "isfinite", "nextafter", "fmax", "fmin",
}
# Transcendentals: one special-function op per output element
SFU = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "sqrt", "rsqrt", "pow", "erf", "erfc", "erfinv", "sigmoid",
    "lgamma", "digamma",
}
# Reductions: one ALU op per input element (max/min with one tensor too)
REDUCE = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "any", "all", "logsumexp", "var",
    "std", "norm", "nansum",
}
MMA = {"mm", "bmm", "addmm", "baddbmm", "convolution"}


@dataclass
class Cost:
    alu: float = 0.0
    sfu: float = 0.0
    mma: float = 0.0
    kernel_bytes: float = 0.0     # declared traffic of hand-written kernels
    io_bytes: float = 0.0         # top-level inputs + outputs (count_fn)
    # Data-dependent loops of kernels: (label, ops of one trip, multiplier)
    unknown_loops: list = field(default_factory=list)

    @property
    def ops(self) -> float:
        return self.alu + self.sfu + self.mma

    @property
    def bytes(self) -> float:
        """The larger of the two byte floors."""
        return max(self.kernel_bytes, self.io_bytes)

    def add(self, other: "Cost") -> None:
        self.alu += other.alu
        self.sfu += other.sfu
        self.mma += other.mma
        self.kernel_bytes += other.kernel_bytes
        self.io_bytes += other.io_bytes
        self.unknown_loops.extend(other.unknown_loops)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.alu * k, self.sfu * k, self.mma * k, self.kernel_bytes * k,
                    self.io_bytes * k, [(n, f, m * k) for n, f, m in self.unknown_loops])


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _base_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("__"):   # add_ -> add
        name = name[:-1]
    return name


def op_cost(func, args, kwargs, out) -> Cost:
    """Cost of one ATen op call (see the module note for the classes)."""
    name = _base_name(func)
    inputs = _tensors((args, kwargs))
    outputs = _tensors(out)
    if not outputs:
        return Cost()
    size = outputs[0].numel()
    if name in MMA:
        if name == "convolution":
            weight = inputs[1]
            return Cost(mma=2.0 * size * math.prod(weight.shape[1:]))
        a, b = (inputs[1], inputs[2]) if name in ("addmm", "baddbmm") else inputs[:2]
        return Cost(mma=2.0 * size * a.shape[-1])
    if name in ("max", "min") and len(inputs) >= 2:
        return Cost(alu=size)               # the elementwise overloads
    if name in REDUCE:
        return Cost(alu=inputs[0].numel() if inputs else size)
    if name in ALU:
        return Cost(alu=size)
    if name in SFU:
        return Cost(sfu=size)
    return Cost()                            # layout, indexing, conversions


_WALKERS: list = []


class Walker(TorchDispatchMode):
    """Counts the work run inside `with Walker() as walker:` into
    walker.cost; walker.kernels maps each declared kernel to its launches."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernels: dict[str, int] = {}
        self._inside_kernel = 0

    def __enter__(self):
        super().__enter__()
        _WALKERS.append(self)
        return self

    def __exit__(self, *exc):
        _WALKERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._inside_kernel:
            self.cost.add(op_cost(func, args, kwargs, out))
        return out


@contextlib.contextmanager
def kernel(name: str, blocks: int, block):
    """Declare one launch of a hand-written kernel (or of its plain version
    on the CPU) around the code that runs it: every active Walker adds
    `block` (the Cost of one block of the grid, or a function returning it,
    called only while a walker is active) times `blocks`, and skips the
    ATen ops run inside."""
    if not _WALKERS:
        yield
        return
    cost = (block() if callable(block) else block).scaled(blocks)
    walkers = list(_WALKERS)
    for walker in walkers:
        walker.cost.add(cost)
        walker.kernels[name] = walker.kernels.get(name, 0) + 1
        walker._inside_kernel += 1
    try:
        yield
    finally:
        for walker in walkers:
            walker._inside_kernel -= 1


def count_fn(fn, *args, **kwargs) -> Cost:
    """Cost of fn(*args, **kwargs) plus the top-level input/output bytes."""
    with Walker() as walker:
        out = fn(*args, **kwargs)
    cost = walker.cost
    for tensor in _tensors((args, kwargs)) + _tensors(out):
        cost.io_bytes += tensor.numel() * tensor.element_size()
    return cost


def roofline(cost: Cost, loop_trips: float = 0.0) -> tuple[float, str]:
    """The least time the card could take for `cost` -> (ms, "bytes" or
    "operations"): the larger of its bytes over the memory rate and its
    operations over their unit's peak (ALU and matrix work share the
    float32 pipes, so their times add; the special-function units run
    beside them).
    `loop_trips` closes the unknown loops: each entry's per-trip ops times
    the measured trips (per unit of its multiplier) times the multiplier."""
    alu = cost.alu + sum(per_trip * loop_trips * multiplier
                         for _, per_trip, multiplier in cost.unknown_loops)
    memory_ms = 1e3 * cost.bytes / HBM_BYTES_PER_S
    compute_ms = 1e3 * max(alu / ALU_OPS_PER_S + cost.mma / MMA_FLOPS_PER_S,
                           cost.sfu / SFU_OPS_PER_S)
    return (memory_ms, "bytes") if memory_ms >= compute_ms else (compute_ms, "operations")


# --------------------------------------------------------------------------- #
# The fixture: x * 2 + 1 over a grid of (32, 128) blocks

FIXTURE_BLOCK = (32, 128)
FIXTURE_BODY = Cost(alu=2 * 32 * 128, kernel_bytes=2 * 32 * 128 * 4)   # one block


def fixture_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fixture kernel: x * 2 + 1."""
    return x * 2.0 + 1.0


def _fixture_library() -> ctypes.CDLL:
    from shaderflow_tpu_torch.build import cuda_library
    library = cuda_library(Path(__file__).parent.parent / "csrc" / "fixture.cu")
    function = library.fixture_launch
    if function.argtypes is None:
        function.restype = ctypes.c_int
        function.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p]
    if library.empty_launch.argtypes is None:
        library.empty_launch.restype = ctypes.c_int
        library.empty_launch.argtypes = [ctypes.c_void_p]
    return library


def empty_launch(device="cuda") -> None:
    """One launch of an empty kernel (csrc/fixture.cu) on the device's
    current stream: the device time of a launch with no work, beside which
    the bounds of single tiny launches (T1, T3) are read. No work on the
    CPU, where nothing launches."""
    device = torch.device(device)
    if device.type == "cpu":
        return
    if device.type != "cuda":
        raise ValueError(f"Unsupported device {device}")
    library = _fixture_library()
    with torch.cuda.device(device):
        status = library.empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"empty launch failed: cudaError {status}")


def fixture(x: torch.Tensor) -> torch.Tensor:
    """T3's fixture: x * 2 + 1 on a contiguous float32 (32 k, 128) tensor,
    one block per (32, 128) block. The CUDA C++ kernel csrc/fixture.cu for
    CUDA tensors, fixture_plain for CPU tensors; declared to the walker as
    FIXTURE_BODY per block. `fixture.launches` counts kernel launches."""
    rows, cols = FIXTURE_BLOCK
    if (x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != cols
            or x.shape[0] % rows or not x.is_contiguous()):
        raise ValueError(f"The fixture takes a contiguous float32 (32 k, {cols}) tensor, "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    blocks = x.shape[0] // rows
    with kernel("T3 fixture", blocks, FIXTURE_BODY):
        if x.device.type == "cpu":
            return fixture_plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"Unsupported device {x.device}")
        out = torch.empty_like(x)
        library = _fixture_library()
        with torch.cuda.device(x.device):
            status = library.fixture_launch(x.data_ptr(), out.data_ptr(), blocks,
                                            torch.cuda.current_stream(x.device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"fixture launch failed: cudaError {status}")
        fixture.launches += 1
        return out


fixture.launches = 0


def main() -> int:
    """Run the fixture on the card and walk it: the walker's count must be
    the hand count (body x grid), the kernel equal to its plain version."""
    if not torch.cuda.is_available():
        raise SystemExit("flopcount: the fixture kernel runs on a CUDA card")
    x = torch.arange(128 * 128, dtype=torch.float32, device="cuda").reshape(128, 128) / 7.0
    with Walker() as walker:
        out = fixture(x)
    torch.cuda.synchronize()
    equal = torch.equal(out, fixture_plain(x))
    print(f"fixture equal to x * 2 + 1: {equal}; walker alu {walker.cost.alu:.0f} "
          f"(hand count {4 * 2 * 32 * 128}), bytes {walker.cost.kernel_bytes:.0f} "
          f"(hand count {2 * 128 * 128 * 4}), bound {roofline(walker.cost)}")
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
