"""
T1: which bfloat16 elementwise ops does K1's compiler lower natively on
this card, and do they round as the plain version does?

Replaces tools/probe_bf16_ops.py:probe (one bf16 Pallas kernel per op,
pallas_call :53), which decided what the TPU target lowered in bf16. Same
OPS list, same inputs (1.25 and 0.75 filling (256, 256) bf16 arrays), plus
a seeded random bf16 sweep. For each op it compiles one bf16 @triton.jit
kernel, launches it once over both input sets stacked as (2, 256, 256),
its programs spread over every SM of the card (block_size), and holds its
result against the plain version: every op computed in float32 and
rounded to bfloat16, with Python constants rounded to bfloat16 first
(JAX's weak types; Triton casts a Python number to the tensor's type the
same way). Each op reports `ok` (bit-equal on both input sets), `differs
(max N ulp)` or `FAIL (<first line of the error>)`.

Why Triton: the question is what K1's own compiler (ops/tailgen.py emits
Triton) lowers natively in bf16 on sm_90a, and with what rounding; only a
probe through the same compiler, with K1's launch options
(enable_fp_fusion=False), answers it. ops/tailgen.py keeps the ops found
bit-equal as BF16_PROBE_OK.

Bound on this card: bytes (two (2, 256, 256) bf16 inputs read, one
written): the probe checks compilation and rounding; its time is launch
overhead (an empty kernel's launch takes longer than the bound).

    python -m shaderflow_tpu_torch.tools.probe_bf16_ops      # on a CUDA card
"""

from __future__ import annotations

import numpy as np
import torch

from shaderflow_tpu_torch.tools import flopcount

SHAPE = (256, 256)
MAX_BLOCK = 1024  # elements per program at most


def _c(value: float) -> torch.Tensor:
    """A Python constant as JAX types it beside a bf16 array: rounded to
    bfloat16 (a 0-d bf16 tensor keeps torch's result bf16 too)."""
    return torch.tensor(value, dtype=torch.bfloat16)


# op -> (Triton expression over the bf16 blocks a and b, plain version on
# bf16 tensors). The reference's list and order (tools/probe_bf16_ops.py:23-42).
OPS = {
    "mul": ("{a} * {b}", lambda a, b: a * b),
    "add": ("{a} + {b}", lambda a, b: a + b),
    "max": ("tl.maximum({a}, {b})", torch.maximum),
    "where": ("tl.where({a} > {b}, {a}, {b})", lambda a, b: torch.where(a > b, a, b)),
    # the tail's pattern: compare f32 geometry, select bf16 color
    "select_f32cmp": ("tl.where({a}.to(tl.float32) > 1.0, {a}, {b})",
                      lambda a, b: torch.where(a.to(torch.float32) > 1.0, a, b)),
    "div_array": ("{a} / {b}", lambda a, b: a / b),
    "div_const": ("{a} / 1000.0", lambda a, b: a / _c(1000.0).to(a.device)),
    "recip": ("1.0 / {a}", lambda a, b: _c(1.0).to(a.device) / a),
    "sqrt": ("tl.sqrt({a})", lambda a, b: torch.sqrt(a)),
    "rsqrt": ("tl.rsqrt({a})", lambda a, b: torch.rsqrt(a)),
    "exp": ("tl.exp({a})", lambda a, b: torch.exp(a)),
    "log": ("tl.log(tl.abs({a}) + 1e-3)",
            lambda a, b: torch.log(torch.abs(a) + _c(1e-3).to(a.device))),
    "tanh": ("libdevice.tanh({a})", lambda a, b: torch.tanh(a)),
    "sin": ("tl.sin({a})", lambda a, b: torch.sin(a)),
    "pow_via_exp_log": ("tl.exp({b} * tl.log(tl.abs({a}) + 1e-3))",
                        lambda a, b: torch.exp(b * torch.log(torch.abs(a)
                                                             + _c(1e-3).to(a.device)))),
}

_SOURCE = '''"""Generated by shaderflow_tpu_torch/tools/probe_bf16_ops.py: T1's kernel for {name}."""
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def probe_kernel(a_ptr, b_ptr, out_ptr, BLOCK: tl.constexpr):
    offsets = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    a = tl.load(a_ptr + offsets)
    b = tl.load(b_ptr + offsets)
    tl.store(out_ptr + offsets, ({expression}).to(tl.bfloat16))
'''


def inputs(device) -> list[tuple]:
    """The reference's constant inputs, then the seeded random sweep: a in
    [-4, 4) (negative values reach sqrt and log's abs), b in [0.25, 4)."""
    rng = np.random.default_rng(0)
    sweep_a = rng.uniform(-4.0, 4.0, SHAPE).astype(np.float32)
    sweep_b = rng.uniform(0.25, 4.0, SHAPE).astype(np.float32)
    bf16 = lambda x: torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)
    return [(torch.full(SHAPE, 1.25, dtype=torch.bfloat16, device=device),
             torch.full(SHAPE, 0.75, dtype=torch.bfloat16, device=device)),
            (bf16(sweep_a), bf16(sweep_b))]


def stacked_inputs(device) -> tuple:
    """Both input sets of `inputs` stacked: a and b of shape (2, 256, 256),
    set k at index k."""
    sets = inputs(device)
    return tuple(torch.stack([pair[i] for pair in sets]) for i in range(2))


def block_size(elements: int, sms: int) -> int:
    """Elements per program: the largest power of two up to MAX_BLOCK that
    still gives every SM a program (at least 1; 512 for the stacked sets
    on 132 SMs: 256 programs)."""
    block = MAX_BLOCK
    while block > 1 and elements // block < sms:
        block //= 2
    return block


def ulp_distance(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in bf16 ulps (NaN equals NaN; a NaN against a
    number counts as 2**16 ulps)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    distance = (ordered(got) - ordered(want)).abs()
    both_nan = torch.isnan(got) & torch.isnan(want)
    one_nan = torch.isnan(got) ^ torch.isnan(want)
    distance = torch.where(both_nan, 0, torch.where(one_nan, 1 << 16, distance))
    return int(distance.max().item())


def compile_op(name: str):
    """The compiled Triton kernel of one op (raises when it does not lower)."""
    from shaderflow_tpu_torch.build import triton_module
    expression = OPS[name][0].format(a="a", b="b")
    return triton_module(_SOURCE.format(name=name, expression=expression),
                         stem=f"probe_{name}").probe_kernel


def run_op(probe_kernel, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of a probe kernel on contiguous bf16 CUDA tensors of one
    shape (the stacked sets), its grid over every SM of the card (block_size),
    declared to the cost walker as one op per element and the bytes of a,
    b and the result (a composite op's extra ops are not counted: a floor)."""
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    block = block_size(a.numel(), sms)
    if a.shape != b.shape or a.numel() % block:
        raise ValueError(f"T1 takes two bf16 tensors of one shape, a multiple of {block} "
                         f"elements, got {tuple(a.shape)} and {tuple(b.shape)}")
    blocks = a.numel() // block
    body = flopcount.Cost(alu=block, kernel_bytes=3 * 2 * block)
    out = torch.empty_like(a)
    with flopcount.kernel("T1 probe", blocks, body), torch.cuda.device(a.device):
        probe_kernel[(blocks,)](a, b, out, BLOCK=block, enable_fp_fusion=False)
    run_op.launches += 1
    return out


run_op.launches = 0


def entry(got: torch.Tensor, want: torch.Tensor) -> str:
    """An op's table entry from its kernel's result and the plain one."""
    worst = ulp_distance(got, want)
    return "ok" if worst == 0 else f"differs (max {worst} ulp)"


def probe(name: str, device="cuda") -> str:
    """Compile one op and run it once over both input sets stacked -> its
    table entry."""
    a, b = stacked_inputs(device)
    try:
        got = run_op(compile_op(name), a, b)
        torch.cuda.synchronize(device)
    except Exception as error:   # compile failures arrive as several exception types
        # Triton's CompilationError opens with the source position; the
        # lowering's own message is its cause
        cause = error.__cause__ or error
        lines = str(cause).strip().splitlines() or [type(cause).__name__]
        return f"FAIL ({lines[0][:100]})"
    return entry(got, OPS[name][1](a, b))


def probe_all(device="cuda") -> dict[str, str]:
    return {name: probe(name, device) for name in OPS}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_bf16_ops: probes the CUDA card's compiler; no card here")
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, result in probe_all().items():
        print(f"{name:18s} {result}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
