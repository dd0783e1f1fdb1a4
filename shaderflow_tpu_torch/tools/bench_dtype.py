"""
T2: does bfloat16 elementwise math beat float32 on this card?

Replaces tools/bench_vpu_dtype.py:make_kernel (pallas_call :60), which
decided whether the bf16 tail mode (SHADERFLOW_TAIL_BF16) pays on the
TPU. One @triton.jit chain, specialised on float32 and bfloat16 by its
pointers, with the reference's op mix per round: c * b + a, a compare in
float32, a select of c * 0.5, sqrt in float32 (the tail keeps its
transcendentals in float32), c + (1 - c) * 0.25. Sizes as the reference:
H = W = 1024, REPS = 40 rounds, N = 50 timed launches, 9 ops per element
per round for the Tops/s figure; unlike the reference, the two dtypes are
timed in TURNS alternating turns: timed once each, f32 first, the speedup
moved between two runs on one card model by more than the verdict's
margin (PERF.md). The reference's 256-row blocks are the
grid's row blocks, each cut into (8, 256) register tiles (512 programs over
the card's 132 SMs; a TPU block lived in VMEM, a Triton tile lives in
registers).

Why Triton: K1, the kernel the bf16 mode would speed up, is Triton; the
question is what its compiler makes of bf16 arithmetic on sm_90a.

Bound on this card: operations (10 ALU ops and one sqrt per element per
round against 12 or 6 bytes per element). The plain version is the same
chain in PyTorch (every bf16 op computed in float32 and rounded, as the
kernel's bf16 ops are): launched without FP fusion, the kernel equals it
bit for bit.

    python -m shaderflow_tpu_torch.tools.bench_dtype      # on a CUDA card
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from shaderflow_tpu_torch.tools import flopcount

H, W = 1024, 1024
TH, TW = 8, 256    # register tile of one program
REPS = 40          # chained op rounds inside the kernel
N = 50             # timed launches
TURNS = 6          # timed runs of N launches per dtype, the dtypes in turns
DTYPES = (torch.float32, torch.bfloat16)
OPS_PER_ROUND = 9  # the reference's count, for Tops/s
VERDICT = 1.3      # the bf16 speedup the reference asks before shipping the mode

_SOURCE = '''"""Generated by shaderflow_tpu_torch/tools/bench_dtype.py: T2's chain."""
import triton
import triton.language as tl


@triton.jit
def chain_kernel(a_ptr, b_ptr, out_ptr, W, REPS: tl.constexpr, TH: tl.constexpr,
                 TW: tl.constexpr):
    rows = tl.program_id(0) * TH + tl.arange(0, TH)[:, None]
    cols = tl.program_id(1) * TW + tl.arange(0, TW)[None, :]
    offsets = rows * W + cols
    a = tl.load(a_ptr + offsets)
    b = tl.load(b_ptr + offsets)
    c = a
    for _ in tl.static_range(REPS):
        c = c * b + a
        c = tl.where(c.to(tl.float32) > 1.0, c * 0.5, c)
        s = tl.sqrt_rn(tl.abs(c).to(tl.float32) + 1e-3)
        c = s.to(a.dtype)
        c = c + (1.0 - c) * 0.25
    tl.store(out_ptr + offsets, c)
'''


def chain_plain(a: torch.Tensor, b: torch.Tensor, reps: int = None) -> torch.Tensor:
    """Plain version of the chain, in a's dtype (float32 or bfloat16)."""
    c = a
    for _ in range(REPS if reps is None else reps):
        c = c * b + a
        c = torch.where(c.to(torch.float32) > 1.0, c * 0.5, c)
        s = torch.sqrt(torch.abs(c).to(torch.float32) + 1e-3)
        c = s.to(a.dtype)
        c = c + (1.0 - c) * 0.25
    return c


def tile_cost(dtype: torch.dtype) -> flopcount.Cost:
    """One (TH, TW) tile's cost for the walker: per element and round 10
    ALU ops (mul, add, compare, mul, select, abs, add, sub, mul, add; the
    casts count 0) and one sqrt; bytes of a and b read and c written."""
    elements = TH * TW
    size = torch.empty((), dtype=dtype).element_size()
    return flopcount.Cost(alu=10 * REPS * elements, sfu=REPS * elements,
                          kernel_bytes=3 * size * elements)


def chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The chain on contiguous (H, W) CUDA tensors of one dtype (float32
    or bfloat16) -> c; the plain version for CPU tensors.
    `chain.launches` counts kernel launches."""
    if (a.shape != (H, W) or b.shape != a.shape or a.dtype != b.dtype
            or a.dtype not in (torch.float32, torch.bfloat16)
            or not (a.is_contiguous() and b.is_contiguous()) or a.device != b.device):
        raise ValueError(f"T2 takes two contiguous ({H}, {W}) float32 or bfloat16 tensors "
                         f"on one device, got {a.dtype} {tuple(a.shape)} and {b.dtype} "
                         f"{tuple(b.shape)}")
    grid = (H // TH, W // TW)
    with flopcount.kernel("T2 chain", grid[0] * grid[1], lambda: tile_cost(a.dtype)):
        if a.device.type == "cpu":
            return chain_plain(a, b)
        from shaderflow_tpu_torch.build import triton_module
        out = torch.empty_like(a)
        chain_kernel = triton_module(_SOURCE, stem="bench_dtype").chain_kernel
        with torch.cuda.device(a.device):
            chain_kernel[grid](a, b, out, W, REPS=REPS, TH=TH, TW=TW, enable_fp_fusion=False)
        chain.launches += 1
        return out


chain.launches = 0


def inputs(dtype: torch.dtype, device="cuda") -> tuple:
    """The reference's inputs: uniform [0, 1) from seed 0, a then b."""
    rng = np.random.default_rng(0)
    a = rng.random((H, W), np.float32)
    b = rng.random((H, W), np.float32)
    return tuple(torch.from_numpy(x).to(device=device, dtype=dtype) for x in (a, b))


def launch_ms(fn, count: int = N) -> float:
    """CUDA-event time of `count` back-to-back calls / count, after one
    warm-up call (which compiles)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def bench() -> dict:
    """Check the kernel equal to the plain chain in each dtype, then time
    both dtypes in turns (f32, bf16, bf16, f32, ...: the card's clock and
    its host's load drift within a run, so neither dtype always goes
    first) -> {"float32": result, "bfloat16": result}, each kernel time the
    median of its dtype's TURNS."""
    results, turns = {}, {}
    for dtype in DTYPES:
        a, b = inputs(dtype)
        out, want = chain(a, b), chain_plain(a, b)
        torch.cuda.synchronize()
        turns[dtype] = (a, b, [])
        results[dtype] = dict(dtype=str(dtype).replace("torch.", ""),
                              plain_ms=launch_ms(lambda: chain_plain(a, b), 3),
                              equal=torch.equal(out, want),
                              max_abs_err=(out.float() - want.float()).abs().max().item())
    for turn in range(TURNS):
        for dtype in (DTYPES if turn % 2 == 0 else DTYPES[::-1]):
            a, b, times = turns[dtype]
            times.append(launch_ms(lambda: chain(a, b)))
    for dtype, result in results.items():
        result["ms"] = statistics.median(turns[dtype][2])
        result["tops"] = H * W * REPS * OPS_PER_ROUND / (result["ms"] * 1e-3) / 1e12
    return {result["dtype"]: result for result in results.values()}


def verdict(f32_ms: float, bf16_ms: float) -> str:
    speedup = f32_ms / bf16_ms
    return (f"bf16 speedup over f32: {speedup:.2f}x ("
            f"{'worth shipping the bf16 tail mode' if speedup > VERDICT else 'NOT worth it'})")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_dtype: times the chain on a CUDA card; no card here")
    print(f"device: {torch.cuda.get_device_name(0)}  {H}x{W}, {REPS} rounds, {N} launches")
    results = bench()
    for result in results.values():
        print(f"{result['dtype']:10s} {result['ms']:8.4f} ms/launch  {result['tops']:6.2f} "
              f"Tops/s  (plain {result['plain_ms']:.4f} ms, equal {result['equal']})")
    print(verdict(results["float32"]["ms"], results["bfloat16"]["ms"]))
    return 0 if all(result["equal"] for result in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
