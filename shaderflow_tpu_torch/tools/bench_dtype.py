"""
T2: does bfloat16 elementwise math beat float32 on this card?

Replaces tools/bench_vpu_dtype.py:make_kernel (pallas_call :60), which
decided whether the bf16 tail mode (SHADERFLOW_TAIL_BF16) pays on the
TPU. One CUDA C++ library (csrc/chain.cu) holds the chain in float32 and
in bfloat16, with the reference's op mix per round: c * b + a, a compare
with 1.0 as in float32, a select of c * 0.5, sqrt in float32 (the tail
keeps its transcendentals in float32), c + (1 - c) * 0.25. Sizes as the
reference: H = W = 1024, REPS = 40 rounds, N = 50 timed launches, 9 ops
per element per round for the Tops/s figure; unlike the reference, the two
dtypes are timed in TURNS alternating turns: timed once each, f32 first,
the speedup moved between two runs on one card model by more than the
verdict's margin (PERF.md); and the N launches are replayed from a CUDA
graph, since a launch (about 0.02 ms) is shorter than its Python call. One
thread holds one 16-byte vector (4 float32 or 8 bfloat16 elements: four
independent chains), THREADS a block.

The chain's inputs are the reference's, uniform in [0, 1) (in bfloat16
some round up to 1): for a and b in [0, 1] every c stays finite and below
2.1, so the square root's input |c| + 1e-3 lies in [2^-10, 4), the domain
on which the kernel's square root without sqrt.rn's guard is checked
exact. `chain` rejects inputs outside [0, 1]. K1's color chain has no such
bound and keeps the guard, so T2 times a square root K1 cannot use, in
both dtypes.

Why CUDA C++: the question is which instructions the card issues for the
chain's op mix: packed bf16x2 arithmetic, a square root without the slow
path's guard, and the conversions around them. CUDA C++ chooses them
explicitly, and tools/sass.py counts them in the built library's SASS
(`compiled`). K1, which is Triton, could reach the same instructions
through tl.inline_asm_elementwise(..., pack=2).

Bound on this card: operations. Per element and round, the ALU
instructions the exact chain needs: float32 8 (mul, add, compare, mul,
select, add, sub, and c + (1 - c) * 0.25 as one FMA, exact since the
product by 0.25 is; the abs is a free operand modifier of the add; casts
count 0), bfloat16 4.5 (the seven of them that act on a bf16 pair count
half, two elements a lane and clock; the float32 + 1e-3 one). Both run one
sqrt on the special-function units, whose time equals float32's ALU time
(8 ALU lanes to one SFU lane) and bounds both dtypes. The plain version is
the same chain in PyTorch (every bf16 op computed in float32 and rounded):
the kernel equals it bit for bit.

    python -m shaderflow_tpu_torch.tools.bench_dtype      # on a CUDA card
"""

from __future__ import annotations

import ctypes
import statistics
from pathlib import Path

import numpy as np
import torch

from shaderflow_tpu_torch.tools import flopcount

H, W = 1024, 1024
REPS = 40          # chained op rounds inside the kernel
N = 50             # timed launches
TURNS = 6          # timed runs of N launches per dtype, the dtypes in turns
DTYPES = (torch.float32, torch.bfloat16)
OPS_PER_ROUND = 9  # the reference's count, for Tops/s
VERDICT = 1.3      # the bf16 speedup the reference asks before shipping the mode
THREADS = 256      # threads a block (kThreads in csrc/chain.cu)
VECTOR_BYTES = 16  # what one thread loads of a and of b, and stores
# ALU ops per element and round: bf16 issues 7 of its 8 as bf16x2 pairs
ALU_PER_ROUND = {torch.float32: 8.0, torch.bfloat16: 7 * 0.5 + 1}
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "chain.cu"
KERNELS = {torch.float32: "chain_f32", torch.bfloat16: "chain_bf16"}
# The square root's domain: every float32 in [2^-10, 4), as bit patterns
SQRT_DOMAIN = (0x3A800000, 0x40800000)


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


def grid(dtype: torch.dtype, elements: int = H * W) -> tuple[int, int]:
    """The kernel's launch over `elements` of `dtype` -> (blocks, elements
    a thread). Thread t of block k owns the vector k * THREADS + t, its
    elements [(k * THREADS + t) * per, ... + per); threads past the last
    vector own none."""
    per = VECTOR_BYTES // dtype.itemsize
    return -(-elements // (THREADS * per)), per


def tile_cost(dtype: torch.dtype, reps: int = REPS) -> flopcount.Cost:
    """One block's cost for the walker: per element and round
    ALU_PER_ROUND[dtype] ALU ops and one sqrt; bytes of a and b read and c
    written."""
    elements = THREADS * grid(dtype)[1]
    return flopcount.Cost(alu=ALU_PER_ROUND[dtype] * reps * elements, sfu=reps * elements,
                          kernel_bytes=3 * dtype.itemsize * elements)


def bound(dtype: torch.dtype) -> tuple[float, str]:
    """One launch's bound at (H, W) -> (ms, "bytes" or "operations")."""
    return flopcount.roofline(tile_cost(dtype).scaled(grid(dtype)[0]))


def _chain_library() -> ctypes.CDLL:
    from shaderflow_tpu_torch.build import cuda_library
    library = cuda_library(SOURCE)
    if library.chain_launch.argtypes is None:
        library.chain_launch.restype = ctypes.c_int
        library.chain_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    if library.chain_sqrt_launch.argtypes is None:
        library.chain_sqrt_launch.restype = ctypes.c_int
        library.chain_sqrt_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return library


def chain(a: torch.Tensor, b: torch.Tensor, reps: int = REPS,
          check_domain: bool = True) -> torch.Tensor:
    """`reps` rounds of the chain on contiguous (H, W) tensors of one dtype
    (float32 or bfloat16) with values in [0, 1] -> c: the CUDA C++ kernel
    for CUDA tensors, the plain version for CPU tensors. The domain check
    reads the values back; check_domain=False skips it for inputs already
    checked (the timers: a CUDA graph's capture reads nothing back).
    `chain.launches` counts kernel launches: a call captured into a CUDA
    graph launches nothing, and `launch_ms` counts its graph's replays."""
    if (a.shape != (H, W) or b.shape != a.shape or a.dtype != b.dtype
            or a.dtype not in DTYPES
            or not (a.is_contiguous() and b.is_contiguous()) or a.device != b.device):
        raise ValueError(f"T2 takes two contiguous ({H}, {W}) float32 or bfloat16 tensors "
                         f"on one device, got {a.dtype} {tuple(a.shape)} on {a.device} and "
                         f"{b.dtype} {tuple(b.shape)} on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"Unsupported device {a.device}")
    if check_domain and not bool(((a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)).all()):
        raise ValueError("T2's inputs must lie in [0, 1]: outside it the kernel's square root "
                         "leaves its checked domain")
    blocks, per = grid(a.dtype)
    with flopcount.kernel("T2 chain", blocks, lambda: tile_cost(a.dtype, reps)):
        if a.device.type == "cpu":
            return chain_plain(a, b, reps)
        out = torch.empty_like(a)
        library = _chain_library()
        with torch.cuda.device(a.device):
            status = library.chain_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // per, blocks, reps,
                int(a.dtype == torch.bfloat16), torch.cuda.current_stream(a.device).cuda_stream)
            captured = torch.cuda.is_current_stream_capturing()
        if status != 0:
            raise RuntimeError(f"chain launch failed: cudaError {status}")
        if not captured:
            chain.launches += 1
        return out


chain.launches = 0


def sqrt_domain(device="cuda") -> torch.Tensor:
    """Every float32 in [2^-10, 4), ascending (about 1e8 values)."""
    return torch.arange(*SQRT_DOMAIN, dtype=torch.int32, device=device).view(torch.float32)


def chain_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The chain kernel's square root alone on a contiguous float32 CUDA
    tensor (torch.sqrt on a CPU tensor): its check against torch.sqrt."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"chain_sqrt takes a contiguous float32 tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return torch.sqrt(x)
    if x.device.type != "cuda":
        raise ValueError(f"Unsupported device {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _chain_library().chain_sqrt_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"chain sqrt launch failed: cudaError {status}")
    return out


def inputs(dtype: torch.dtype, device="cuda") -> tuple:
    """The reference's inputs: uniform [0, 1) from seed 0, a then b."""
    rng = np.random.default_rng(0)
    a = rng.random((H, W), np.float32)
    b = rng.random((H, W), np.float32)
    return tuple(torch.from_numpy(x).to(device=device, dtype=dtype) for x in (a, b))


def compiled() -> dict:
    """What nvcc made of each dtype's kernel (needs the CUDA toolkit; builds
    the library when missing) -> {"float32": figures, "bfloat16": figures}:
    ptxas's registers and spills, and from the SASS the hot loop's
    instructions, rounds a trip (its MUFU over a thread's elements), a
    thread's instructions a round and an element's, its packed bf16x2
    arithmetic a round, and its opcode counts."""
    from shaderflow_tpu_torch import build
    from shaderflow_tpu_torch.tools import sass
    _chain_library()
    listing = sass.dump(build.library_path(SOURCE))
    report = build.ptxas_report(SOURCE)
    figures = {}
    for dtype, name in KERNELS.items():
        per = grid(dtype)[1]
        loop = sass.step_figures(listing, name, work=("MUFU",), per_step=per)
        figures[str(dtype).replace("torch.", "")] = {
            **sass.ptxas_figures(report, name), "loop_instructions": loop["loop_instructions"],
            "rounds_a_trip": loop["loop_steps"],
            "instructions_per_round": loop["instructions_per_step"],
            "instructions_per_element_round": loop["instructions_per_step"] / per,
            "bf16x2_per_round": loop["bf16x2"] / loop["loop_steps"], "ops": loop["ops"]}
    return figures


def launch_ms(fn, count: int = N, counter=None) -> float:
    """Device time of one call by CUDA-graph replay (flopcount.replay_ms:
    `count` calls captured after a warm-up call, which builds). A replay has
    no host work between launches, so a kernel shorter than its Python
    wrapper's call (this one) is timed by the card, not by the host.
    `counter`, the wrapper fn launches once a call (its captured calls count
    none), gains the `count` launches of each of the two replays."""
    ms = flopcount.replay_ms(fn, count)
    if counter is not None:
        counter.launches += 2 * count
    return ms


def round_cost(dtype: torch.dtype) -> dict:
    """What one round costs on the card: the chain timed at REPS and at
    2 * REPS rounds (launch_ms), the difference over REPS -> the round's
    ms, and its issue slots an element (the round's time at the card's
    issue peak, flopcount.ALU_OPS_PER_S: 4 schedulers x 32 lanes x 132 SMs
    x 1.98 GHz), beside which `compiled`'s SASS instructions an element
    and round read as the share of the slots the kernel issues in."""
    a, b = inputs(dtype)
    ms = [launch_ms(lambda reps=reps: chain(a, b, reps, check_domain=False), counter=chain)
          for reps in (REPS, 2 * REPS)]
    round_ms = (ms[1] - ms[0]) / REPS
    return {"ms": ms[0], "round_ms": round_ms,
            "slots_per_element_round": round_ms * 1e-3 * flopcount.ALU_OPS_PER_S / (H * W)}


def bench() -> dict:
    """Check the kernel equal to the plain chain in each dtype, then time
    both dtypes in turns (f32, bf16, bf16, f32, ...: the card's clock and
    its host's load drift within a run, so neither dtype always goes
    first) -> {"float32": result, "bfloat16": result}, each kernel time the
    median of its dtype's TURNS, beside its bound and share."""
    results, turns = {}, {}
    for dtype in DTYPES:
        a, b = inputs(dtype)
        out, want = chain(a, b), chain_plain(a, b)
        torch.cuda.synchronize()
        turns[dtype] = (a, b, [])
        bound_ms, bound_by = bound(dtype)
        results[dtype] = dict(dtype=str(dtype).replace("torch.", ""),
                              plain_ms=launch_ms(lambda: chain_plain(a, b), 3),
                              equal=torch.equal(out, want),
                              max_abs_err=(out.float() - want.float()).abs().max().item(),
                              bound_ms=bound_ms, bound_by=bound_by)
    for turn in range(TURNS):
        for dtype in (DTYPES if turn % 2 == 0 else DTYPES[::-1]):
            a, b, times = turns[dtype]
            times.append(launch_ms(lambda: chain(a, b, check_domain=False), counter=chain))
    for dtype, result in results.items():
        result["ms"] = statistics.median(turns[dtype][2])
        result["share"] = result["bound_ms"] / result["ms"]
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
    figures = compiled()
    for dtype, result in results.items():
        code = figures[dtype]
        print(f"{dtype:10s} {result['ms']:8.4f} ms/launch  {result['tops']:6.2f} Tops/s  "
              f"bound {result['bound_ms']:.4f} ms ({result['bound_by']}), "
              f"{result['share']:.0%} of it  (plain {result['plain_ms']:.4f} ms, "
              f"equal {result['equal']})")
        print(f"{'':10s} {code['n_regs']} registers, {code['spill_stores']} bytes spilled; "
              f"SASS {code['instructions_per_round']:.1f} instructions a thread a round "
              f"({code['instructions_per_element_round']:.2f} an element), "
              f"{code['bf16x2_per_round']:.1f} bf16x2")
        cost = round_cost(getattr(torch, dtype))
        print(f"{'':10s} a round {cost['round_ms']:.6f} ms: "
              f"{cost['slots_per_element_round']:.2f} issue slots an element, "
              f"{code['instructions_per_element_round'] / cost['slots_per_element_round']:.0%} "
              f"of them issuing")
    print(verdict(results["float32"]["ms"], results["bfloat16"]["ms"]))
    return 0 if all(result["equal"] for result in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
