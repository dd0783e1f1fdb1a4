"""The port's measurement tools (shaderflow_tpu_torch/tools/) on the CPU,
against the JAX package's tools they replace:

  * T3, the cost walker (tools/flopcount.py): the hand-count pins of
    tests/test_flopcount.py, each mirrored, plus the fixture kernel (its
    plain version here) counted as body x grid and equal to the Pallas
    fixture in interpret mode;
  * T1, the bf16 op probe (tools/probe_bf16_ops.py): the port's plain ops
    against the reference's OPS on the same bf16 inputs;
  * T2, the f32-vs-bf16 chain (tools/bench_vpu_dtype.py): the port's plain
    chain against make_kernel in interpret mode at a reduced size, and the
    walker's count of the packed kernel (tests/test_torch_chain.py holds
    what its bf16x2 form relies on);
  * the port's reader of ptxas reports and SASS (tools/sass.py), on
    recorded text.

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu_torch.ops import fractal, tailfuse
from shaderflow_tpu_torch.tools import bench_dtype, flopcount, probe_bf16_ops

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _reference_tool(name: str):
    """A module of the JAX package's tools/ directory."""
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(TOOLS))


# --------------------------------------------------------------------------- #
# T3: the walker's hand-count pins (tests/test_flopcount.py, one by one)

def test_elementwise_and_sfu():
    cost = flopcount.count_fn(lambda x: torch.exp(x * 2.0 + 1.0), torch.zeros((8, 16)))
    assert cost.alu == 2 * 128          # mul + add
    assert cost.sfu == 128              # exp
    assert cost.mma == 0


def test_matmul():
    cost = flopcount.count_fn(lambda a, b: a @ b, torch.zeros((32, 64)), torch.zeros((64, 16)))
    assert cost.mma == 2 * 32 * 16 * 64


def test_loop_multiplies_body():
    """A Python loop runs its body each trip: the counterpart of the scan
    rule (the body counted times its length, not once)."""
    def f(x):
        for _ in range(10):
            x = x * 2.0 + 1.0
        return x

    cost = flopcount.count_fn(f, torch.zeros(128))
    assert cost.alu == 10 * 2 * 128


def test_kernel_loop_reported_per_trip():
    """A kernel's data-dependent loop (K3's escape loop) is reported per
    trip with its multiplier, as tools/flopcount.py reports a while loop;
    roofline closes it with a measured mean trip count."""
    cx = torch.linspace(-2.0, 0.5, 16)
    cy = torch.linspace(-1.0, 1.0, 8)
    with flopcount.Walker() as walker:
        with flopcount.kernel("K3 lines", 128, fractal._escape_cost(128, 4 * (16 + 8))):
            counts = fractal.escape_lines_plain(cx, cy, 20)
    assert walker.kernels == {"K3 lines": 1}
    assert walker.cost.alu == 0                      # the plain version's ops are skipped
    assert walker.cost.unknown_loops == [("K3 escape step", fractal.ESCAPE_STEP_OPS, 128.0)]
    assert walker.cost.kernel_bytes == 128 * 4 + 4 * (16 + 8)
    steps = int(counts.sum())
    compute_ms = 1e3 * fractal.ESCAPE_STEP_OPS * steps / flopcount.ALU_OPS_PER_S
    memory_ms = 1e3 * walker.cost.kernel_bytes / flopcount.HBM_BYTES_PER_S
    assert flopcount.roofline(walker.cost, steps / 128)[0] == pytest.approx(
        max(compute_ms, memory_ms))
    assert flopcount.roofline(walker.cost, 100 * steps / 128) == (
        pytest.approx(100 * compute_ms), "operations")


def test_kernel_body_times_grid():
    """A declared kernel: its block's cost times its blocks."""
    body = flopcount.Cost(alu=2 * 32 * 128, sfu=32 * 128, kernel_bytes=2 * 32 * 128 * 4)
    with flopcount.Walker() as walker:
        with flopcount.kernel("declared", 4, body):
            torch.zeros((128, 128)) * 2.0        # not counted: inside the kernel
    assert walker.cost.alu == 4 * 2 * 32 * 128
    assert walker.cost.sfu == 4 * 32 * 128
    assert walker.cost.kernel_bytes == 2 * 128 * 128 * 4


def test_alu_bound_at_the_instruction_rate():
    """ALU operations are bounded at one float32 instruction per lane and
    clock (128 lanes x 132 SMs x 1.98 GHz), half the data sheet's
    67 TFLOP/s, which counts an FMA as two and which the port's kernels
    never issue; matrix FLOPs stay at 67e12, and the two times add. One
    corrected bound: 386 ALU ops a pixel over a 3840x2160 frame take
    0.0957 ms, not 0.0479."""
    assert flopcount.ALU_OPS_PER_S == 128 * 132 * 1.98e9
    assert flopcount.MMA_FLOPS_PER_S == 67e12
    assert flopcount.ALU_OPS_PER_S == pytest.approx(flopcount.MMA_FLOPS_PER_S / 2, rel=0.01)
    frame = flopcount.Cost(alu=386 * 3840 * 2160, kernel_bytes=1.0)
    assert flopcount.roofline(frame) == (pytest.approx(0.0957, abs=5e-5), "operations")
    both = flopcount.Cost(alu=1e9, mma=2e9)
    assert flopcount.roofline(both)[0] == pytest.approx(
        1e3 * (1e9 / flopcount.ALU_OPS_PER_S + 2e9 / flopcount.MMA_FLOPS_PER_S))


def test_io_bytes_floor():
    cost = flopcount.count_fn(lambda x: x + 1.0, torch.zeros((64, 64), dtype=torch.float32))
    assert cost.io_bytes == 2 * 64 * 64 * 4


def test_fixture_counted_as_body_times_grid():
    """T3's fixture, x * 2 + 1 over a grid of 4 (32, 128) blocks, counted
    as tests/test_flopcount.py:64-80 counts the Pallas fixture, and equal
    to that kernel in interpret mode."""
    from jax.experimental import pallas as pl

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    x = np.random.default_rng(0).standard_normal((128, 128)).astype(np.float32)
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32), grid=(4,),
        in_specs=[pl.BlockSpec((32, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((32, 128), lambda i: (i, 0)), interpret=True)(jnp.asarray(x))
    with flopcount.Walker() as walker:
        got = flopcount.fixture(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert walker.kernels == {"T3 fixture": 1}
    assert walker.cost.alu == 4 * 2 * 32 * 128           # per-block body x grid
    assert walker.cost.kernel_bytes == 2 * 128 * 128 * 4  # in + out, full arrays
    assert flopcount.roofline(walker.cost)[1] == "bytes"


@pytest.mark.parametrize("sms", [1, 132])
def test_fixture_geometry_covers_every_float4_once(sms):
    """The fixture's launch geometry touches every float4 of the tensor
    exactly once, for 1 to 300 logical (32, 128) blocks: thread t of CTA c
    takes float4 c * threads + t where that is below the count, so a grid
    covers it once when its last CTA starts inside the tensor and ends at
    or past its end; CTAs of 32 to 128 threads (smaller while that spreads
    the tensor over more SMs)."""
    for blocks in range(1, 301):
        vectors = blocks * 32 * 128 // 4
        ctas, threads = flopcount.fixture_geometry(vectors, sms)
        assert 32 <= threads <= 128, (blocks, threads)
        assert ctas * threads >= vectors > (ctas - 1) * threads, (blocks, ctas, threads)
    if sms == 132:
        # 128x128 spreads over 128 SMs in one-warp CTAs; the 64 MiB stream
        # is 32,768 CTAs of 128 threads
        assert flopcount.fixture_geometry(128 * 128 // 4, sms) == (128, 32)
        assert flopcount.fixture_geometry(32 * 4096 * 128 // 4, sms) == (32768, 128)
    else:
        assert flopcount.fixture_geometry(1024, sms) == (8, 128)


def test_fixture_rejects_other_shapes():
    with pytest.raises(ValueError, match="32 k, 128"):
        flopcount.fixture(torch.zeros((100, 128)))


def test_walker_counts_reductions_and_layout():
    """Reductions count one op per input element; views, copies and dtype
    conversions count 0; a convolution counts 2 * outputs * its taps."""
    def f(x):
        y = x.t().reshape(-1).to(torch.float64)
        return y.sum() + x.amax()

    cost = flopcount.count_fn(f, torch.zeros((16, 8)))
    assert cost.alu == 128 + 128 + 1
    image = torch.zeros((1, 3, 10, 12))
    weight = torch.zeros((3, 1, 5, 5))
    conv = flopcount.count_fn(
        lambda i, w: torch.nn.functional.conv2d(i, w, padding=2, groups=3), image, weight)
    assert conv.mma == 2 * (3 * 10 * 12) * 25


def test_k1_declares_graph_ops_and_bytes():
    """K1's declared cost (tailgen.kernel_cost): graph ops by class per
    SSAA pixel; per output channel the 2x2 pool's three adds, the average
    and the quantize's max, min, scale, offset and floor; each input read
    once and the u8 frame written once."""
    from shaderflow_tpu_torch.ops import tailgen

    def tail(tp):
        x = tp.plane("x")
        return torch.sqrt(x) * 2.0, torch.exp(x), x + 1.0

    spec = tailfuse.make_spec(tail, 8, 16, x=torch.ones((8, 16)))
    graph, outputs = tailgen.trace(spec, 8, 16, 2.0)
    counts = graph.op_counts(outputs)
    assert counts == {(1, 1): (2, 2), (0, 1): (0, 0), (1, 0): (0, 0), (0, 0): (0, 0)}
    cost = tailgen.kernel_cost(counts, [spec.planes["x"][0]], (4, 8, 3), torch.uint8, 2, True)
    assert cost.alu == 128 * 2 + 32 * 3 * (3 + 1 + 5)
    assert cost.sfu == 128 * 2
    assert cost.kernel_bytes == 128 * 4 + 32 * 3


def test_k1_counts_ops_once_at_their_rank():
    """K1's op counts are what the tail needs: a node counts once a render
    pixel, column or row, or once, by its rank (a 0-d scalar's product
    once, a column's once a render column); a subexpression the tail
    writes twice counts once (the compiler merges it); a value no output
    reads counts 0. kernel_cost scales each rank by its extent: over an
    8x16 render, 128 pixels, 16 columns, 8 rows."""
    from shaderflow_tpu_torch.ops import tailgen

    def tail(tp):
        x, c, r, v = tp.plane("x"), tp.col("c"), tp.row("r"), tp.scalar("v")
        gain = v * 2.0
        wave = c * 4.0 - 0.25
        again = c * 4.0 - 0.25
        unused = torch.exp(x) + 1.0      # noqa: F841: read by no output
        return x * gain + wave, x * again, torch.sqrt(r + 1.0) * x

    spec = tailfuse.make_spec(tail, 8, 16, x=torch.ones((8, 16)), c=tailfuse.Col(torch.ones(16)),
                              r=tailfuse.Row(torch.ones(8)), v=torch.tensor(0.5))
    graph, outputs = tailgen.trace(spec, 8, 16, 2.0)
    counts = graph.op_counts(outputs)
    assert counts == {(1, 1): (4, 0), (0, 1): (2, 0), (1, 0): (1, 1), (0, 0): (1, 0)}
    inputs = [spec.planes["x"][0], spec.cols["c"], spec.rows["r"]]
    cost = tailgen.kernel_cost(counts, inputs, (4, 8, 3), torch.uint8, 2, True)
    assert cost.alu == 128 * 4 + 16 * 2 + 8 * 1 + 1 + 32 * 3 * (3 + 1 + 5)
    assert cost.sfu == 8
    assert cost.kernel_bytes == (128 + 16 + 8) * 4 + 32 * 3
    planes = tailgen.kernel_cost(counts, inputs, (3, 8, 16), torch.bfloat16, 1, False)
    assert planes.alu == 128 * 4 + 16 * 2 + 8 * 1 + 1 and planes.sfu == 8


# --------------------------------------------------------------------------- #
# What the compiler made of a CUDA kernel (tools/sass.py), on recorded text

SASS = """
        Function : _Z13escape_kernelI6ApartCfEvT_PT0_iiiif
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
                                                                    /* 0x000fe20000000800 */
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0020*/              @!P0 IADD3 R7, R7, 0x1, RZ ;
        /*0030*/                   FADD R4, R2, R2 ;
        /*0040*/                   FMUL R4, R4, R3 ;
        /*0050*/                   FADD R3, R4, R9 ;
        /*0060*/                   FADD R2, R5, -R6 ;
        /*0070*/                   FADD R2, R2, R8 ;
        /*0080*/                   FMUL R5, R2, R2 ;
        /*0090*/                   FMUL R6, R3, R3 ;
        /*00a0*/                   FADD R10, R5, R6 ;
        /*00b0*/                   FSETP.GT.OR P0, PT, R10, R11, P0 ;
        /*00c0*/              @!P0 IADD3 R7, R7, 0x1, RZ ;
        /*00d0*/                   FADD R4, R2, R2 ;
        /*00e0*/                   FMUL R4, R4, R3 ;
        /*00f0*/                   FADD R3, R4, R9 ;
        /*0100*/                   FADD R2, R5, -R6 ;
        /*0110*/                   FADD R2, R2, R8 ;
        /*0120*/                   FMUL R5, R2, R2 ;
        /*0130*/                   FMUL R6, R3, R3 ;
        /*0140*/                   FADD R10, R5, R6 ;
        /*0150*/                   FSETP.GT.OR P0, PT, R10, R11, P0 ;
        /*0160*/                   IADD3 R12, R12, -0x2, RZ ;
        /*0170*/                   ISETP.GT.AND P1, PT, R12, 0x1, !P0 ;
        /*0180*/               @P1 BRA 0x20 ;
        /*0190*/                   FADD R4, R2, R2 ;
        /*01a0*/                   FMUL R4, R4, R3 ;
        /*01b0*/                   FADD R3, R4, R9 ;
        /*01c0*/                   FADD R2, R5, -R6 ;
        /*01d0*/                   FADD R2, R2, R8 ;
        /*01e0*/                   FMUL R5, R2, R2 ;
        /*01f0*/                   FMUL R6, R3, R3 ;
        /*0200*/                   FADD R10, R5, R6 ;
        /*0210*/                   FSETP.GT.AND P0, PT, R10, R11, PT ;
        /*0220*/               @P2 BRA 0x190 ;
        /*0230*/                   STG.E desc[UR4][R2.64], R7 ;
        /*0240*/                   FADD R13, R1, R1 ;
        /*0250*/              @!P3 BRA 0x230 ;
        /*0260*/                   EXIT ;
        /*0270*/                   BRA 0x270;
        ..........

        Function : _Z13escape_kernelI6ApartCiEvT_PT0_iiiif
        /*0000*/                   EXIT ;
"""

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13escape_kernelI6ApartCiEvT_PT0_iiiif' for 'sm_90a'
ptxas info    : Function properties for _Z13escape_kernelI6ApartCiEvT_PT0_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13escape_kernelI6ApartCfEvT_PT0_iiiif' for 'sm_90a'
ptxas info    : Function properties for _Z13escape_kernelI6ApartCfEvT_PT0_iiiif
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 21 registers, 424 bytes cmem[0]
"""


def test_sass_hot_loop_instructions_per_step():
    """The hot loop is the innermost backward branch that touches no memory
    and holds the most float products and sums: the two-step body (23
    instructions, 16 FADD/FMUL: 2 escape steps, 11.5 a step), not the
    one-step remainder loop (9 instructions) nor the loop around a store;
    the function is the one whose mangled name holds every part."""
    from shaderflow_tpu_torch.tools import sass
    figures = sass.step_figures(SASS, "escape_kernel", "6ApartCfE")
    assert figures["function"] == "_Z13escape_kernelI6ApartCfEvT_PT0_iiiif"
    assert (figures["loop_instructions"], figures["loop_steps"]) == (23, 2.0)
    assert figures["instructions_per_step"] == 11.5
    assert figures["ops"]["FSETP"] == 2 and figures["ops"]["BRA"] == 1
    with pytest.raises(ValueError, match="2 functions match"):
        sass.step_figures(SASS, "escape_kernel")
    with pytest.raises(ValueError, match="no memory-free innermost loop"):
        sass.step_figures(SASS, "6ApartCiE")


CHAIN_SASS = """
        Function : _ZN12_GLOBAL__N_110chain_bf16EPKNS_5PairsES2_PS0_xi
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/                   HMUL2.BF16_V2 R8, R8, R5 ;
        /*0020*/                   HADD2.BF16_V2 R8, R8, R4 ;
        /*0030*/                   HSET2.BF16_V2.GT.AND R9, R8, 1, 1, PT ;
        /*0040*/                   HFMA2.BF16_V2 R9, R9, -0.5, -0.5, 1, 1 ;
        /*0050*/                   HMUL2.BF16_V2 R8, R8, R9 ;
        /*0060*/                   IMAD.U32 R10, R8, 0x10000, RZ ;
        /*0070*/                   LOP3.LUT R11, R8, 0xffff0000, RZ, 0xc0, !PT ;
        /*0080*/                   FADD R10, |R10|, 0.0010000000474974513054 ;
        /*0090*/                   FADD R11, |R11|, 0.0010000000474974513054 ;
        /*00a0*/                   MUFU.RSQ R12, R10 ;
        /*00b0*/                   MUFU.RSQ R13, R11 ;
        /*00c0*/                   FMUL R14, R10, R12 ;
        /*00d0*/                   FMUL R15, R11, R13 ;
        /*00e0*/                   F2FP.BF16.F32.PACK_AB R8, R15, R14 ;
        /*00f0*/              @!P0 HFMA2.MMA.BF16_V2 R8, R8, 1, 1, R4 ;
        /*0100*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0110*/                   ISETP.NE.AND P1, PT, R0, R7, PT ;
        /*0120*/               @P1 BRA 0x10 ;
        /*0130*/                   STG.E.128 desc[UR4][R2.64], R8 ;
        /*0140*/                   EXIT ;
"""


def test_sass_chain_loop_rounds_and_bf16x2():
    """T2's hot loop is picked by its MUFU (one square root an element and
    round) and its rounds are MUFU over the elements a thread holds; the
    packed bf16 arithmetic (HADD2, HMUL2, HFMA2 with a BF16 modifier,
    predicated or not) is counted, the compare (HSET2) and the pack (F2FP)
    are not."""
    from shaderflow_tpu_torch.tools import sass
    figures = sass.step_figures(CHAIN_SASS, "chain_bf16", work=("MUFU",), per_step=2)
    assert (figures["loop_instructions"], figures["loop_steps"]) == (18, 1.0)
    assert figures["instructions_per_step"] == 18 and figures["bf16x2"] == 5
    assert figures["ops"]["MUFU"] == 2 and figures["ops"]["HSET2"] == 1
    assert sass.bf16x2("@!P0 HFMA2.MMA.BF16_V2 R8, R8, 1, 1, R4")
    assert not sass.bf16x2("HFMA2 R8, R8, R9, R4") and not sass.bf16x2("F2FP.BF16.F32.PACK_AB R8, R1, R2")
    with pytest.raises(ValueError, match="no memory-free innermost loop with MUFU"):
        sass.step_figures(SASS, "escape_kernel", "6ApartCfE", work=("MUFU",))


def test_ptxas_registers_and_spills():
    from shaderflow_tpu_torch.tools import sass
    assert sass.ptxas_figures(PTXAS, "escape_kernel", "6ApartCfE") == {
        "function": "_Z13escape_kernelI6ApartCfEvT_PT0_iiiif", "n_regs": 21,
        "spill_stores": 4, "spill_loads": 8}
    assert sass.ptxas_figures(PTXAS, "6ApartCiE")["n_regs"] == 18
    with pytest.raises(ValueError, match="0 functions match"):
        sass.ptxas_figures(PTXAS, "6LinesC")


# --------------------------------------------------------------------------- #
# T1: the plain ops against the reference's OPS

@pytest.mark.parametrize("name", list(probe_bf16_ops.OPS))
def test_probe_plain_ops_match_reference(name):
    """Each op's plain version (every op in float32, rounded to bfloat16,
    constants rounded to bfloat16 first) against the reference's OPS[name]
    under jit on the same bf16 inputs (its constant inputs and the seeded
    sweep): bit-equal, NaNs where the reference has them. Measured: 0 ulp
    for all 15 ops on both input sets."""
    reference = _reference_tool("probe_bf16_ops")
    assert list(reference.OPS) == list(probe_bf16_ops.OPS)
    for a, b in probe_bf16_ops.inputs("cpu"):
        want = jax.jit(reference.OPS[name])(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                            jnp.asarray(b.float().numpy(), jnp.bfloat16))
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16)
        got = probe_bf16_ops.OPS[name][1](a, b)
        assert got.dtype == torch.bfloat16
        assert probe_bf16_ops.ulp_distance(got, want) == 0, name


@pytest.mark.parametrize("name", list(probe_bf16_ops.OPS))
def test_probe_stacked_sets_give_the_table_entry_of_the_sets_apart(name):
    """One launch over both input sets stacked (2, 256, 256) gives each op
    the table entry the two sets gave probed apart: the plain side on the
    stack is the stack of the plain sides, and the entry of a result that
    matches, or differs on one set, is the worse of the two sets'."""
    sets = probe_bf16_ops.inputs("cpu")
    a, b = probe_bf16_ops.stacked_inputs("cpu")
    assert a.shape == b.shape == (2, *probe_bf16_ops.SHAPE)
    for k, (set_a, set_b) in enumerate(sets):
        assert torch.equal(a[k], set_a) and torch.equal(b[k], set_b)
    plain = probe_bf16_ops.OPS[name][1]
    want = plain(a, b)
    apart = [plain(set_a, set_b) for set_a, set_b in sets]
    assert probe_bf16_ops.ulp_distance(want, torch.stack(apart)) == 0
    for off in (None, 0, 1):
        got = want.clone()
        if off is not None:      # one value a few ulps away, in set `off`
            bits = got[off].view(torch.int16)
            bits[7, 9] = bits[7, 9] + (3 if bits[7, 9] >= 0 else -3)
        worst = max(probe_bf16_ops.ulp_distance(got[k], apart[k]) for k in range(2))
        together = probe_bf16_ops.entry(got, want)
        assert together == ("ok" if worst == 0 else f"differs (max {worst} ulp)")
        assert (together == "ok") == (off is None)


def test_probe_grid_spreads_over_every_sm():
    """The stacked sets' 131,072 elements in blocks of 512 on 132 SMs (256
    programs, where blocks of 1024 gave 128 and one set alone 64)."""
    elements = 2 * probe_bf16_ops.SHAPE[0] * probe_bf16_ops.SHAPE[1]
    assert probe_bf16_ops.block_size(elements, 132) == 512
    for sms in (1, 16, 108, 132, 144, 1000):
        block = probe_bf16_ops.block_size(elements, sms)
        assert elements % block == 0 and block <= probe_bf16_ops.MAX_BLOCK
        assert elements // block >= min(sms, elements) or block == 1
        assert block == probe_bf16_ops.MAX_BLOCK or elements // (2 * block) < sms


def test_ulp_distance():
    one = torch.tensor([1.0, -1.0, float("nan")], dtype=torch.bfloat16)
    next_up = torch.tensor([1.0078125, -1.0078125, float("nan")], dtype=torch.bfloat16)
    assert probe_bf16_ops.ulp_distance(one, one) == 0
    assert probe_bf16_ops.ulp_distance(one, next_up) == 1
    assert probe_bf16_ops.ulp_distance(one[:1], -one[:1]) == 2 * 0x3F80


# --------------------------------------------------------------------------- #
# T2: the plain chain against make_kernel in interpret mode

CHAIN_SCRIPT = """
import sys
import numpy as np
import pytest
import jax.numpy as jnp
sys.path.insert(0, TOOLS)
import bench_vpu_dtype
outputs = {}
with pytest.MonkeyPatch.context() as patch:
    for name, value in (("H", 64), ("W", 128), ("BH", 32), ("REPS", 3)):
        patch.setattr(bench_vpu_dtype, name, value)
    rng = np.random.default_rng(0)
    a = rng.random((64, 128), np.float32)
    b = rng.random((64, 128), np.float32)
    for dtype in ("float32", "bfloat16"):
        jdtype = getattr(jnp, dtype)
        out = bench_vpu_dtype.make_kernel(jdtype)(jnp.asarray(a, jdtype), jnp.asarray(b, jdtype))
        outputs[dtype] = np.asarray(out.astype(jnp.float32))
np.savez(OUTPUT, a=a, b=b, **outputs)
"""


@pytest.fixture(scope="module")
def chain_reference(tmp_path_factory):
    """tools/bench_vpu_dtype.make_kernel in interpret mode at H = 64, W = 128
    (32-row blocks), REPS = 3 (its globals shrunk with monkeypatch), in a
    child on XLA:CPU without FMA (XLA_FLAGS=--xla_cpu_max_isa=AVX): XLA
    contracts c * b + a into an FMA otherwise, the card's kernel and torch
    do not."""
    output = tmp_path_factory.mktemp("chain") / "chain.npz"
    script = f"TOOLS, OUTPUT = {str(TOOLS)!r}, {str(output)!r}\n" + CHAIN_SCRIPT
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    result = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    return dict(np.load(output))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_plain_matches_reference(dtype, chain_reference):
    """The plain chain against the reference's kernel (chain_reference), on
    its uniform [0, 1) inputs. Tolerances, each with its reason:

      float32: within 1.2e-7 (2 ulps below 2) on < 2 % of values. torch's
        CPU sqrt is not correctly rounded (about 0.6 % of float32 inputs
        differ by 1 ulp from IEEE sqrt, which XLA and the card compute);
        measured: 0.72 % of values, max 5.96e-8.
      bfloat16: equal, except where in some round the rounding of c * b + a
        to bfloat16 crosses 1.0 (< 3 % of values). The reference's compiled
        program compares the UNROUNDED float32 sum with 1.0 (XLA drops the
        convert pair around the compare's upcast), the plain chain and the
        card compare the rounded bfloat16 value, so there the select takes
        the other branch. Measured: 1.10 % of values differ, all of them
        among those crossings.
    """
    tdtype = getattr(torch, dtype)
    a, b = (torch.from_numpy(chain_reference[k]).to(tdtype) for k in ("a", "b"))
    got = bench_dtype.chain_plain(a, b, reps=3)
    assert got.dtype == tdtype
    diff = np.abs(got.float().numpy() - chain_reference[dtype])
    share = float((diff != 0).mean())
    print(f"T2 {dtype}: {share:.4%} of values differ, max {diff.max():.3g}")
    if dtype == "float32":
        assert diff.max() <= 1.2e-7 and share < 0.02
        return
    crossings = torch.zeros(a.shape, dtype=torch.bool)
    for done in range(3):            # the chain's value entering each round
        product = bench_dtype.chain_plain(a, b, reps=done) * b
        exact = product.float() + a.float()
        crossings |= (exact > 1.0) != ((product + a).float() > 1.0)
    crossings = crossings.numpy()
    print(f"T2 bfloat16: rounding crosses 1.0 on {crossings.mean():.4%} of values")
    assert diff[~crossings].max() == 0 and crossings.mean() < 0.03


def test_chain_counts_and_verdict():
    """The walker's count of one chain launch in each dtype (the declared
    block cost times the grid), per element and round, the ALU instructions
    the exact chain needs: float32 8 (the tail as one FMA, the abs a free
    operand modifier) and 1 sqrt; bfloat16 4.5 (7 issued as bf16x2 pairs
    count half, the float32 + 1e-3 one) and 1 sqrt. float32's 8 ALU ops
    take what its sqrt takes on the special-function units, which bound
    both dtypes. The count scales with the rounds a call asks (walked
    without the domain check, whose compares the walker counts as the
    caller's). And the reference's verdict rule (speedup > 1.3)."""
    elements = bench_dtype.H * bench_dtype.W
    reps = bench_dtype.REPS
    for dtype, alu in ((torch.float32, 8), (torch.bfloat16, 4.5)):
        blocks, per = bench_dtype.grid(dtype)
        assert blocks * bench_dtype.THREADS * per == elements
        cost = bench_dtype.tile_cost(dtype).scaled(blocks)
        assert cost.alu == alu * reps * elements
        assert cost.sfu == reps * elements
        assert cost.kernel_bytes == 3 * dtype.itemsize * elements
        for rounds in (reps, 2 * reps):
            with flopcount.Walker() as walker, pytest.MonkeyPatch.context() as patch:
                patch.setattr(bench_dtype, "chain_plain", lambda a, b, reps=None: a)
                bench_dtype.chain(*bench_dtype.inputs(dtype, device="cpu"), rounds,
                                  check_domain=False)
            assert walker.kernels == {"T2 chain": 1}
            assert (walker.cost.alu, walker.cost.sfu) == (cost.alu * rounds / reps,
                                                          cost.sfu * rounds / reps)
    f32_ms, f32_by = bench_dtype.bound(torch.float32)
    bf16_ms, bf16_by = bench_dtype.bound(torch.bfloat16)
    assert f32_by == bf16_by == "operations"
    sfu_ms = 1e3 * reps * elements / flopcount.SFU_OPS_PER_S
    assert 1e3 * 8 * reps * elements / flopcount.ALU_OPS_PER_S == pytest.approx(sfu_ms)
    assert f32_ms == pytest.approx(sfu_ms) and bf16_ms == pytest.approx(sfu_ms)
    assert "NOT worth it" in bench_dtype.verdict(1.0, 1.0)
    assert "worth shipping" in bench_dtype.verdict(1.4, 1.0)
