"""T2's chain kernel (shaderflow_tpu_torch/csrc/chain.cu) on the CPU: what
its packed bfloat16 form relies on, and its wrapper. The kernel itself
runs on the card (tests/test_torch_cuda.py); the plain chain against the
JAX reference is tests/test_torch_tools.py.

The bf16 kernel issues each of c * b, + a and 1 - c as one bf16x2
instruction rounded once (.rn), where torch computes the op in float32 and
rounds that to bfloat16; it compares c > 1 in bfloat16 where torch compares
in float32; it halves c by decrementing the exponent's bits; and both
kernels compute c + (1 - c) * 0.25 as one FMA. The tests below hold each
equal to torch's ops on the chain's operands, so the kernels can equal the
plain chain bit for bit.
"""

import numpy as np
import pytest
import torch

from shaderflow_tpu_torch.tools import bench_dtype


def _bf16_bits(values: np.ndarray) -> np.ndarray:
    """float64 values (zero, or normal in bfloat16) rounded once to
    bfloat16, to nearest even on the bits -> the bfloat16's 16 bits. The
    45 low fraction bits of the float64 go; what is left is its sign (bit
    18), exponent (bits 7-17) and 7 fraction bits."""
    bits = values.astype(np.float64).view(np.int64)
    drop = 52 - 7
    lsb = (bits >> drop) & 1
    rounded = (bits + (1 << (drop - 1)) - 1 + lsb) >> drop
    sign = (rounded >> 18) & 1
    exponent = ((rounded >> 7) & 0x7FF) - 1023 + 127
    zero = values == 0
    assert np.all(zero | ((exponent > 0) & (exponent < 255))), "outside bf16's normal range"
    out = (sign << 15) | (np.where(zero, 0, exponent) << 7) | (rounded & 0x7F)
    return out.astype(np.uint16)


def _bits(tensor: torch.Tensor) -> np.ndarray:
    return tensor.contiguous().view(torch.int16).numpy().view(np.uint16)


def _sweep(count: int, seed: int) -> torch.Tensor:
    """bfloat16 operands from the chain's range: half uniform in [0, 4),
    half log-uniform in [2^-12, 4) (small values round 1 - c hardest),
    plus 0 and the rounding edges near 1 and 2."""
    rng = np.random.default_rng(seed)
    uniform = rng.uniform(0.0, 4.0, count // 2)
    small = np.exp2(rng.uniform(-12.0, 2.0, count - count // 2))
    edges = np.array([0.0, 1.0, 1.0078125, 0.99609375, 2.0, 1.9921875])
    return torch.from_numpy(np.concatenate([uniform, small, edges]).astype(np.float32)).to(
        torch.bfloat16)


def test_bf16_compare_matches_float32_compare():
    """Exhaustive over all 65,536 bfloat16 bit patterns: x > 1.0 in
    bfloat16 (torch's compare, and IEEE's order on the bits: sign and
    magnitude, NaN unordered) gives the predicate of x.float() > 1.0."""
    x = _all_bf16()
    bits = x.view(torch.int16)
    want = x.float() > 1.0
    assert torch.equal(x > torch.tensor(1.0, dtype=torch.bfloat16), want)
    raw = bits.to(torch.int32) & 0xFFFF
    ordered = torch.where(raw >= 0x8000, -(raw & 0x7FFF), raw)
    nan = ((raw & 0x7F80) == 0x7F80) & ((raw & 0x7F) != 0)
    assert torch.equal((ordered > 0x3F80) & ~nan, want)
    assert int(want.sum()) == 0x7F80 - 0x3F80   # every finite and infinite x above 1


@pytest.mark.parametrize("op", ["c*b", "+a", "1-c", "*0.25", "*0.5"])
def test_bf16_pair_ops_round_once(op):
    """Each op of the chain, computed as torch computes it (float32, then
    rounded to bfloat16), equals the exact result (float64) rounded once to
    bfloat16: what a bf16x2 .rn instruction returns (the kernel issues c *
    b, + a and 1 - c so; * 0.25 and * 0.5 are exact). On the chain's
    operands the float32 step never double-rounds."""
    c, other = _sweep(1 << 18, 1), _sweep(1 << 18, 2)
    exact_c, exact_other = c.double().numpy(), other.double().numpy()
    if op == "c*b":
        got, exact = c * other, exact_c * exact_other
    elif op == "+a":
        got, exact = c + other, exact_c + exact_other
    elif op == "1-c":
        got, exact = 1.0 - c, 1.0 - exact_c
    elif op == "*0.25":
        got, exact = c * 0.25, exact_c * 0.25
    else:
        got, exact = c * 0.5, exact_c * 0.5
    assert got.dtype == torch.bfloat16
    want = _bf16_bits(exact)
    assert np.array_equal(_bits(got), want), f"{op}: {int((_bits(got) != want).sum())} differ"


def _all_bf16() -> torch.Tensor:
    """All 65,536 bfloat16 bit patterns."""
    return torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)


def test_bf16_select_is_an_exponent_decrement():
    """Exhaustive: the kernel's select, bits - (bits of (x > 1 ? 1.0 : 0.0)
    & 0x0080), equals torch.where(x.float() > 1, x * 0.5, x) bit for bit
    on every finite bfloat16 and NaN; the one pattern it leaves is +inf
    (the chain's c is finite)."""
    x = _all_bf16()
    bits = x.view(torch.int16).to(torch.int32) & 0xFFFF
    above = torch.where(x > torch.tensor(1.0, dtype=torch.bfloat16), 0x3F80, 0)
    got = (bits - (above & 0x0080)).to(torch.int16)
    want = torch.where(x.float() > 1.0, x * 0.5, x).view(torch.int16)
    differ = got != want
    assert int(differ.sum()) == 1 and torch.isinf(x[differ]).all() and x[differ].item() > 0


def test_bf16_tail_is_one_fma():
    """Exhaustive over every bfloat16 c in [2^-20, 2^20] and its negative
    (where the float64 sum is exact): c + (1 - c) * 0.25 as torch computes
    it (three bf16 ops) equals fma(1 - c, 0.25, c) rounded once, the
    kernel's HFMA2: the product by 0.25 is exact."""
    c = _all_bf16()
    magnitude = c.float().abs()
    c = c[(magnitude >= 2.0 ** -20) & (magnitude <= 2.0 ** 20)]
    got = c + (1.0 - c) * 0.25
    exact = (1.0 - c).double().numpy() * 0.25 + c.double().numpy()
    assert np.array_equal(_bits(got), _bf16_bits(exact))


def test_f32_tail_is_one_fma():
    """The f32 kernel's fmaf(1 - c, 0.25, c) equals c + (1 - c) * 0.25 in
    float32 over a seeded sweep of the chain's range and its edges:
    (1 - c) * 0.25 is exact, so one rounding of the sum gives the same."""
    rng = np.random.default_rng(3)
    c = np.concatenate([rng.uniform(0.0, 4.0, 1 << 20), np.exp2(rng.uniform(-12, 2, 1 << 20)),
                        [0.0, 1.0, np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0)]]).astype(np.float32)
    t = np.float32(1.0) - c
    want = c + t * np.float32(0.25)
    exact = t.astype(np.float64) * 0.25 + c.astype(np.float64)   # exact: 50 bits at most
    assert want.dtype == np.float32 and np.array_equal(exact.astype(np.float32), want)


def test_round_once_helper():
    """The helper's rounding: ties to even, carries into the exponent."""
    values = np.array([1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 2.0 - 2.0 ** -9, -1.5, 0.0])
    want = torch.tensor([1.0, 1.0, 1.015625, 2.0, -1.5, 0.0], dtype=torch.bfloat16)
    assert np.array_equal(_bf16_bits(values), _bits(want))


@pytest.mark.parametrize("dtype", bench_dtype.DTYPES)
@pytest.mark.parametrize("elements", [bench_dtype.H * bench_dtype.W, 8 * 1000, 16])
def test_grid_covers_every_element_once(dtype, elements):
    """Thread t of block k owns the elements [(k * THREADS + t) * per, ...
    + per), as csrc/chain.cu indexes them: every element of the chain is
    owned exactly once, and no block is wholly idle."""
    blocks, per = bench_dtype.grid(dtype, elements)
    assert per * dtype.itemsize == bench_dtype.VECTOR_BYTES
    vectors = elements // per
    threads = np.arange(blocks)[:, None] * bench_dtype.THREADS + np.arange(bench_dtype.THREADS)
    owned = threads[threads < vectors][:, None] * per + np.arange(per)
    assert np.array_equal(np.sort(owned.ravel()), np.arange(elements))
    assert (blocks - 1) * bench_dtype.THREADS < vectors


def test_chain_wrapper_raises_on_what_the_kernel_does_not_take():
    """Shape, dtype, contiguity and device are checked before anything runs."""
    H, W = bench_dtype.H, bench_dtype.W
    a = torch.zeros((H, W))
    bad = [
        (torch.zeros((H, W - 8)), torch.zeros((H, W - 8))),           # shape
        (a, torch.zeros((H, W + 8))),                                  # b's shape
        (a.half(), a.half()),                                          # dtype
        (a, a.to(torch.bfloat16)),                                     # mixed dtypes
        (a.t(), a),                                                    # contiguity
        (torch.zeros((H, W), device="meta"), torch.zeros((H, W), device="meta")),  # device
        (a, torch.zeros((H, W), device="meta")),                       # two devices
    ]
    launches = bench_dtype.chain.launches
    for x, y in bad:
        with pytest.raises(ValueError):
            bench_dtype.chain(x, y)
    assert bench_dtype.chain.launches == launches
    for x in (torch.zeros(8, dtype=torch.float64), torch.zeros(8).view(2, 4).t(),
              torch.zeros(8, device="meta")):
        with pytest.raises(ValueError):
            bench_dtype.chain_sqrt(x)


def test_chain_wrapper_rejects_inputs_outside_its_domain():
    """The kernel's square root is exact only on the domain that inputs in
    [0, 1] keep the chain in: a value below 0, above 1, or not a number, in
    a or in b, is rejected before anything runs; the domain's edges pass
    (the reference's bfloat16 inputs hold 1.0, rounded up), and the check
    can be skipped for inputs already checked."""
    launches = bench_dtype.chain.launches
    for dtype in bench_dtype.DTYPES:
        a, b = bench_dtype.inputs(dtype, device="cpu")
        above_one = 1.0 + torch.finfo(dtype).eps                      # 1 and an ulp
        for value in (-2.0 ** -10, above_one, 1.5, float("inf"), float("nan")):
            for which in range(2):
                bad = [a.clone(), b.clone()]
                bad[which][3, 5] = value
                with pytest.raises(ValueError, match=r"\[0, 1\]"):
                    bench_dtype.chain(*bad)
        edges = a.clone()
        edges[0, 0], edges[0, 1] = 0.0, 1.0
        out = bench_dtype.chain(edges, b, 2)
        assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
        bad = a.clone()
        bad[0, 0] = 1.5
        bench_dtype.chain(bad, b, 1, check_domain=False)
    assert bench_dtype.chain.launches == launches


def test_chain_on_cpu_is_the_plain_chain():
    """A CPU tensor goes through the plain chain (no launch); the values
    entering the square root stay in its checked domain [2^-10, 4)."""
    a, b = bench_dtype.inputs(torch.bfloat16, device="cpu")
    launches = bench_dtype.chain.launches
    out = bench_dtype.chain(a, b)
    assert bench_dtype.chain.launches == launches
    assert torch.equal(out, bench_dtype.chain_plain(a, b))
    low, high = (torch.tensor(v, dtype=torch.int32).view(torch.float32).item()
                 for v in bench_dtype.SQRT_DOMAIN)
    assert (low, high) == (2.0 ** -10, 4.0)
    for dtype in bench_dtype.DTYPES:
        a, b = (x[:64] for x in bench_dtype.inputs(dtype, device="cpu"))
        c = a
        for _ in range(bench_dtype.REPS):
            c = c * b + a
            c = torch.where(c.to(torch.float32) > 1.0, c * 0.5, c)
            x = torch.abs(c).to(torch.float32) + 1e-3
            assert low <= x.min().item() and x.max().item() < high
            c = torch.sqrt(x).to(dtype)
            c = c + (1.0 - c) * 0.25
        assert torch.equal(c, bench_dtype.chain_plain(a, b))
