"""The sampling functions of the PyTorch port (shaderflow_tpu_torch/ops/
sampling.py) against the JAX package on the same numpy inputs: the blocked
row sampler, the blur kernel and its convolution, separable sampling, and
the plain version of kernel K2 against the JAX gather and the JAX Pallas
K2 in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu.ops import sampling as jax_sampling
from shaderflow_tpu_torch.ops import sampling


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    arrays (given as float32 values)."""
    a = got.astype(np.float32).view(np.int32) >> 16
    b = want.astype(np.float32).view(np.int32) >> 16
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _texture(seed: int, height: int, width: int, channels: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).random((height, width, channels), np.float32)


@pytest.mark.parametrize("height,width,render_h,tpp", [
    (270, 480, 720, 0.96 ** 2 * 270 / 720),    # blocked: windows of texel rows
    (60, 96, 144, 0.96 ** 2 * 60 / 144),       # one window covers the texture
])
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_sample_rows_planes_blocked_matches_jax(height, width, render_h, tpp, precision):
    """The visualizer's background row sampler: with bf16 operands the
    two-product sums are exact in f32, so the result is within 1 bf16 ulp
    of the JAX package (measured: 0); in f32, within 1e-6 relative."""
    data = _texture(1, height, width)
    t = np.arange(render_h, dtype=np.float32)
    v_line = (0.5 + (0.5 - (t + 0.5) / render_h) * 0.88 + 0.004).astype(np.float32)
    out_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    got = sampling.sample_rows_planes_blocked(
        sampling.Sampler2D(torch.from_numpy(data)), torch.from_numpy(v_line),
        texels_per_px=tpp, precision=precision, out_dtype=out_dtype)
    want = jax_sampling.sample_rows_planes_blocked(
        jax_sampling.Sampler2D(jnp.asarray(data)), jnp.asarray(v_line),
        texels_per_px=tpp, precision=precision,
        out_dtype=jnp.bfloat16 if precision == "bfloat16" else jnp.float32)
    assert len(got) == len(want) == 3
    for plane, reference in zip(got, want):
        plane = plane.to(torch.float32).numpy()
        reference = np.asarray(reference, np.float32)
        assert plane.shape == reference.shape == (render_h, width)
        if precision == "bfloat16":
            assert _bf16_ulps(plane, reference) <= 1
        else:
            np.testing.assert_allclose(plane, reference, rtol=1e-6, atol=1e-7)


def test_splat_kernel_and_convolve2d_match_jax():
    """The visualizer's radial blur: 80 taps splatted into a 5 x 5 kernel,
    applied as a depthwise convolution (f32, <= 1e-6 relative)."""
    rng = np.random.default_rng(4)
    angles = np.repeat(np.arange(8) * np.pi / 4, 10)
    walks = np.tile(np.arange(1, 11) / 10, 8)
    offsets = (np.stack([np.cos(angles) * walks, np.sin(angles) * walks], axis=1)
               * 0.0027 * np.array([270.0, -270.0])).astype(np.float32)
    kernel = sampling.splat_kernel(torch.from_numpy(offsets), size=5)
    jax_kernel = jax_sampling.splat_kernel(jnp.asarray(offsets), size=5)
    np.testing.assert_allclose(kernel.numpy(), np.asarray(jax_kernel), rtol=1e-6, atol=1e-7)
    image = rng.random((27, 48, 3), np.float32)
    got = sampling.convolve2d(torch.from_numpy(image), kernel).numpy()
    want = np.asarray(jax_sampling.convolve2d(jnp.asarray(image), jax_kernel))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("linear,repeat", [(True, False), (True, True), (False, False)])
def test_sample_separable_matches_jax(linear, repeat):
    """The waveform row: a (1, 180, 2) texture sampled along x at v = 0,
    and a 2D texture on an axis-aligned grid (f32, <= 1e-6 relative)."""
    rng = np.random.default_rng(6)
    for data, u, v in (
            (rng.random((1, 180, 2), np.float32),
             ((np.arange(384) + 0.5) / 384).astype(np.float32), np.zeros(1, np.float32)),
            (rng.random((20, 30, 3), np.float32),
             np.linspace(-0.2, 1.3, 50, dtype=np.float32),
             np.linspace(1.1, -0.1, 40, dtype=np.float32))):
        got = sampling.sample_separable(
            sampling.Sampler2D(torch.from_numpy(data), linear, repeat, repeat),
            torch.from_numpy(u), torch.from_numpy(v)).numpy()
        want = np.asarray(jax_sampling.sample_separable(
            jax_sampling.Sampler2D(jnp.asarray(data), linear, repeat, repeat),
            jnp.asarray(u), jnp.asarray(v)))
        assert got.shape == want.shape == (len(v), len(u), data.shape[2])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _bar_inputs(seed: int, batch: int, height: int, width: int):
    rng = np.random.default_rng(seed)
    tables = (rng.random((batch, 115, 2), np.float32) * 900.0).astype(np.float32)
    v_field = rng.uniform(-0.05, 1.05, size=(height, width)).astype(np.float32)
    where = rng.random((height, width)) > 0.5
    return tables, v_field, where


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("repeat_y", [False, True])
def test_plain_k2_matches_jax_gather(out_dtype, repeat_y):
    """The plain K2 (the path CPU tensors take) against the JAX package's
    exact gather: bit for bit, clamped and wrapped rows."""
    tables, v_field, where = _bar_inputs(3, 5, 24, 40)
    got = sampling.lookup_nearest_1d_select_batched(
        torch.from_numpy(tables), torch.from_numpy(v_field),
        channel_where=torch.from_numpy(where), repeat_y=repeat_y,
        out_dtype=getattr(torch, out_dtype))
    want = jax_sampling.lookup_nearest_1d_select_batched(
        jnp.asarray(tables), jnp.asarray(v_field), channel_where=jnp.asarray(where),
        repeat_y=repeat_y, out_dtype=getattr(jnp, out_dtype))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


def test_plain_k2_matches_jax_pallas_interpret(monkeypatch):
    """The plain K2 against the JAX package's Pallas kernel (its one-hot
    MXU product, run in interpret mode): bit for bit."""
    tables, v_field, where = _bar_inputs(9, 4, 16, 48)
    monkeypatch.setenv("SHADERFLOW_TAILFUSE_INTERPRET", "1")
    want = jax_sampling.lookup_nearest_1d_select_batched(
        jnp.asarray(tables), jnp.asarray(v_field), channel_where=jnp.asarray(where),
        out_dtype=jnp.bfloat16, block=256)
    got = sampling.lookup_nearest_1d_select_batched(
        torch.from_numpy(tables), torch.from_numpy(v_field),
        channel_where=torch.from_numpy(where), out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


def test_k2_wrapper_takes_plain_on_cpu_and_counts_only_launches():
    """On CPU tensors the wrapper takes the plain gather and counts no
    launch; what it refuses raises before any build."""
    tables, v_field, where = _bar_inputs(1, 2, 8, 16)
    before = sampling.expand_tables.launches
    out = sampling.lookup_nearest_1d_select_batched(
        torch.from_numpy(tables), torch.from_numpy(v_field),
        channel_where=torch.from_numpy(where), out_dtype=torch.bfloat16)
    assert out.shape == (2, 8, 16) and out.dtype == torch.bfloat16
    assert sampling.expand_tables.launches == before
    index = sampling.lookup_index(torch.from_numpy(v_field), 115, 2, torch.from_numpy(where))
    assert index.dtype == torch.int32 and int(index.max()) < 230 and int(index.min()) >= 0
    flat16 = torch.from_numpy(tables).reshape(2, -1).to(torch.bfloat16)
    assert torch.equal(sampling.expand_tables(flat16, index, torch.bfloat16),
                       flat16.index_select(1, index))
