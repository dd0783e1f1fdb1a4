"""The fused tail stage of the PyTorch port (shaderflow_tpu_torch/ops/tailfuse.py
and the tracer/generator of kernel K1, ops/tailgen.py) against the JAX
package: the plain version that CPU tensors take, against the Pallas kernel
in interpret mode and against eval_reference + final_pass (planes, rows,
columns, scalars, and the Indexed and ColSampled forms); the tracer against
the direct call; and the input kinds and ops K1 refuses."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu.ops import tailfuse as jax_tailfuse
from shaderflow_tpu.ops.downsample import final_pass as jax_final_pass
from shaderflow_tpu_torch.ops import tailfuse, tailgen

REPO = Path(__file__).resolve().parent.parent


def _inputs(render_h, render_w):
    """The inputs of tests/test_tailfuse.py:_make_spec, as numpy."""
    rng = np.random.default_rng(7)
    return dict(color=rng.random((render_h, render_w, 3), np.float32),
                gain=rng.random((render_h, render_w), np.float32),
                rowv=np.linspace(0.0, 1.0, render_h, dtype=np.float32),
                colv=np.linspace(-1.0, 1.0, render_w, dtype=np.float32),
                vol=np.float32(0.37))


def _tail(where):
    """tests/test_tailfuse.py's tail, for either package's `where`."""
    def tail(tp):
        r, g, b = tp.vec3("color")
        k = tp.plane("gain")
        y = tp.row("rowv")
        x = tp.col("colv")
        v = tp.scalar("vol")
        vig = tp.astuv_x * (1.0 - tp.astuv_y) + 0.5
        mask = (tp.gluv_x * tp.gluv_x + tp.gluv_y * tp.gluv_y) < 1.0
        r = where(mask, r * k + v, r) * vig
        g = where(mask, g + y, g * 0.5) * vig
        b = (b + x * 0.1) * (1.0 + v) * vig
        return r, g, b
    return tail


def _specs(render_h, render_w):
    raw = _inputs(render_h, render_w)
    jax_spec = jax_tailfuse.make_spec(
        _tail(jnp.where), render_h, render_w,
        color=jnp.asarray(raw["color"]), gain=jnp.asarray(raw["gain"]),
        rowv=jax_tailfuse.Row(jnp.asarray(raw["rowv"])),
        colv=jax_tailfuse.Col(jnp.asarray(raw["colv"])), vol=jnp.asarray(raw["vol"]))
    spec = tailfuse.make_spec(
        _tail(torch.where), render_h, render_w,
        color=torch.from_numpy(raw["color"]), gain=torch.from_numpy(raw["gain"]),
        rowv=tailfuse.Row(torch.from_numpy(raw["rowv"])),
        colv=tailfuse.Col(torch.from_numpy(raw["colv"])), vol=torch.tensor(raw["vol"]))
    return jax_spec, spec


def _assert_u8_close(got, want):
    """Identical math, summation order of the pooling free: at most one
    quantization step apart, on < 1 % of values (tests/test_tailfuse.py)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


@pytest.mark.parametrize("out_h,out_w,subsample", [(48, 128, 1), (48, 128, 2), (30, 100, 2)])
def test_plain_k1_matches_jax(out_h, out_w, subsample):
    """The port's K1 on CPU tensors (its plain version) against the JAX fused
    kernel (interpret mode) and the JAX reference path; 30x100 is the
    uneven-tile case (neither a multiple of the tile nor of 8/128)."""
    render_h, render_w = out_h * subsample, out_w * subsample
    aspect = out_w / out_h
    jax_spec, spec = _specs(render_h, render_w)
    got = tailfuse.fused_tail_final(spec, render_h, render_w, out_h, out_w, subsample, aspect)
    fused = jax_tailfuse.fused_tail_final(jax_spec, render_h, render_w, out_h, out_w,
                                          subsample, aspect, interpret=True)
    reference = jax_final_pass(jax_tailfuse.eval_reference(
        jax_spec, render_h, render_w, aspect), out_h, out_w, subsample)
    assert got.shape == (out_h, out_w, 3)
    _assert_u8_close(got.numpy(), fused)
    _assert_u8_close(got.numpy(), reference)
    # the float stage itself, before quantization
    np.testing.assert_allclose(
        tailfuse.eval_reference(spec, render_h, render_w, aspect).numpy(),
        np.asarray(jax_tailfuse.eval_reference(jax_spec, render_h, render_w, aspect)),
        rtol=1e-6, atol=float(np.spacing(np.float32(4.0))))


def test_run_tail_final_equal_resolution_matches_jax():
    """ssaa=1 with subsample 2 (the 3-tap stencil regime) takes the plain
    path on CPU, as the JAX package's fallback does."""
    out_h, out_w = 40, 160
    jax_spec, spec = _specs(out_h, out_w)
    out = torch.empty((out_h, out_w, 3), dtype=torch.uint8)
    got = tailfuse.run_tail_final(spec, out_h, out_w, out_h, out_w, 2, 1.0, out=out)
    assert got is out
    _assert_u8_close(out.numpy(), jax_tailfuse.run_tail_final(
        jax_spec, out_h, out_w, out_h, out_w, 2, 1.0))


def _sampled_inputs(render_h, render_w, dtype):
    """The ColSampled inputs of tests/test_tailfuse.py (three (Hr, 640)
    planes, a zoom-in u line of ~0.2 texels per pixel) plus an Indexed stack
    of 3 planes read at index 7 (clipped to 2), as numpy; `dtype` is the
    planes' type."""
    rng = np.random.default_rng(11)
    planes = [rng.random((render_h, 640), np.float32) for _ in range(3)]
    u_line = np.linspace(0.2, 0.2 + 0.2 * render_w / 640, render_w, dtype=np.float32)
    stack = rng.random((3, render_h, render_w), np.float32)
    gain = rng.random((render_h, render_w), np.float32)
    if dtype == "bfloat16":   # round through bf16 the same way on both sides
        planes = [np.asarray(jnp.asarray(p).astype(jnp.bfloat16)) for p in planes]
        stack = np.asarray(jnp.asarray(stack).astype(jnp.bfloat16))
    return planes, u_line, stack, gain


def _sampled_tail(where):
    def tail(tp):
        r, g, b = tp.vec3("tex")
        k = tp.plane("bar", dtype=None)
        return (where(k > 0.5, r * tp.plane("gain"), r * 0.5), g * k + 0.1,
                b + 0.25 * tp.plane("bar"))
    return tail


def _torch_tensor(array):
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(array.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(array))


def _sampled_specs(render_h, render_w, dtype):
    planes, u_line, stack, gain = _sampled_inputs(render_h, render_w, dtype)
    jax_spec = jax_tailfuse.make_spec(
        _sampled_tail(jnp.where), render_h, render_w,
        tex=jax_tailfuse.ColSampled(tuple(jnp.asarray(p) for p in planes),
                                    jnp.asarray(u_line), texels_per_px=0.25),
        bar=jax_tailfuse.Indexed(jnp.asarray(stack), jnp.int32(7)),
        gain=jnp.asarray(gain))
    spec = tailfuse.make_spec(
        _sampled_tail(torch.where), render_h, render_w,
        tex=tailfuse.ColSampled(tuple(_torch_tensor(p) for p in planes),
                                torch.from_numpy(u_line), texels_per_px=0.25),
        bar=tailfuse.Indexed(_torch_tensor(stack), 7),
        gain=torch.from_numpy(gain))
    return jax_spec, spec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("subsample", [1, 2])
def test_plain_indexed_colsampled_match_jax(subsample, dtype):
    """The plain Indexed and ColSampled forms (CPU tensors) against the JAX
    fused kernel in interpret mode and the JAX reference path: at most one
    u8 step on < 1 %; the column interpolation itself equals the JAX
    reference's dense product (two nonzero products, exact for bf16)."""
    out_h, out_w = 64, 512
    render_h, render_w = out_h * subsample, out_w * subsample
    aspect = out_w / out_h
    jax_spec, spec = _sampled_specs(render_h, render_w, dtype)
    assert set(spec.colsampled) == {"tex"} and set(spec.indexed) == {"bar"}
    got = tailfuse.fused_tail_final(spec, render_h, render_w, out_h, out_w, subsample, aspect)
    fused = jax_tailfuse.fused_tail_final(jax_spec, render_h, render_w, out_h, out_w,
                                          subsample, aspect, interpret=True)
    reference = jax_final_pass(jax_tailfuse.eval_reference(
        jax_spec, render_h, render_w, aspect), out_h, out_w, subsample)
    _assert_u8_close(got.numpy(), fused)
    _assert_u8_close(got.numpy(), reference)
    sampled = tailfuse.materialize_colsampled(spec)["tex"]
    dense = jax_tailfuse._materialize_colsampled(jax_spec)["tex"]
    for ours, theirs in zip(sampled, dense):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-7)
    assert torch.equal(tailfuse.materialize_indexed(spec)["bar"][0], spec.indexed["bar"].stack[2])


def _mandelbrot_spec(render_h, render_w):
    sys.path.insert(0, str(REPO / "examples" / "torch"))
    try:
        import torch_fractals
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(2)
    iters = torch.from_numpy(np.round(rng.random((render_h, render_w)) * 150).astype(np.float32))
    iters[::7] = 500.0   # interior rows
    oob = torch.from_numpy((rng.random(render_w) > 0.8).astype(np.float32))
    return tailfuse.make_spec(torch_fractals.mandelbrot_tail(500, True), render_h, render_w,
                              iters=iters, oob=tailfuse.Col(oob))


def _transcendental_spec(render_h, render_w):
    """A tail through the reference's polynomial atan2 and exp/log powf:
    abs, maximum, minimum, clamp, where, exp, log, sqrt and floor."""
    _, spec = _specs(render_h, render_w)

    def tail(tp):
        r, g, b = tp.vec3("color")
        hue = tailfuse.atan2(g - 0.5, tp.col("colv")) / 6.2831855 + 0.5
        glow = tailfuse.powf(torch.clamp(r, min=1e-3), 2.2)
        ring = torch.sqrt(tp.gluv_x * tp.gluv_x + tp.gluv_y * tp.gluv_y)
        bands = torch.floor(ring * 8.0) / 8.0
        return hue, glow * tp.scalar("vol"), torch.minimum(bands, b)

    return spec._replace(fn=tail)


@pytest.mark.parametrize("which", ["make_spec", "mandelbrot", "transcendental",
                                   "indexed_colsampled"])
def test_traced_graph_equals_direct_call(which):
    """The expression graph K1 is generated from, evaluated with torch,
    equals the direct tail call bit for bit; the generated Triton source is
    valid Python and loads exactly the inputs the tail reads."""
    render_h, render_w = 24, 64
    spec = {"make_spec": lambda: _specs(render_h, render_w)[1],
            "mandelbrot": lambda: _mandelbrot_spec(render_h, render_w),
            "transcendental": lambda: _transcendental_spec(render_h, render_w),
            "indexed_colsampled": lambda: _sampled_specs(render_h, render_w, "bfloat16")[1],
            }[which]()
    aspect = 1.5
    graph, outputs = tailgen.trace(spec, render_h, render_w, aspect)
    shape = (render_h, render_w)
    env = {("row_index", "", 0): torch.arange(render_h, dtype=torch.float32)[:, None].expand(shape),
           ("col_index", "", 0): torch.arange(render_w, dtype=torch.float32)[None, :].expand(shape)}
    for name, channels in {**spec.planes, **tailfuse.materialize_indexed(spec)}.items():
        env.update({("plane", name, c): plane for c, plane in enumerate(channels)})
    for name, channels in tailfuse.materialize_colsampled(spec).items():
        env.update({("colsampled", name, c): plane for c, plane in enumerate(channels)})
    env.update({("row", name, 0): value.reshape(-1, 1) for name, value in spec.rows.items()})
    env.update({("col", name, 0): value.reshape(1, -1) for name, value in spec.cols.items()})
    env.update({("scalar", name, 0): value for name, value in spec.scalars.items()})
    traced = torch.stack([torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32), shape)
                          for v in tailgen.evaluate(graph, outputs, env)], dim=-1)
    direct = tailfuse.eval_reference(spec, render_h, render_w, aspect)
    assert torch.equal(traced, direct)

    source, keys = tailgen.generate(graph, outputs, 2, frozenset(spec.colsampled))
    compile(source, "<generated K1>", "exec")
    color = {("plane", "color", c) for c in range(3)}
    expected = {"make_spec": color | {("plane", "gain", 0), ("row", "rowv", 0),
                                      ("col", "colv", 0), ("scalar", "vol", 0)},
                "mandelbrot": {("plane", "iters", 0), ("col", "oob", 0)},
                "transcendental": color | {("col", "colv", 0), ("scalar", "vol", 0)},
                "indexed_colsampled": {("colsampled", "tex", c) for c in range(3)}
                | {("plane", "bar", 0), ("plane", "gain", 0)}}
    assert set(keys) == expected[which]
    if which == "indexed_colsampled":
        # one position load and one pair of bf16-rounded hat weights per
        # sub-position, shared by the three channels
        assert source.count("tl.load(pos0 + ci") == 1
        assert source.count(".to(tl.bfloat16).to(tl.float32)") == 2


def test_unported_input_kinds_raise():
    """Table inputs are classified but neither path takes them yet:
    NotImplementedError naming the kind. The Indexed and ColSampled kinds
    are ported: both paths take them, and Indexed refuses an index that
    lives on a device (reading it back would stall the frame loop)."""
    h, w = 8, 16
    spec = tailfuse.make_spec(lambda tp: (0.0, 0.0, 0.0), h, w,
                              x=tailfuse.Table(torch.zeros(4, 3)))
    with pytest.raises(NotImplementedError, match="Table"):
        tailfuse.eval_reference(spec, h, w, 1.0)
    with pytest.raises(NotImplementedError, match="Table"):
        tailgen.trace(spec, h, w, 1.0)
    ported = {
        "Indexed": tailfuse.Indexed(torch.ones(2, h, w), torch.tensor(0)),
        "ColSampled": tailfuse.ColSampled((torch.ones(h, 32),), torch.linspace(0, 1, w), 1.0),
    }
    for kind, value in ported.items():
        spec = tailfuse.make_spec(lambda tp: (tp.plane("x"),) * 3, h, w, x=value)
        assert torch.equal(tailfuse.eval_reference(spec, h, w, 1.0), torch.ones(h, w, 3))
        graph, _ = tailgen.trace(spec, h, w, 1.0)
        assert len(graph.inputs) == 3   # the plane and the two coordinate indices
    device_index = tailfuse.Indexed(torch.ones(2, h, w), torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="host index"):
        tailfuse.indexed_position(device_index)


def test_unsupported_tail_code_raises():
    """An op the template has no form for, data-dependent Python control
    flow, and tensors smuggled in through closures are refused at trace."""
    h, w = 8, 16
    plane = torch.zeros(h, w)
    bad = {
        NotImplementedError: lambda tp: (torch.sin(tp.plane("p")),) * 3,
        TypeError: lambda tp: (tp.plane("p") if tp.plane("p") > 0 else 0.0,) * 3,
    }
    for error, fn in bad.items():
        with pytest.raises(error):
            tailgen.trace(tailfuse.make_spec(fn, h, w, p=plane), h, w, 1.0)
    with pytest.raises(NotImplementedError, match="closures"):
        tailgen.trace(tailfuse.make_spec(lambda tp: (tp.plane("p") * plane,) * 3, h, w, p=plane),
                      h, w, 1.0)


def test_make_spec_classification():
    _, spec = _specs(16, 32)
    assert set(spec.planes) == {"color", "gain"} and len(spec.planes["color"]) == 3
    assert set(spec.rows) == {"rowv"} and set(spec.cols) == {"colv"}
    assert set(spec.scalars) == {"vol"}
    with pytest.raises(ValueError, match="Ambiguous"):
        tailfuse.make_spec(lambda tp: None, 32, 32, x=torch.zeros(32))
    with pytest.raises(ValueError, match="render == out"):
        tailfuse.fused_tail_final(spec, 16, 32, 10, 16, 2, 1.0)
