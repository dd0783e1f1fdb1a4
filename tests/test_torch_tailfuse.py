"""The fused tail stage of the PyTorch port (shaderflow_tpu_torch/ops/tailfuse.py
and the tracer/generator of kernel K1, ops/tailgen.py) against the JAX
package: the plain version that CPU tensors take, against the Pallas kernel
in interpret mode and against eval_reference + final_pass (planes, rows,
columns, scalars, and the Indexed, ColSampled and Table forms); the
quantize=False form and the equal-resolution regime against the JAX
package's fused path (SHADERFLOW_TAILFUSE_INTERPRET=1); the tracer against
the direct call; and the ops K1 refuses."""

import hashlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu.ops import tailfuse as jax_tailfuse
from shaderflow_tpu.ops.downsample import final_pass as jax_final_pass
from shaderflow_tpu_torch.ops import tailfuse, tailgen
from test_torch_scene import _import_example

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


def _jit_run_tail_final(fn, inputs: dict, render_h, render_w, out_h, out_w, subsample,
                        aspect):
    """The JAX package's run_tail_final under jit, as its render runs it."""
    def run(**arrays):
        spec = jax_tailfuse.make_spec(fn, render_h, render_w, **arrays)
        return jax_tailfuse.run_tail_final(spec, render_h, render_w, out_h, out_w,
                                           subsample, aspect)
    return np.asarray(jax.jit(run)(**inputs))


def test_run_tail_final_equal_resolution_matches_jax(monkeypatch):
    """ssaa=1 with subsample 2 (the 3-tap stencil regime): K1's
    quantize=False form, then the stencil, as the JAX package's fused path
    runs it (SHADERFLOW_TAILFUSE_INTERPRET=1, the Pallas kernel in
    interpret mode, under jit): at most one u8 step on < 1 % (XLA:CPU
    contracts the tail's a * b + c into FMAs)."""
    monkeypatch.setenv("SHADERFLOW_TAILFUSE_INTERPRET", "1")
    out_h, out_w = 40, 160
    _, spec = _specs(out_h, out_w)
    raw = _inputs(out_h, out_w)
    out = torch.empty((out_h, out_w, 3), dtype=torch.uint8)
    got = tailfuse.run_tail_final(spec, out_h, out_w, out_h, out_w, 2, 1.0, out=out)
    assert got is out
    want = _jit_run_tail_final(
        _tail(jnp.where), dict(color=jnp.asarray(raw["color"]), gain=jnp.asarray(raw["gain"]),
                               rowv=jax_tailfuse.Row(jnp.asarray(raw["rowv"])),
                               colv=jax_tailfuse.Col(jnp.asarray(raw["colv"])),
                               vol=jnp.asarray(raw["vol"])),
        out_h, out_w, out_h, out_w, 2, 1.0)
    _assert_u8_close(out.numpy(), want)


@pytest.mark.parametrize("subsample", [2, 3])
def test_equal_resolution_stencil_matches_jax(monkeypatch, subsample):
    """The stencil arithmetic alone: an identity tail over bf16-exact
    planes, so K1 (d)'s planes are the inputs bit for bit. The port's
    final_equal_resolution equals the JAX package's compiled stencil
    exactly: every product and sum rounded to bf16 except the last sum,
    which XLA keeps in f32 (the bf16 rounding folds into quantize_u8's
    upcast). s = 3 has a side weight that rounds to bf16."""
    monkeypatch.setenv("SHADERFLOW_TAILFUSE_INTERPRET", "1")
    rng = np.random.default_rng(subsample)
    out_h, out_w = 40, 64
    color = (rng.random((out_h, out_w, 3), np.float32) * 1.2 - 0.1)
    color = torch.from_numpy(color).to(torch.bfloat16).to(torch.float32).numpy()

    def tail(tp):
        return tp.vec3("c")

    spec = tailfuse.make_spec(tail, out_h, out_w, c=torch.from_numpy(color))
    got = tailfuse.run_tail_final(spec, out_h, out_w, out_h, out_w, subsample, 1.6)
    want = _jit_run_tail_final(tail, dict(c=jnp.asarray(color)), out_h, out_w, out_h, out_w,
                               subsample, 1.6)
    np.testing.assert_array_equal(got.numpy(), want)
    planes = tailfuse.fused_tail_final(spec, out_h, out_w, out_h, out_w, 1, 1.6, quantize=False)
    assert planes.dtype == torch.bfloat16 and tuple(planes.shape) == (3, out_h, out_w)
    assert torch.equal(planes.float(), torch.from_numpy(color).permute(2, 0, 1))


def test_quantize_false_planes_match_jax():
    """K1's quantize=False form (its plain version) against the JAX fused
    kernel's quantize=False output in interpret mode: the three bf16 planes
    equal bit for bit (a tail of products, selects and a sqrt over its
    inputs: no a * b + c for XLA to contract, no division by a constant
    for it to fold)."""
    out_h, out_w = 40, 160
    raw = _inputs(out_h, out_w)

    def tail_for(where, sqrt):
        def tail(tp):
            r, g, b = tp.vec3("color")
            vig = tp.col("colv") * (1.0 - tp.row("rowv"))
            mask = tp.col("colv") * tp.col("colv") < tp.plane("gain")
            return r * tp.plane("gain") * vig, where(mask, g, b * 0.5), sqrt(b) * tp.scalar("vol")
        return tail

    spec = tailfuse.make_spec(tail_for(torch.where, torch.sqrt), out_h, out_w,
                              color=torch.from_numpy(raw["color"]),
                              gain=torch.from_numpy(raw["gain"]), vol=torch.tensor(raw["vol"]),
                              rowv=tailfuse.Row(torch.from_numpy(raw["rowv"])),
                              colv=tailfuse.Col(torch.from_numpy(raw["colv"])))
    jax_spec = jax_tailfuse.make_spec(tail_for(jnp.where, jnp.sqrt), out_h, out_w,
                                      color=jnp.asarray(raw["color"]),
                                      gain=jnp.asarray(raw["gain"]), vol=jnp.asarray(raw["vol"]),
                                      rowv=jax_tailfuse.Row(jnp.asarray(raw["rowv"])),
                                      colv=jax_tailfuse.Col(jnp.asarray(raw["colv"])))
    got = tailfuse.fused_tail_final(spec, out_h, out_w, out_h, out_w, 1, 4.0, quantize=False)
    want = jax_tailfuse.fused_tail_final(jax_spec, out_h, out_w, out_h, out_w, 1, 4.0,
                                         interpret=True, quantize=False, stack=False)
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert theirs.dtype.name == "bfloat16"
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(), theirs.view(np.int16))
    with pytest.raises(ValueError, match="s = 1"):
        tailfuse.fused_tail_final(spec, out_h, out_w, out_h // 2, out_w // 2, 2, 4.0,
                                  quantize=False)


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
    torch_fractals = _example("torch_fractals")
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


def _example(name: str):
    return _import_example("torch", name)


def _table_spec(render_h, render_w):
    """Table lookups, torch.remainder, zeros_like and a maximum on it."""
    table, index = _table_inputs(render_h, render_w)

    def tail(tp):
        k = tp.plane("k")
        wrapped = torch.remainder(k * 3.7, 5.0) + torch.remainder(-k, 2.5)
        floor = torch.maximum(torch.zeros_like(k), tp.lookup("pal", wrapped, 1) - 0.3)
        return tp.lookup("pal", k, 0), floor, wrapped * 0.1

    return tailfuse.make_spec(tail, render_h, render_w, k=torch.from_numpy(index),
                              pal=tailfuse.Table(torch.from_numpy(table)))


def _julia_spec(render_h, render_w):
    rng = np.random.default_rng(5)
    iters = torch.from_numpy(np.round(rng.random((render_h, render_w)) * 160).astype(np.float32))
    oob = torch.from_numpy((rng.random((render_h, render_w)) > 0.9).astype(np.float32))
    return tailfuse.make_spec(_example("torch_fractals").julia_tail(500), render_h, render_w,
                              iters=iters, oob=oob)


def _piano_spec(render_h, render_w):
    """The piano-roll tail over seeded column lines and scalars."""
    piano = _example("torch_piano_roll")
    rng = np.random.default_rng(6)
    cols = {}
    for slot in range(piano.MAX_SLOTS):
        start = rng.uniform(0.0, 3.0, render_w).astype(np.float32)
        cols[f"s{slot}a"] = start
        cols[f"s{slot}b"] = start + rng.uniform(0.0, 1.0, render_w).astype(np.float32)
        cols[f"s{slot}v"] = np.where(rng.random(render_w) > 0.3,
                                     rng.uniform(0.55, 1.0, render_w), 0.0).astype(np.float32)
        for c in "rgc":
            cols[f"s{slot}{c}"] = rng.random(render_w, np.float32)
    for name in ("edge", "glow", "isc", "kb0", "kb1", "kb2"):
        cols[name] = rng.random(render_w, np.float32)
    return tailfuse.make_spec(
        piano.piano_roll_tail, render_h, render_w,
        **{name: tailfuse.Col(torch.from_numpy(v)) for name, v in cols.items()},
        kbh=torch.tensor(0.275), rolltime=torch.tensor(2.0), time=torch.tensor(1.2))


@pytest.mark.parametrize("which", ["make_spec", "mandelbrot", "transcendental",
                                   "indexed_colsampled", "table", "julia", "piano"])
def test_traced_graph_equals_direct_call(which):
    """The expression graph K1 is generated from, evaluated with torch,
    equals the direct tail call bit for bit; the generated Triton source is
    valid Python and loads exactly the inputs the tail reads."""
    render_h, render_w = 24, 64
    spec = {"make_spec": lambda: _specs(render_h, render_w)[1],
            "mandelbrot": lambda: _mandelbrot_spec(render_h, render_w),
            "transcendental": lambda: _transcendental_spec(render_h, render_w),
            "indexed_colsampled": lambda: _sampled_specs(render_h, render_w, "bfloat16")[1],
            "table": lambda: _table_spec(render_h, render_w),
            "julia": lambda: _julia_spec(render_h, render_w),
            "piano": lambda: _piano_spec(render_h, render_w),
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
    env.update({("table", name, 0): value for name, value in spec.tables.items()})
    traced = torch.stack([torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32), shape)
                          for v in tailgen.evaluate(graph, outputs, env)], dim=-1)
    direct = tailfuse.eval_reference(spec, render_h, render_w, aspect)
    assert torch.equal(traced, direct)

    source, keys = tailgen.generate(graph, outputs, 2, frozenset(spec.colsampled))
    compile(source, "<generated K1>", "exec")
    planes_source, planes_keys = tailgen.generate(graph, outputs, 1, frozenset(spec.colsampled),
                                                  quantize=False)
    compile(planes_source, "<generated K1 (d)>", "exec")
    assert planes_keys == keys and "tl.bfloat16), mask=ok" in planes_source
    color = {("plane", "color", c) for c in range(3)}
    expected = {"make_spec": color | {("plane", "gain", 0), ("row", "rowv", 0),
                                      ("col", "colv", 0), ("scalar", "vol", 0)},
                "mandelbrot": {("plane", "iters", 0), ("col", "oob", 0)},
                "transcendental": color | {("col", "colv", 0), ("scalar", "vol", 0)},
                "indexed_colsampled": {("colsampled", "tex", c) for c in range(3)}
                | {("plane", "bar", 0), ("plane", "gain", 0)},
                "table": {("plane", "k", 0), ("table", "pal", 0)},
                "julia": {("plane", "iters", 0), ("plane", "oob", 0)},
                "piano": {("col", name, 0) for name in spec.cols}
                | {("scalar", name, 0) for name in ("kbh", "rolltime", "time")}}
    assert set(keys) == expected[which]
    if which == "indexed_colsampled":
        # one position load and one pair of bf16-rounded hat weights per
        # sub-position, shared by the three channels
        assert source.count("tl.load(pos0 + ci") == 1
        assert source.count(".to(tl.bfloat16).to(tl.float32)") == 2


_GRADED = {"make_spec": lambda h, w: _specs(h, w)[1],
           "mandelbrot": lambda h, w: _mandelbrot_spec(h, w),
           "transcendental": lambda h, w: _transcendental_spec(h, w),
           "indexed_colsampled": lambda h, w: _sampled_specs(h, w, "bfloat16")[1],
           "table": lambda h, w: _table_spec(h, w),
           "julia": lambda h, w: _julia_spec(h, w),
           "piano": lambda h, w: _piano_spec(h, w)}


@pytest.mark.parametrize("which", list(_GRADED))
def test_generated_template_loads_each_input_once(which):
    """K1's tile template for every graded tail: the source compiles as
    Python at s = 1, 2 and 3 and in the quantize=False form; each row,
    column and scalar input is loaded once a tile
    at its own rank (a row as [BH, 1], a column as [1, BWC], a scalar as a
    0-d value: no per-element loads of one address), constants are 0-d,
    and each plane channel is one block load a pass of render rows."""
    spec = _GRADED[which](24, 64)
    graph, outputs = tailgen.trace(spec, 24, 64, 1.5)
    for s in (1, 2, 3):
        source, keys = tailgen.generate(graph, outputs, s, frozenset(spec.colsampled))
        compile(source, f"<K1 {which} s={s}>", "exec")
        pointers = [k for k in keys if k[0] != "scalar"]
        for number, key in enumerate(pointers):
            kind, name = key[0], f"in{number}"
            if kind == "row":
                assert source.count(f"tl.load({name} + ri, mask=row_ok") == 1
            elif kind == "col":
                assert source.count(f"tl.load({name} + ci, mask=col_ok") == 1
            elif kind == "plane":
                assert source.count(f"tl.make_block_ptr({name}") == 1
        scalars = [k for k in keys if k[0] == "scalar"]
        for number in range(len(scalars)):
            assert source.count(f"tl.load(scalars + {number})") == 1
        assert "zero_i" not in source and "tl.full([BH" not in source
        assert ("tl.sum(tl.reshape(" in source) == (s == 2)
        assert ("for dx in tl.static_range(3)" in source) == (s == 3)
    source, _ = tailgen.generate(graph, outputs, 1, frozenset(spec.colsampled), quantize=False)
    compile(source, f"<K1 {which} quantize=False>", "exec")
    with pytest.raises(ValueError, match="quantize=False"):
        tailgen.generate(graph, outputs, 2, quantize=False)


@pytest.mark.parametrize("which", list(_GRADED))
def test_tile_rule_is_a_function_of_the_graph(monkeypatch, which):
    """The tile K1 runs (tailgen.tile_shape) follows from the graph's live
    values and s alone: 128 render columns a row of the render block, 4
    warps, and the most rows (8, 4, 2 or 1: the elements a thread holds of a
    plane value) whose live peak fits the register budget; the same graph
    gives the same tile at any render size, and a smaller budget a thinner
    tile."""
    s = 1 if which == "piano" else 2
    graph, outputs = tailgen.trace(_GRADED[which](24, 64), 24, 64, 1.5)
    rows, width, warps = tailgen.tile_shape(graph, outputs, s)
    again = tailgen.trace(_GRADED[which](40, 128), 40, 128, 1.5)
    assert tailgen.tile_shape(*again, s) == (rows, width, warps)
    assert width * s == tailgen.K1_COLUMNS and warps == tailgen.K1_WARPS
    assert rows in (1, 2, 4, 8)
    assert rows == 1 or tailgen.live_peak(graph, outputs, rows, s) <= tailgen.K1_REGISTERS
    assert rows == 8 or tailgen.live_peak(graph, outputs, rows * 2, s) > tailgen.K1_REGISTERS
    assert rows == {"make_spec": 8, "mandelbrot": 8, "transcendental": 4,
                    "indexed_colsampled": 2, "table": 8, "julia": 8, "piano": 4}[which]
    if rows > 1:
        monkeypatch.setattr(tailgen, "K1_REGISTERS",
                            tailgen.live_peak(graph, outputs, rows // 2, s))
        assert tailgen.tile_shape(graph, outputs, s) == (rows // 2, width, warps)


def _table_inputs(render_h, render_w):
    """A (12, 3) table and an index plane reaching below 0 and past the
    last bin (the clip), as numpy."""
    rng = np.random.default_rng(21)
    table = rng.random((12, 3), np.float32)
    index = rng.uniform(-3.0, 15.0, (render_h, render_w)).astype(np.float32)
    return table, index


def _table_tail(tp):
    k = tp.plane("k")
    return tp.lookup("pal", k, 0), tp.lookup("pal", k * 0.5, 2) * tp.astuv_x, tp.lookup("pal", k, 1)


def test_unported_input_kinds_raise():
    """Every input kind is ported now. The Table kind (a small (bins, C)
    table read by TailCtx.lookup: clip(trunc(index), 0, bins - 1), one
    channel) against the JAX package: the float planes equal its reference
    path (compiled, as its render runs it) exactly, and the u8 frames its
    fused kernel in interpret mode
    within one step; a 1-D table is one channel; Indexed still refuses an
    index that lives on a device (reading it back would stall the frame
    loop)."""
    out_h, out_w, s = 24, 40, 2
    render_h, render_w = out_h * s, out_w * s
    table, index = _table_inputs(render_h, render_w)
    spec = tailfuse.make_spec(_table_tail, render_h, render_w, k=torch.from_numpy(index),
                              pal=tailfuse.Table(torch.from_numpy(table)))
    jax_spec = jax_tailfuse.make_spec(_table_tail, render_h, render_w, k=jnp.asarray(index),
                                      pal=jax_tailfuse.Table(jnp.asarray(table)))
    aspect = out_w / out_h
    reference = jax.jit(lambda k, pal: jax_tailfuse.eval_reference(
        jax_tailfuse.make_spec(_table_tail, render_h, render_w, k=k,
                               pal=jax_tailfuse.Table(pal)), render_h, render_w, aspect))
    np.testing.assert_array_equal(
        tailfuse.eval_reference(spec, render_h, render_w, aspect).numpy(),
        np.asarray(reference(jnp.asarray(index), jnp.asarray(table))))
    got = tailfuse.fused_tail_final(spec, render_h, render_w, out_h, out_w, s, aspect)
    fused = jax_tailfuse.fused_tail_final(jax_spec, render_h, render_w, out_h, out_w, s,
                                          aspect, interpret=True)
    _assert_u8_close(got.numpy(), fused)
    one = tailfuse.make_spec(lambda tp: (tp.lookup("t", tp.plane("k")),) * 3, render_h,
                             render_w, k=torch.from_numpy(index),
                             t=tailfuse.Table(torch.from_numpy(table[:, 1])))
    assert tuple(one.tables["t"].shape) == (12, 1)
    assert torch.equal(tailfuse.eval_reference(one, render_h, render_w, 1.0)[..., 0],
                       tailfuse.eval_reference(spec, render_h, render_w, 1.0)[..., 2])
    device_index = tailfuse.Indexed(torch.ones(2, 8, 16), torch.zeros((), device="meta"))
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


def test_trace_cache_key():
    """K1 keeps a traced kernel per tail code, closure values and input
    structure (tailgen._tail_key): two closures of the same factory with
    equal values share it; another closure value, another input dtype or
    size, or a closure value the key cannot hash (traced every frame) do
    not."""
    fractals = _example("torch_fractals")
    h, w = 8, 16

    def key(fn, iters=None, size=(h, w)):
        iters = torch.zeros(size) if iters is None else iters
        return tailgen._tail_key(tailfuse.make_spec(fn, *size, iters=iters), *size, 2, 1.5)

    same = key(fractals.mandelbrot_tail(500, True))
    assert same is not None and same == key(fractals.mandelbrot_tail(500, True))
    assert same != key(fractals.mandelbrot_tail(400, True))
    assert same != key(fractals.mandelbrot_tail(500, True), torch.zeros(h, w, dtype=torch.bfloat16))
    assert same != key(fractals.mandelbrot_tail(500, True), size=(h, w + 2))
    opaque = object()
    assert key(lambda tp: (tp.plane("iters"), opaque, 0.0)) is None


# --------------------------------------------------------------------------- #
# K1 at every integer ratio r = render / out >= s (the subsample)

# sha256 of the graded tails' K1 sources at r = s (1 to 4) and in the
# quantize=False form, at 24x64: the sources the exact-pooling regime ran
# before the pool factor was a parameter, byte for byte
RATIO_EQUAL_SOURCES = "1f4c848526f6b987b29f4df0d7842dc463e88dc59b805348545a2809ed9fc33e"
RATIO_CASES = [("weights", (2, 1)), ("weights", (3, 2)), ("weights", (4, 2)),
               ("weights", (6, 2)), ("weights", (4, 4)), ("weights", (5, 4)),
               ("dispatch", "4-2"), ("dispatch", "3-2"), ("dispatch", "1.5"),
               ("dispatch", "0.5"), ("dispatch", "equal"), ("dispatch", "no_tailfuse"),
               ("source", "r=s"), ("source", "4-2"), ("source", "3-2")]
# dispatch cases: (render h, render w, out h, out w, subsample), whether K1's
# u8 form takes the frame
RATIO_DISPATCH = {"4-2": ((24, 40, 6, 10, 2), True), "3-2": ((18, 30, 6, 10, 2), True),
                  "1.5": ((9, 15, 6, 10, 2), False), "0.5": ((3, 5, 6, 10, 2), False),
                  "equal": ((6, 10, 6, 10, 2), False), "no_tailfuse": ((24, 40, 6, 10, 2), False)}


@pytest.mark.parametrize("kind,case", RATIO_CASES,
                         ids=[f"{kind}-{case if isinstance(case, str) else '-'.join(map(str, case))}"
                              for kind, case in RATIO_CASES])
def test_integer_ratio_regime(monkeypatch, kind, case):
    """K1 takes render == out * r for an integer r >= s. weights: the
    pool's per-axis weights (downsample.pool_weights) equal what the
    general final pass's plan puts in each output pixel's band, at 5x7
    output pixels, to the plan's float32 rounding. dispatch: run_tail_final sends r = 4 and 3 at s = 2 to
    K1's u8 form (on the CPU its plain version: the general final pass at
    s, the same frames as before), and not ssaa 1.5, ssaa 0.5, r = 1 < s
    (the planes form and the stencil) or anything under
    SHADERFLOW_NO_TAILFUSE. source: at r = s (and r = 2s) the pool is the
    box, whose source is pinned byte for byte; r = 4, s = 2 is the box at
    4; r = 3, s = 2 carries its weights as constants and no average."""
    from shaderflow_tpu_torch.ops import downsample
    if kind == "weights":
        r, s = case
        plan = downsample._general_plan(5 * r, 7 * r, 5, 7, s, torch.device("cpu"))
        assert plan.row_offsets is None and plan.col_offsets is None   # dense at this size
        weights = torch.tensor(downsample.pool_weights(r, s), dtype=torch.float32)
        for dense, out in ((plan.row_weights, 5), (plan.col_weights, 7)):
            want = torch.zeros(out, out * r)
            for i in range(out):
                want[i, i * r:(i + 1) * r] = weights
            # the plan's tap positions are float32 ((i + 0.5) / n moved by
            # the tap's offset, times the render size): a few ulps off the
            # rationals pool_weights works in
            torch.testing.assert_close(dense, want, rtol=0.0, atol=2e-6)
        assert (tailgen.pool_form(r, s) is None) == (r in (s, 2 * s))
        return
    if kind == "dispatch":
        (rh, rw, oh, ow, s), fused = RATIO_DISPATCH[case]
        if case == "no_tailfuse":
            monkeypatch.setenv("SHADERFLOW_NO_TAILFUSE", "1")
        plane = torch.from_numpy(np.random.default_rng(3).random((rh, rw), np.float32))
        spec = tailfuse.make_spec(
            lambda tp: (tp.plane("a"), tp.plane("a") * tp.astuv_x, 1.0 - tp.plane("a")),
            rh, rw, a=plane)
        calls = []
        fused_tail_final = tailfuse.fused_tail_final

        def spy(*args, **kwargs):
            calls.append(kwargs.get("quantize", True))
            return fused_tail_final(*args, **kwargs)

        monkeypatch.setattr(tailfuse, "fused_tail_final", spy)
        out = torch.empty((oh, ow, 3), dtype=torch.uint8)
        tailfuse.run_tail_final(spec, rh, rw, oh, ow, s, ow / oh, out=out)
        assert (True in calls) == fused
        assert tailfuse.supports_fusion(rh, rw, oh, ow, s) == (fused or case == "no_tailfuse")
        assert calls == ([False] if case == "equal" else [True] if fused else [])
        if case != "equal":
            assert torch.equal(out, tailfuse.tail_plain(spec, rh, rw, oh, ow, s, ow / oh))
        return
    digest = hashlib.sha256()
    for which, make in _GRADED.items():
        spec = make(24, 64)
        graph, outputs = tailgen.trace(spec, 24, 64, 1.5)
        for s in (1, 2, 3, 4):
            assert tailgen.pool_form(s, s) is None and tailgen.pool_form(2 * s, s) is None
            digest.update(tailgen.generate(graph, outputs, s, frozenset(spec.colsampled))[0]
                          .encode())
        digest.update(tailgen.generate(graph, outputs, 1, frozenset(spec.colsampled),
                                       quantize=False)[0].encode())
    if case == "r=s":
        assert digest.hexdigest() == RATIO_EQUAL_SOURCES
        return
    r, s = map(int, case.split("-"))
    spec = _mandelbrot_spec(24 * r, 64 * r)
    source, _, _, tile = tailgen._generated(spec, 24 * r, 64 * r, r, 1.5, True,
                                            tailgen.pool_form(r, s))
    graph, outputs = tailgen.trace(spec, 24 * r, 64 * r, 1.5)
    compile(source, f"<K1 r={r} s={s}>", "exec")
    if r == 4:
        assert source == tailgen.generate(graph, outputs, 4)[0]
        assert tile == tailgen.tile_shape(graph, outputs, 4) and tile[1] * 4 == tailgen.K1_COLUMNS
        assert tile[0] * 4 == tailgen.K1_RENDER_ROWS   # E = 4: the fractal's 8 halved
        assert "tl.sum(tl.reshape(" in source and "acc0 = acc0 * 0.0625" in source
        return
    assert tailgen.pool_form(3, 2) == (0.375, 0.25, 0.375)
    assert "tl.full([], 0.375, tl.float32)" in source and "tl.full([], 0.25, tl.float32)" in source
    assert source.count(" * wy * wx") == 3 and "if dy == 0:" in source and "if dx == 0:" in source
    assert "acc0 = acc0" not in source and "div_rn(acc" not in source
    assert "for dx in tl.static_range(3)" in source and tile[1] == tailgen.K1_COLUMNS // 2
