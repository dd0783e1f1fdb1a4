"""The port's PSNR gate (examples/torch/psnr_gate.py) on the CPU, against
the JAX package's (tools/psnr_gate.py):

  * its frames for the Mandelbrot, visualizer and Tetration oracle configs
    (render_frames with device="cpu": the plain versions) against the JAX
    gate's render_frames at the same configs, run in a child on XLA:CPU
    without FMA: within 1 u8 step on < 1 % of values, Tetration held to
    its own bar; each port row and each JAX row (the JAX gate's own
    worker_oracle) passes its bar against the one GL oracle;
  * the FUSED-vs-REF rows' two routes on the CPU (the plain K1 version
    against the same frames' tails through the reference route,
    SHADERFLOW_NO_TAILFUSE=1);
  * a row under its bar fails the gate (exit 1), and the default device
    without a card raises.

On the card: chip_smoke.py phase 48."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ("mandelbrot (escape kernel + fused tail)", "visualizer (flagship, blur level 4)",
           "tetration (binary k)")

JAX_SCRIPT = """
import json, sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture
_fix_reference_texture(pytest.MonkeyPatch())
sys.path.insert(0, TOOLS)
import psnr_gate
for index, name in enumerate(NAMES):
    frames, _, _ = psnr_gate.render_frames(*psnr_gate.ORACLE_CONFIGS[name])
    np.save(f"{TMP}/jax_{index}.npy", np.asarray(frames))
    psnr_gate.worker_oracle(name)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small torch ops a frame, beside other test workers:
    one intra-op thread (as tests/test_torch_scenes.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gate():
    return _import_example("torch", "psnr_gate")


@pytest.fixture(scope="module")
def runs(gate, tmp_path_factory):
    """The JAX gate's frames and rows (one child, started first), and the
    port's frames and rows, rendered meanwhile."""
    tmp = tmp_path_factory.mktemp("gate")
    script = (f"TESTS, TOOLS, TMP = {str(REPO / 'tests')!r}, {str(REPO / 'tools')!r}, "
              f"{str(tmp)!r}\nNAMES = {CONFIGS!r}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    child = subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    for name in CONFIGS:
        frames, uniforms, scene = gate.render_frames(*gate.ORACLE_CONFIGS[name], device="cpu")
        results = [gate.oracle_frame(*task)
                   for task in gate.oracle_tasks(name, frames, uniforms, scene)]
        port[name] = (frames, gate.oracle_row(name, results))
    stdout, stderr = child.communicate(timeout=600)
    assert child.returncode == 0, stderr[-4000:]
    jax_rows = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    return {name: dict(port_frames=port[name][0], port_row=port[name][1],
                       jax_frames=np.load(tmp / f"jax_{index}.npy"), jax_row=jax_rows[index])
            for index, name in enumerate(CONFIGS)}


@pytest.mark.parametrize("name", CONFIGS)
def test_gate_frames_match_the_jax_gate(gate, runs, name):
    """The port's gate frames against the JAX gate's, same config: within
    1 u8 step on < 1 % of values; Tetration at its own bar (>= 0.99 of
    pixels within 2 steps, or >= 0.98 with <= 5 % of flips off the JAX
    frame's escape boundary)."""
    got, want = runs[name]["port_frames"], runs[name]["jax_frames"]
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{name}: max {diff.max()} u8 steps, {(diff > 0).mean():.4%} of values differ")
    if name in gate.CHAOTIC_CONFIGS:
        for frame, reference in zip(got, want):
            agree, stray = gate.agreement(frame, reference, chaotic=True)
            assert gate.passes("oracle/agree", name, agree, stray), (agree, stray)
        return
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("name", CONFIGS)
def test_port_row_passes_the_jax_rows_bar(gate, runs, name):
    """Each row against the one oracle: the port's and the JAX gate's
    (its worker_oracle) pass the same bar."""
    kind, _, value, extra, _ = runs[name]["port_row"]
    jax_row = runs[name]["jax_row"]
    print(f"{name}: port {value:.5f} ({extra}), JAX {jax_row['value']} "
          f"({jax_row.get('stray')}) [{jax_row['metric']}]")
    assert kind == f"oracle/{jax_row['metric']}"
    assert gate.passes(kind, name, jax_row["value"], jax_row.get("stray"))
    assert gate.passes(kind, name, value, extra)


@pytest.mark.parametrize("name", sorted(
    ["visualizer 1920x1080 ssaa=2 (graded)", "mandelbrot 1920x1080 ssaa=2 (graded)"]))
def test_oracle_strips_equal_the_whole_frame(gate, monkeypatch, name):
    """A graded config's oracle fragment (here at 64x36, 2x SSAA) in five
    uneven row strips, as the gate spreads it over its pool, assembles
    bit-equal to the oracle's own fragment over the whole grid, and the
    frame scores the same row; gl_oracle.coords is restored after."""
    key, _, _, ssaa, subsample, _, kwargs = gate.ORACLE_CONFIGS[name]
    assert name in gate.GRADED_CONFIGS
    monkeypatch.setitem(gate.ORACLE_CONFIGS, name, (key, 64, 36, ssaa, subsample, 1, kwargs))
    frames, uniforms, scene = gate.render_frames(*gate.ORACLE_CONFIGS[name], device="cpu")
    task, = gate.oracle_tasks(name, frames, uniforms, scene)
    _, key, _, uniform, textures, render_size, _, _, _, aspect = task
    oracle = gate.oracle_module()
    coords = oracle.coords
    fragment = {"visualizer": lambda: oracle.visualizer_fragment(uniform, *render_size, aspect,
                                                                 textures),
                "mandelbrot": lambda: oracle.mandelbrot_fragment(uniform, *render_size,
                                                                 aspect)}[key]
    rows = gate.strip_rows(render_size[1], 5)
    assert len(rows) == 5 and rows[0][0] == 0 and rows[-1][1] == render_size[1] == 72
    strips = [gate.oracle_strip(key, uniform, textures, render_size, aspect, band)
              for band in rows]
    assert oracle.coords is coords
    np.testing.assert_array_equal(np.concatenate([render for render, _ in strips]), fragment())
    assert gate.oracle_frame(*task, strips=strips)["psnr"] == gate.oracle_frame(*task)["psnr"]


@pytest.mark.parametrize("name", ["pianoroll", "tetration"])
def test_fused_and_reference_routes_on_the_cpu(gate, name):
    """A FUSED-vs-REF row's two routes on the CPU: the frames of the default
    route (K1's plain version on CPU tensors) against their captured tails
    through the reference route (SHADERFLOW_NO_TAILFUSE=1: eval_reference
    and the plain final pass): one call a frame, >= 40 dB; and the
    reference route is the one a whole CPU run under the switch takes."""
    config = gate.FUSED_CONFIGS[name]
    with gate.TailCapture() as capture:
        fused, _, _ = gate.render_frames(*config, device="cpu")
    assert len(capture.calls) == len(fused)
    reference = capture.reference()
    kind, _, value, step, _ = gate.pair_row("fused-vs-ref", name, fused, reference)
    print(f"{name}: {value:.1f} dB, max {step} u8 steps")
    assert gate.passes(kind, name, value, step)
    with gate.reference_route():
        whole, _, _ = gate.render_frames(*config, device="cpu")
    np.testing.assert_array_equal(whole, reference)


@pytest.mark.parametrize("offset,code", [(1, 0), (3, 1)])
def test_a_row_under_its_bar_fails_the_gate(gate, tmp_path, capsys, offset, code):
    """A frame off by `offset` u8 steps everywhere against its reference:
    one step is 48.13 dB, above the 40 dB bar; three steps are 38.59 dB,
    under it, and the gate exits 1 (also for an agreement row, where no
    pixel is within 2 steps)."""
    rng = np.random.default_rng(0)
    frame = rng.integers(10, 240, (2, 18, 32, 3), dtype=np.uint8)
    rows = [gate.pair_row("fused-vs-ref", "julia", frame + np.uint8(offset), frame)]
    agree, stray = gate.agreement(frame[0] + np.uint8(offset), frame[0], chaotic=False)
    rows.append(("oracle/agree", "waveform (binary thresholds)", agree, None, 0.0))
    assert gate.report(rows, "test", tmp_path / "gate.md") == code
    shown = capsys.readouterr().out
    assert f"{20 * np.log10(255 / offset):.1f} dB" in shown
    assert ("GATE" not in shown) and (tmp_path / "gate.md").read_text() in shown


def test_the_card_without_a_card_raises(gate):
    """The gate renders on the card by default: without one it raises
    before rendering anything (--cpu is the smoke run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        gate.run("cuda")
    with pytest.raises(Exception):
        gate.render_frames(*gate.ORACLE_CONFIGS["tetration (binary k)"], device="cuda")
