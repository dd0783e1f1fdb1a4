"""The benchmark's process: it runs the port without JAX, and a run that
finds no card, or a switch of the port set, fails and prints no result."""

import json
import os
import subprocess
import sys
import textwrap
import types

from portbench.harness import registry

RUN = registry.ROOT / "portbench" / "run.py"


def test_forbidden_modules_are_named_by_top_level_name(monkeypatch):
    sys.path.insert(0, str(RUN.parent))
    import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "shaderflow_tpu.ops", types.ModuleType("shaderflow_tpu.ops"))
    assert run.forbidden_modules() == ["jax", "shaderflow_tpu"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.delitem(sys.modules, "shaderflow_tpu.ops")
    names = run.forbidden_modules()
    assert "shaderflow_tpu_torch" not in names


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    script = textwrap.dedent(f"""
        import sys, time, json
        sys.path.insert(0, {str(tiny_root)!r})
        sys.path.insert(0, {str(RUN.parent)!r})
        from pathlib import Path
        from portbench.harness import cell
        import run
        out = cell.run("visualizer.tiny", 5, 2.0, False, process_start=time.perf_counter(),
                       device="cpu", root=Path({str(tiny_root)!r}))
        print(json.dumps([run.forbidden_modules(), sorted(m for m in sys.modules
                                                          if m.startswith("shaderflow"))[:3]]))
    """)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    forbidden, port = json.loads(done.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert port and all(name.startswith("shaderflow_tpu_torch") for name in port)


def _run(args, env=None, cwd=None):
    environment = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})}
    return subprocess.run([sys.executable, str(RUN), *args], capture_output=True, text=True,
                          timeout=600, env=environment, cwd=cwd)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except json.JSONDecodeError:
            continue
    return False


ARGS = ["--workload", "visualizer.1080p-ssaa2", "--seed", "3000000000", "--seconds", "1",
        "--trace", "0"]


def test_no_card_fails_without_a_result():
    done = _run(ARGS)
    assert done.returncode != 0
    assert not _has_result(done.stdout)
    assert "CUDA" in done.stderr


def test_a_switch_of_the_port_is_refused():
    done = _run(ARGS, env={"SKIP_TPU": "1"})
    assert done.returncode == 2
    assert not _has_result(done.stdout)


def test_the_benchmark_alone_fails_without_a_result(tmp_path):
    import shutil
    shutil.copytree(registry.ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = subprocess.run([sys.executable, "portbench/run.py", *ARGS], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert done.returncode != 0
    assert not _has_result(done.stdout)
