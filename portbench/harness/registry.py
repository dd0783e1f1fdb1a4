"""
Where the harness finds what a name in BENCHMARK.json stands for.

  configuration  portbench/configs/<config>.json   the scene, its options and inputs
  traffic mix    portbench/traffic/<traffic>.json  output size, supersampling, clips
  per-layer      portbench/metrics/<metric>.py      read(trace) -> number or None, and
                                                    SPANS, the port's calls it reads
  input kind     portbench/inputs/<kind>.py         make(...) -> ([paths], [data])
  reference      portbench/reference/<config>.py    the plain frames of a configuration

A later cell, configuration, input kind or metric, with the spans it
reads, is a new file here and an entry in BENCHMARK.json; nothing that
exists is edited.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str, benchmark: dict) -> dict:
    for cell in benchmark["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "configs" / f"{name}.json").read_text())


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def _module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(name: str, bench: Path = BENCH) -> ModuleType:
    return _module(bench / "reference" / f"{name}.py", f"portbench_reference_{name}")


def _label(prefix: str, name: str) -> str:
    return prefix + name.replace(".", "_").replace("-", "_")


def metric_module(name: str, bench: Path = BENCH) -> ModuleType:
    """The file of per-layer metric `name` (named after the metric, dots
    included)."""
    return _module(bench / "metrics" / f"{name}.py", _label("portbench_metric_", name))


def metric_reader(name: str, bench: Path = BENCH):
    """The read(trace) function of per-layer metric `name`."""
    return metric_module(name, bench).read


def spans(metric_names: list, bench: Path = BENCH) -> dict:
    """The spans these metrics read: {label: (module, owner or None,
    attribute)}, the union of each metric file's SPANS. Two files that
    give one label must give it the same call."""
    found: dict = {}
    for name in metric_names:
        for label, call in getattr(metric_module(name, bench), "SPANS", {}).items():
            call = tuple(call)
            if found.setdefault(label, call) != call:
                raise ValueError(f"span {label!r} of metric {name!r} is {call}, "
                                 f"elsewhere {found[label]}")
    return found


def input_maker(kind: str, bench: Path = BENCH):
    """The make(name, item, seed, directory, clip_seconds) of input kind `kind`."""
    path = bench / "inputs" / f"{kind}.py"
    if not path.exists():
        raise ValueError(f"unknown input kind {kind!r}: no {path}")
    return _module(path, _label("portbench_input_", kind)).make


def cell_metrics(cell_name: str, benchmark: dict, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that cell `cell_name` reports:
    those without a workloads list, and those whose list names it."""
    return [metric for metric in benchmark[kind]
            if cell_name in metric.get("workloads", [cell_name])]
