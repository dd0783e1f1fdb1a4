"""
The benchmark of shaderflow_tpu_torch on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (harness/cell.py) and prints, as the last
line of standard output, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the compared numbers
beside their limits, which also end standard error. Without a CUDA card,
with a run-time switch of the port set, or with jax or the JAX package
loaded at the end, it exits with another code than 0 and prints no result.
Kernel builds and Triton's cache stay in the checkout's build/ directory.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "shaderflow_tpu")
SWITCHES = ("SHADERFLOW_PIPELINE_DEPTH", "SHADERFLOW_BATCH_TRACE", "SHADERFLOW_NO_TAILFUSE",
            "SKIP_TPU", "SHADERFLOW_REF_SLOT0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (shaderflow_tpu_torch is not shaderflow_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    inherited = [name for name in SWITCHES if name in os.environ]
    if inherited:
        print(f"portbench: {', '.join(inherited)} set; the benchmark measures the "
              "default path", file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "shaderflow_tpu_torch" / "triton_cache")
    os.environ.setdefault("SHADERFLOW_AUDIO_BACKEND", "none")
    sys.path.insert(0, str(ROOT))

    import torch
    from portbench.harness import registry

    chips = registry.workload(args.workload, registry.load_benchmark(ROOT))["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.zeros(1, device="cuda")

    from portbench.harness import cell
    outcome = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       process_start=PROCESS_START, device="cuda", root=ROOT)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: loaded {', '.join(loaded)}; the benchmark runs the port "
              "without JAX", file=sys.stderr)
        return 3
    for line in outcome["notes"] + outcome["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
