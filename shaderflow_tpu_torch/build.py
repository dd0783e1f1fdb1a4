"""
Kernel builds: CUDA C++ sources compiled by nvcc into plain-C shared
libraries (bound with ctypes), and generated Triton sources written to
files (`@triton.jit` reads its function's source from a file).

Everything builds from the sources in this checkout, at first use, into
BUILD_DIR (gitignored); a library is rebuilt when its source is newer. A
failed build raises — there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path
from types import ModuleType

from shaderflow_tpu_torch import BUILD_DIR

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No FMA contraction: escape counts must equal the plain PyTorch
    # version's exactly, and a fused a*b+c moves boundary pixels' steps
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

build_log: dict[str, str] = {}
"""Library name -> nvcc's output (ptxas register/spill report) of the last
build in this process."""

_libraries: dict[str, ctypes.CDLL] = {}
_modules: dict[str, ModuleType] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels build on a machine with the CUDA toolkit")


def cuda_library(source: Path) -> ctypes.CDLL:
    """Compile (when missing or stale) and load lib<stem>.so for `source`."""
    name = source.stem
    if name in _libraries:
        return _libraries[name]
    library = BUILD_DIR / f"lib{name}.so"
    if not library.exists() or library.stat().st_mtime < source.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = library.with_suffix(f".{os.getpid()}.tmp")
        result = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)],
            capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{result.stdout}\n{result.stderr}")
        os.replace(partial, library)  # atomic: a concurrent loader sees old or new
        build_log[name] = (result.stdout + result.stderr).strip()
    _libraries[name] = ctypes.CDLL(str(library))
    return _libraries[name]


def triton_module(source: str, stem: str = "tail") -> ModuleType:
    """Import generated Triton source, cached by content hash."""
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    name = f"{stem}_{digest}"
    if name in _modules:
        return _modules[name]
    # Triton's compile cache too stays inside the checkout (not $HOME)
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton_cache"))
    directory = BUILD_DIR / "triton"
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{name}.py"
    if not path.exists() or path.read_text() != source:
        partial = path.with_suffix(f".{os.getpid()}.tmp")
        partial.write_text(source)
        os.replace(partial, path)
    spec = importlib.util.spec_from_file_location(
        f"shaderflow_tpu_torch_generated.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _modules[name] = module
    return module
