"""
Kernel builds: CUDA C++ sources compiled by nvcc into plain-C shared
libraries (bound with ctypes), and generated Triton sources written to
files (`@triton.jit` reads its function's source from a file).

Everything builds from the sources in this checkout, at first use, into
BUILD_DIR (gitignored); a library is rebuilt when its source is newer, and
ptxas's register/spill report is kept beside it (ptxas_report). A failed
build raises — there is no fallback to the plain PyTorch versions.
Processes sharing a checkout (a segmented export's, a user's two runs)
build under one file lock: the first builds, the others wait and load.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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


def cuda_sources() -> list[Path]:
    """Every CUDA C++ source of the package (csrc/*.cu)."""
    return sorted((Path(__file__).parent / "csrc").glob("*.cu"))


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def ptxas_report(source: Path) -> str:
    """nvcc's output when `source`'s library was built: ptxas's register
    and spill report (-Xptxas -v)."""
    return library_path(source).with_suffix(".ptxas.txt").read_text()


@contextlib.contextmanager
def build_lock():
    """An exclusive lock on BUILD_DIR/.lock for as long as the block runs
    (flock: released if the holder dies)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as handle:
        fcntl.flock(handle, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(handle, fcntl.LOCK_UN)


def _stale(sources) -> list[Path]:
    return [source for source in sources
            if not library_path(source).exists()
            or library_path(source).stat().st_mtime < source.stat().st_mtime]


def build_cuda_libraries(sources=None) -> list[str]:
    """Compile every missing or stale library at once: one nvcc per source,
    all started together, then wait for all; under the build lock, so a
    second process waits for the first's build instead of repeating it.
    Returns the names built."""
    sources = list(sources or cuda_sources())
    if not _stale(sources):
        return []
    with build_lock():
        stale = _stale(sources)
        if not stale:
            return []
        _compile(stale)
    return [source.stem for source in stale]


def _compile(stale: list[Path]) -> None:
    compiler = nvcc()
    jobs = []
    for source in stale:
        partial = library_path(source).with_suffix(f".{os.getpid()}.tmp")
        process = subprocess.Popen([compiler, *NVCC_FLAGS, "-o", str(partial), str(source)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
        jobs.append((source, partial, process))
    failures = []
    for source, partial, process in jobs:
        output = process.communicate()[0]
        if process.returncode != 0:
            failures.append(f"nvcc failed on {source}:\n{output}")
            continue
        library_path(source).with_suffix(".ptxas.txt").write_text(output.strip() + "\n")
        os.replace(partial, library_path(source))  # atomic: loaders see old or new
    if failures:
        raise RuntimeError("\n".join(failures))


def cuda_library(source: Path) -> ctypes.CDLL:
    """Compile (when missing or stale) and load lib<stem>.so for `source`."""
    name = source.stem
    if name not in _libraries:
        build_cuda_libraries([source])
        _libraries[name] = ctypes.CDLL(str(library_path(source)))
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
        with build_lock():
            partial = path.with_suffix(f".{os.getpid()}.tmp")
            partial.write_text(source)
            os.replace(partial, path)
    spec = importlib.util.spec_from_file_location(
        f"shaderflow_tpu_torch_generated.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _modules[name] = module
    return module
