"""
Kernel builds: CUDA C++ sources compiled by nvcc into plain-C shared
libraries (bound with ctypes), and generated Triton sources written to
files (`@triton.jit` reads its function's source from a file); the host
C++ of the frame pump (io/framepump.cpp) compiled by g++ the same way.

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
import time
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

# The host C++ libraries (io/framepump.cpp): g++, linked with pthreads
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libraries: dict[str, ctypes.CDLL] = {}
_modules: dict[str, ModuleType] = {}
# Every build of this process: (source file names, "nvcc" / "g++" / "triton",
# wall seconds). An nvcc entry is one batch of sources compiled in parallel
# (their names joined by spaces, the batch's wall); a Triton entry is the
# first launch of a generated kernel (ops/tailgen.py: its JIT compile, or
# its load from Triton's cache)
build_events: list[tuple[str, str, float]] = []


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
    started = time.perf_counter()
    for source in stale:
        partial = library_path(source).with_suffix(f".{os.getpid()}.tmp")
        process = subprocess.Popen([compiler, *NVCC_FLAGS, "-o", str(partial), str(source)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
        jobs.append((source, partial, process))
    failures = []
    outputs = [process.communicate()[0] for _, _, process in jobs]
    build_events.append((" ".join(source.name for source in stale), "nvcc",
                         time.perf_counter() - started))
    for (source, partial, process), output in zip(jobs, outputs):
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


def cxx_library(source: Path) -> ctypes.CDLL:
    """Compile (when missing or stale) with g++ and load lib<stem>.so for a
    host C++ `source`, under the build lock; a failed build raises."""
    name = source.stem
    if name not in _libraries:
        if _stale([source]):
            with build_lock():
                if _stale([source]):
                    _compile_host(source)
        _libraries[name] = ctypes.CDLL(str(library_path(source)))
    return _libraries[name]


def _compile_host(source: Path) -> None:
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(f"g++ not found on PATH: {source.name} builds with a C++ compiler")
    partial = library_path(source).with_suffix(f".{os.getpid()}.tmp")
    started = time.perf_counter()
    process = subprocess.run([compiler, *CXX_FLAGS, "-o", str(partial), str(source),
                              "-lpthread"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    build_events.append((source.name, "g++", time.perf_counter() - started))
    if process.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source}:\n{process.stdout}")
    os.replace(partial, library_path(source))  # atomic: loaders see old or new


def triton_name(source: str, stem: str = "tail") -> str:
    """The module name of generated Triton source: stem and content hash."""
    return f"{stem}_{hashlib.sha256(source.encode()).hexdigest()[:16]}"


def triton_module(source: str, stem: str = "tail") -> ModuleType:
    """Import generated Triton source, cached by content hash."""
    name = triton_name(source, stem)
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
