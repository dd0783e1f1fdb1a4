"""Kernel K3's CUDA C++ source (shaderflow_tpu_torch/csrc/escape.cu)
compiled as host C++ and held against the plain loop on the CPU.

The kernel's per-thread code is plain C++, so the escape loop's logic (the
exit branches every few steps, the count worked out from where the loop
left, the trip's remainder, the interior and z0 shortcuts, the pair and
strided loads, the warp tiles of a block) can run here, where there is no
card: a small header maps the CUDA names the source uses (the _rn
intrinsics, blockIdx and threadIdx, float2, cudaGetLastError) onto host
code, and the launch becomes a host loop over the grid, one thread at a
time. Built with -ffp-contract=off (no FMA, like nvcc's -fmad=false), each
f32 operation rounds once, as on the card. Each form is checked through
the C entry points, called with ctypes on numpy buffers, against
ops/fractal.py's escape_lines_plain and escape_plain: exactly equal.

The card runs the same source: tests/test_torch_cuda.py. Skips where no
C++ compiler is installed.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from shaderflow_tpu_torch.ops import fractal

SOURCE = Path(fractal.__file__).resolve().parent.parent / "csrc" / "escape.cu"

HOST_HEADER = r"""
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(threads)
#define __restrict__ __restrict
struct float2 { float x, y; };
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class Kernel, class... Args>
void host_launch(dim3 grid, unsigned threads, Kernel kernel, Args... args) {
    gridDim = grid;
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx)
            for (unsigned t = 0; t < threads; ++t) {
                blockIdx = dim3(bx, by);
                threadIdx = dim3(t);
                kernel(args...);
            }
}
"""

FORMS = ["lines", "mandelbrot", "julia", "cplanes"]

CASES = ["ragged", "one_pixel", "trip0", "trip1", "cap13", "nan_inf", "all_interior",
         "all_escaping", "odd_base", "reentry", "view"]


def _compiler():
    return shutil.which("g++") or shutil.which("c++")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The host library, compiled once for the module."""
    compiler = _compiler()
    if compiler is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    directory = tmp_path_factory.mktemp("escape_host")
    text = SOURCE.read_text()
    text, includes = re.subn(r"#include <cuda_runtime\.h>", HOST_HEADER, text)
    text, launches = re.subn(r"(escape_kernel<[^>]*>)<<<(\w+), (\w+), 0, (\w+)>>>\(",
                             r"host_launch(\2, \3, \1, ", text)
    assert includes == 1 and launches >= 1, "escape.cu's include or launch changed shape"
    host_source = directory / "escape_host.cpp"
    host_source.write_text(text)
    path = directory / "libescape_host.so"
    subprocess.run([compiler, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared",
                    "-o", str(path), str(host_source)],
                   check=True, capture_output=True, timeout=300)
    handle = ctypes.CDLL(str(path))
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    handle.escape_lines.argtypes = [pointer, pointer, pointer, integer, integer, integer,
                                    integer, integer, ctypes.c_float, pointer]
    handle.escape_planes.argtypes = [
        pointer, pointer, ctypes.c_longlong, pointer, pointer, ctypes.c_longlong, integer,
        pointer, integer, pointer, integer, ctypes.c_longlong, integer, integer, integer,
        ctypes.c_float, pointer]
    return handle


def _operands(case):
    """(cx line, cy line, max_iter, cap, Julia c) of a case: the edge cases
    of tests/test_torch_cuda.py, and a Mandelbrot view at 135 x 240 with the
    slice's cap (142) and Julia's (290)."""
    if case == "view":
        cx = np.linspace(-2.6, 1.3, 240, dtype=np.float32)
        cy = np.linspace(-1.1, 1.1, 135, dtype=np.float32)
        return cx, cy, 500, 142, (-0.644, 0.156)
    rng = np.random.default_rng(21)
    height, width = {"ragged": (37, 1001), "one_pixel": (1, 1)}.get(case, (40, 67))
    x_range, y_range = {"all_interior": ((-0.4, 0.1), (-0.25, 0.25)),
                        "all_escaping": ((3.1, 5.0), (-1.0, 1.0)),
                        "reentry": ((-2.0, -1.7), (-0.2, 0.2))}.get(
                            case, ((-2.2, 1.0), (-1.3, 1.3)))
    cx = np.sort(rng.uniform(*x_range, width)).astype(np.float32)
    cy = np.sort(rng.uniform(*y_range, height)).astype(np.float32)
    if case == "nan_inf":
        cx[[3, 17, 40]] = [np.nan, np.inf, -np.inf]
        cy[[5, 30]] = [-np.inf, np.nan]
    cap = {"trip0": 0, "trip1": 1, "cap13": 13}.get(case)
    julia_c = (-6.5, 0.3) if case == "reentry" else (-0.78, 0.151)
    return cx, cy, 200, cap, julia_c


def _field(cx, cy, odd_base: bool) -> np.ndarray:
    """The (H, W, 2) c field of two lines; at an odd float offset into its
    buffer (not 8-byte aligned) when asked."""
    grid = np.stack(np.broadcast_arrays(cx[None, :], cy[:, None]), -1).astype(np.float32)
    if not odd_base:
        return np.ascontiguousarray(grid)
    storage = np.zeros(grid.size + 2, np.float32)
    offset = 1 if storage.ctypes.data % 8 == 0 else 2
    field = storage[offset:offset + grid.size].reshape(grid.shape)
    field[...] = grid
    assert field.ctypes.data % 8 == 4
    return field


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", FORMS)
def test_escape_source_matches_plain_on_host(library, form, case):
    """Each form of escape.cu, built for the host, in int32 and float32:
    `lines`; `mandelbrot`, z0 == c planes (8-byte pairs, or scalar loads at
    an odd base); `julia`, a 0-d c; `cplanes`, c planes with an interior
    plane. Counts exactly equal to the plain loop's."""
    cx, cy, max_iter, cap, julia_c = _operands(case)
    caps = [cap, 290] if case == "view" else [cap]
    height, width = cy.size, cx.size
    field = _field(cx, cy, case == "odd_base")
    zx, zy = (torch.from_numpy(field[..., i].copy()) for i in (0, 1))
    interior = fractal._interior_mask(zx, zy)
    interior_plane = np.ascontiguousarray(interior.numpy())
    c_planes = np.ascontiguousarray(np.flip(field, -1) * np.float32(0.7)
                                    + np.array(julia_c, np.float32) * np.float32(0.1))
    julia = np.array(julia_c, np.float32)
    planes = torch.from_numpy(c_planes)
    base, r2 = field.ctypes.data, ctypes.c_float(9.0)
    for cap in caps:
        trip = max_iter if cap is None else min(max_iter, cap)
        for dtype, f32 in ((torch.int32, 0), (torch.float32, 1)):
            out = np.zeros((height, width), np.float32 if f32 else np.int32)
            if form == "lines":
                status = library.escape_lines(cx.ctypes.data, cy.ctypes.data, out.ctypes.data,
                                              f32, height, width, max_iter, trip, r2, None)
                want = fractal.escape_lines_plain(torch.from_numpy(cx), torch.from_numpy(cy),
                                                  max_iter, 3.0, cap, dtype)
            elif form == "mandelbrot":
                status = library.escape_planes(base, base + 4, 2, None, None, 1, 0, None, 1,
                                               out.ctypes.data, f32, height * width, width,
                                               max_iter, trip, r2, None)
                want = fractal.escape_plain(zx, zy, zx, zy, max_iter, 3.0, interior=interior,
                                            saturate=cap, out_dtype=dtype)
            elif form == "julia":
                status = library.escape_planes(base, base + 4, 2, julia.ctypes.data,
                                               julia.ctypes.data + 4, 1, 2, None, 0,
                                               out.ctypes.data, f32, height * width, width,
                                               max_iter, trip, r2, None)
                want = fractal.escape_plain(zx, zy, torch.tensor(julia[0]),
                                            torch.tensor(julia[1]), max_iter, 3.0, saturate=cap,
                                            out_dtype=dtype)
            else:
                status = library.escape_planes(base, base + 4, 2, c_planes.ctypes.data,
                                               c_planes.ctypes.data + 4, 2, 1,
                                               interior_plane.ctypes.data, 2, out.ctypes.data,
                                               f32, height * width, width, max_iter, trip, r2,
                                               None)
                want = fractal.escape_plain(zx, zy, planes[..., 0], planes[..., 1], max_iter,
                                            3.0, interior=interior, saturate=cap,
                                            out_dtype=dtype)
            assert status == 0
            got = torch.from_numpy(out)
            assert got.dtype == dtype
            assert torch.equal(got, want), (cap, dtype)
    if case == "view":
        assert len(torch.unique(want)) > 20


def test_escape_source_rejects_what_it_does_not_take(library):
    """escape_planes returns cudaErrorInvalidValue (1) for a c kind and an
    interior kind that do not go together, and for a width that does not
    divide the pixel count; it launches nothing for n == 0."""
    field = np.zeros((4, 6, 2), np.float32)
    out = np.zeros((4, 6), np.int32)
    base, r2 = field.ctypes.data, ctypes.c_float(9.0)
    common = (out.ctypes.data, 0)
    assert library.escape_planes(base, base + 4, 2, None, None, 1, 0, None, 0, *common,
                                 24, 6, 10, 10, r2, None) == 1
    assert library.escape_planes(base, base + 4, 2, None, None, 1, 0, None, 1, *common,
                                 24, 5, 10, 10, r2, None) == 1
    assert library.escape_planes(base, base + 4, 2, None, None, 1, 0, None, 1, *common,
                                 0, 6, 10, 10, r2, None) == 0


def test_escape_source_covers_more_rows_than_one_grid(library):
    """A field taller than 65535 blocks of 8 rows (the grid's y limit):
    the blocks take turns down the rows, and every count still equals the
    plain loop's."""
    height = 65535 * 8 + 37
    cy = np.linspace(-1.2, 1.2, height, dtype=np.float32)
    cx = np.array([-0.74], np.float32)
    out = np.full((height, 1), -1, np.int32)
    status = library.escape_lines(cx.ctypes.data, cy.ctypes.data, out.ctypes.data, 0, height,
                                  1, 60, 60, ctypes.c_float(9.0), None)
    assert status == 0
    want = fractal.escape_lines_plain(torch.from_numpy(cx), torch.from_numpy(cy), 60, 3.0)
    assert torch.equal(torch.from_numpy(out), want)
