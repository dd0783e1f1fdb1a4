// Kernel K3: escape-time iteration counts, in two forms.
//
// Replaces shaderflow_tpu/ops/fractal.py:_escape_pallas, the Pallas TPU
// kernel behind escape_iterations_sep (lines=True: escape_lines below) and
// escape_iterations / escape_iterations_z0 (plane operands: escape_planes).
// Counts are defined by the reference loop _escape_xla (fractal.py:40-63)
// and held exactly equal to its PyTorch port, ops/fractal.py:escape_plain.
//
// Lines form: c[i, j] = (cx_line[j], cy_line[i]); z0 = c. Planes form: z0
// per pixel, and c either z0 itself (the Mandelbrot form), two planes, or
// two 0-d device values read through a pointer (the Julia form: a c that
// depends on iTime stays on the device, no host sync per frame).
// Pixels inside the main cardioid or the period-2 bulb report max_iter
// without iterating (the _interior_mask test, same expression order),
// computed in-kernel from c when z0 == c, or read from a bool plane.
// Otherwise
//   while count < trip and not |z|^2 > r^2:  z <- z^2 + c; count += 1
// with trip = min(max_iter, saturate).
//
// Bound on this card: f32 ALU work per escape step (about 8 flops, the
// serial z -> z^2 chain). One thread per pixel, a warp on 32 neighbouring
// columns of one row: escape times are spatially coherent, so a warp's
// lanes leave the loop at nearly the same step and the warp retires when
// its last lane escapes — the early exit the TPU kernel got from
// per-sub-block while loops. Inputs are two lines (bytes are negligible);
// the one store per pixel is the only device-memory traffic that scales.
//
// The planes form reads up to four f32 planes per pixel (8 to 16 bytes) and
// writes one count; it runs one thread per pixel in a 1-D grid, so a warp
// covers 32 neighbouring pixels of a row and retires with its last lane.
//
// Every product and sum uses the _rn intrinsics (and the library is built
// with -fmad=false): an FMA rounds a*b+c once instead of twice and moves
// chaotic boundary pixels' escape step, which would break exact equality.

#include <cuda_runtime.h>

// _interior_mask: q(q + (x - 1/4)) <= y^2/4 (cardioid),
// (x + 1)^2 + y^2 <= 1/16 (bulb)
__device__ __forceinline__ bool interior(float cx, float cy) {
    const float xq = __fsub_rn(cx, 0.25f);
    const float cy2 = __fmul_rn(cy, cy);
    const float q = __fadd_rn(__fmul_rn(xq, xq), cy2);
    const bool cardioid = __fmul_rn(q, __fadd_rn(q, xq)) <= __fmul_rn(0.25f, cy2);
    const float xp = __fadd_rn(cx, 1.0f);
    const bool bulb = __fadd_rn(__fmul_rn(xp, xp), cy2) <= 0.0625f;
    return cardioid || bulb;
}

// Steps from z0 until |z|^2 > r2 or `trip` steps -> the step count.
__device__ __forceinline__ int escape_count(float zx, float zy, float cx, float cy,
                                            int trip, float r2) {
    float x2 = __fmul_rn(zx, zx);
    float y2 = __fmul_rn(zy, zy);
    int count = 0;
    // !(m > r2), not m <= r2: a NaN |z|^2 keeps counting, as the
    // reference's `escaped |= m > r2` does
    while (count < trip && !(__fadd_rn(x2, y2) > r2)) {
        // reference order: ny = 2.0 * zx * zy + cy (left to right),
        // nx = zx * zx - zy * zy + cx
        const float ny = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zx), zy), cy);
        zx = __fadd_rn(__fsub_rn(x2, y2), cx);
        zy = ny;
        x2 = __fmul_rn(zx, zx);
        y2 = __fmul_rn(zy, zy);
        ++count;
    }
    return count;
}

template <typename Out>
__global__ void escape_lines_kernel(const float* __restrict__ cx_line,
                                    const float* __restrict__ cy_line,
                                    Out* __restrict__ out,
                                    int height, int width,
                                    int max_iter, int trip, float r2) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= height || j >= width) {
        return;
    }
    const float cx = cx_line[j];
    const float cy = cy_line[i];
    const int count = interior(cx, cy) ? max_iter : escape_count(cx, cy, cx, cy, trip, r2);
    out[static_cast<long long>(i) * width + j] = static_cast<Out>(count);
}

// Plain C entry point (bound with ctypes). `out` is (height, width),
// row-major, float32 when out_f32 != 0 else int32. Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (0 on success).
extern "C" int escape_lines(const void* cx_line, const void* cy_line,
                            void* out, int out_f32, int height, int width,
                            int max_iter, int trip, float r2, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((width + block.x - 1) / block.x,
                    (height + block.y - 1) / block.y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* cx = static_cast<const float*>(cx_line);
    const float* cy = static_cast<const float*>(cy_line);
    if (out_f32) {
        escape_lines_kernel<float><<<grid, block, 0, s>>>(
            cx, cy, static_cast<float*>(out), height, width, max_iter, trip, r2);
    } else {
        escape_lines_kernel<int><<<grid, block, 0, s>>>(
            cx, cy, static_cast<int*>(out), height, width, max_iter, trip, r2);
    }
    return static_cast<int>(cudaGetLastError());
}

// c_kind values of escape_planes
enum { C_IS_Z0 = 0, C_PLANES = 1, C_SCALARS = 2 };
// interior_kind values of escape_planes
enum { INTERIOR_NONE = 0, INTERIOR_FROM_C = 1, INTERIOR_PLANE = 2 };

template <typename Out>
__global__ void escape_planes_kernel(const float* __restrict__ zx0,
                                     const float* __restrict__ zy0, long long z_stride,
                                     const float* __restrict__ cxp,
                                     const float* __restrict__ cyp, long long c_stride,
                                     int c_kind,
                                     const bool* __restrict__ interior_plane,
                                     int interior_kind,
                                     Out* __restrict__ out, long long n,
                                     int max_iter, int trip, float r2) {
    const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (k >= n) {
        return;
    }
    const float zx = zx0[k * z_stride];
    const float zy = zy0[k * z_stride];
    float cx = zx;
    float cy = zy;
    if (c_kind == C_PLANES) {
        cx = cxp[k * c_stride];
        cy = cyp[k * c_stride];
    } else if (c_kind == C_SCALARS) {
        cx = *cxp;
        cy = *cyp;
    }
    bool inside = false;
    if (interior_kind == INTERIOR_FROM_C) {
        inside = interior(cx, cy);
    } else if (interior_kind == INTERIOR_PLANE) {
        inside = interior_plane[k];
    }
    const int count = inside ? max_iter : escape_count(zx, zy, cx, cy, trip, r2);
    out[k] = static_cast<Out>(count);
}

// Plain C entry point (bound with ctypes). z0 is read at zx0[k * z_stride],
// zy0[k * z_stride] for the k-th pixel of `n` (row-major); c per c_kind:
// C_IS_Z0 (cx, cy unused), C_PLANES (cx[k * c_stride], cy[k * c_stride]) or
// C_SCALARS (one value each, on the device). interior_kind: none, from c
// (valid only with C_IS_Z0), or a contiguous bool plane. `out` is n counts,
// float32 when out_f32 != 0 else int32. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (0 on success).
extern "C" int escape_planes(const void* zx0, const void* zy0, long long z_stride,
                             const void* cx, const void* cy, long long c_stride,
                             int c_kind, const void* interior_plane, int interior_kind,
                             void* out, int out_f32, long long n, int max_iter,
                             int trip, float r2, void* stream) {
    const int block = 256;
    const unsigned int grid = static_cast<unsigned int>((n + block - 1) / block);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* zx = static_cast<const float*>(zx0);
    const float* zy = static_cast<const float*>(zy0);
    const float* cxp = static_cast<const float*>(cx);
    const float* cyp = static_cast<const float*>(cy);
    const bool* inside = static_cast<const bool*>(interior_plane);
    if (out_f32) {
        escape_planes_kernel<float><<<grid, block, 0, s>>>(
            zx, zy, z_stride, cxp, cyp, c_stride, c_kind, inside, interior_kind,
            static_cast<float*>(out), n, max_iter, trip, r2);
    } else {
        escape_planes_kernel<int><<<grid, block, 0, s>>>(
            zx, zy, z_stride, cxp, cyp, c_stride, c_kind, inside, interior_kind,
            static_cast<int*>(out), n, max_iter, trip, r2);
    }
    return static_cast<int>(cudaGetLastError());
}
