// Kernel K3: escape-time iteration counts, separable (lines) form.
//
// Replaces shaderflow_tpu/ops/fractal.py:_escape_pallas (lines=True), the
// Pallas TPU kernel behind escape_iterations_sep. Counts are defined by
// the reference loop _escape_xla (fractal.py:40-63) and held exactly equal
// to its PyTorch port, ops/fractal.py:escape_plain.
//
// c[i, j] = (cx_line[j], cy_line[i]); z0 = c. Pixels inside the main
// cardioid or the period-2 bulb report max_iter without iterating (the
// _interior_mask test, same expression order). Otherwise
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
// Every product and sum uses the _rn intrinsics (and the library is built
// with -fmad=false): an FMA rounds a*b+c once instead of twice and moves
// chaotic boundary pixels' escape step, which would break exact equality.

#include <cuda_runtime.h>

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

    // _interior_mask: q(q + (x - 1/4)) <= y^2/4 (cardioid),
    // (x + 1)^2 + y^2 <= 1/16 (bulb)
    const float xq = __fsub_rn(cx, 0.25f);
    const float cy2 = __fmul_rn(cy, cy);
    const float q = __fadd_rn(__fmul_rn(xq, xq), cy2);
    const bool cardioid = __fmul_rn(q, __fadd_rn(q, xq)) <= __fmul_rn(0.25f, cy2);
    const float xp = __fadd_rn(cx, 1.0f);
    const bool bulb = __fadd_rn(__fmul_rn(xp, xp), cy2) <= 0.0625f;

    int count = max_iter;
    if (!(cardioid || bulb)) {
        float zx = cx;
        float zy = cy;
        float x2 = __fmul_rn(zx, zx);
        float y2 = __fmul_rn(zy, zy);
        count = 0;
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
    }
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
