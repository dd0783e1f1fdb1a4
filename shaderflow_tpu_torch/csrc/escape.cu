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
// Bound on this card: f32 ALU work, 9 instructions an escape step (4
// products, 4 sums, 1 compare: ops/fractal.py:ESCAPE_STEP_OPS) over the
// steps the data takes. One kernel serves every form; a Source reads a
// pixel's z0, c and interior flag. What it does about the two costs above
// the bound:
//
// * Idle lanes. One thread a pixel, and a warp retires with its slowest
//   lane. A warp covers a WARP_ROWS x (32 / WARP_ROWS) tile of pixels
//   (8 x 4, the fastest of 1, 2, 4 and 8 rows measured), not one row of 32:
//   escape times are spatially coherent, and a squarer tile holds fewer
//   slow lanes (at Mandelbrot's default view 75 % of its lanes do useful
//   steps against 63 % for 1 x 32). Handing an idle lane the next pixel of
//   its warp's tile (a ballot and a popc per hand-out) measured 3.3x
//   slower: at 7 steps a pixel some lane finishes nearly every step, and
//   each hand-out costs the whole warp some 20 instructions. The
//   Mandelbrot forms are bound by each pixel's work outside the loop, so
//   a block maps its 8 x 32 pixels by a few adds (a grid of warp tiles
//   indexed by division measured 13 % slower).
// * The loop's own instructions. A step is its 8 products and sums and
//   one compare; the count is not kept in the loop. The loop runs UNROLL
//   steps a turn (while they fit in the trip) and branches out every
//   CHECK steps on "some of the last CHECK steps escaped", the
//   compares of a group combined into one predicate; the exit works out
//   the first escaping step from its position in the unrolled turn. A
//   lane that escapes inside a group runs the rest of the group (its z is
//   never read again). The trip's remainder (< UNROLL steps) runs one
//   step at a time. The count is the reference's first escaping step, so
//   it is exact for a c whose orbit can re-enter the disc too. Measured
//   on every form: 2 steps a check against 1 and 4, 16-step turns against
//   4 and 8; 2 and 16 were the fastest or within 1 %.
//
// Every product and sum uses the _rn intrinsics (and the library is built
// with -fmad=false): an FMA rounds a*b+c once instead of twice and moves
// chaotic boundary pixels' escape step, which would break exact equality.
// A NaN |z|^2 keeps counting (!(m > r2), as the reference's
// `escaped |= m > r2`).

#include <cstdint>
#include <cuda_runtime.h>

constexpr int WARP_ROWS = 8;                       // rows of a warp's 32-pixel tile
constexpr int CHECK = 2;                           // escape steps between exit branches
constexpr int UNROLL = 16;                         // escape steps a loop turn
static_assert(UNROLL % CHECK == 0, "a loop turn is a whole number of checks");

// A warp of 8 x 4 pixels stores 16 bytes of each of its rows; the block's 8
// warps side by side complete each row's 128 bytes in L2, which is
// write-back, so device memory still takes each count once.
constexpr int WARP_COLS = 32 / WARP_ROWS;
constexpr int BLOCK_ROWS = 8;                      // a block: 8 warps over 8 x 32 pixels
constexpr int BLOCK_COLS = 32;
constexpr int WARPS_X = BLOCK_COLS / WARP_COLS;
constexpr int BLOCK_THREADS = BLOCK_ROWS * BLOCK_COLS;

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

// One step z <- z^2 + c in the reference's order (ny = 2.0 * zx * zy + cy
// left to right, nx = zx * zx - zy * zy + cx); x2, y2 follow the new z.
// Returns whether the new z escapes.
__device__ __forceinline__ bool escape_step(float& zx, float& zy, float& x2, float& y2,
                                            float cx, float cy, float r2) {
    const float ny = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zx), zy), cy);
    zx = __fadd_rn(__fsub_rn(x2, y2), cx);
    zy = ny;
    x2 = __fmul_rn(zx, zx);
    y2 = __fmul_rn(zy, zy);
    return __fadd_rn(x2, y2) > r2;
}

// Steps from z0 until |z|^2 > r2 or `trip` steps -> the step count.
__device__ __forceinline__ int escape_count(float zx, float zy, float cx, float cy,
                                            int trip, float r2) {
    float x2 = __fmul_rn(zx, zx);
    float y2 = __fmul_rn(zy, zy);
    if (__fadd_rn(x2, y2) > r2) {
        return 0;
    }
    int base = 0;
    for (; base <= trip - UNROLL; base += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; u += CHECK) {
            bool escaped[CHECK];
#pragma unroll
            for (int s = 0; s < CHECK; ++s) {
                escaped[s] = escape_step(zx, zy, x2, y2, cx, cy, r2);
            }
            bool any = escaped[0];
#pragma unroll
            for (int s = 1; s < CHECK; ++s) {
                any = any || escaped[s];
            }
            if (any) {
                int first = CHECK - 1;
#pragma unroll
                for (int s = CHECK - 2; s >= 0; --s) {
                    first = escaped[s] ? s : first;
                }
                return base + u + first + 1;
            }
        }
    }
#pragma unroll 1
    for (; base < trip; ++base) {                 // the trip's remainder
        if (escape_step(zx, zy, x2, y2, cx, cy, r2)) {
            return base + 1;
        }
    }
    return trip;
}

// A pixel's operands
struct Pixel {
    float zx, zy, cx, cy;
    bool inside;
};

// z0 == c: c[i, j] = (cx_line[j], cy_line[i])
struct LinesC {
    const float* __restrict__ cx;
    const float* __restrict__ cy;
    __device__ __forceinline__ Pixel operator()(int i, int j, long long) const {
        const float x = cx[j], y = cy[i];
        return {x, y, x, y, interior(x, y)};
    }
};

// z0 == c, an interleaved (..., 2) field with an 8-byte aligned base: one
// 8-byte load a pixel
struct PairC {
    const float2* __restrict__ c;
    __device__ __forceinline__ Pixel operator()(int, int, long long k) const {
        const float2 v = c[k];
        return {v.x, v.y, v.x, v.y, interior(v.x, v.y)};
    }
};

// z0 == c, any other stride that ops/fractal.py:_strided_plane admits
struct StridedC {
    const float* __restrict__ cx;
    const float* __restrict__ cy;
    long long stride;
    __device__ __forceinline__ Pixel operator()(int, int, long long k) const {
        const float x = cx[k * stride], y = cy[k * stride];
        return {x, y, x, y, interior(x, y)};
    }
};

// c given apart (Julia): two planes, or two 0-d values on the device; the
// interior flag from a bool plane, if any
struct ApartC {
    const float* __restrict__ zx;
    const float* __restrict__ zy;
    long long z_stride;
    const float* __restrict__ cx;
    const float* __restrict__ cy;
    long long c_stride;                 // 0: one value each
    const bool* __restrict__ inside;    // nullptr: no interior plane
    __device__ __forceinline__ Pixel operator()(int, int, long long k) const {
        return {zx[k * z_stride], zy[k * z_stride], cx[k * c_stride], cy[k * c_stride],
                inside != nullptr && inside[k]};
    }
};

template <class Source, typename Out>
__global__ void __launch_bounds__(BLOCK_THREADS)
escape_kernel(Source source, Out* __restrict__ out, int height, int width, int max_iter,
              int trip, float r2) {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int j = blockIdx.x * BLOCK_COLS + warp % WARPS_X * WARP_COLS + lane % WARP_COLS;
    const int row = warp / WARPS_X * WARP_ROWS + lane / WARP_COLS;
    // grid.y is at most 65535 blocks: taller fields take turns
    for (int i = blockIdx.y * BLOCK_ROWS + row; i < height && j < width;
         i += gridDim.y * BLOCK_ROWS) {
        const long long k = static_cast<long long>(i) * width + j;
        const Pixel p = source(i, j, k);
        const int count = p.inside ? max_iter : escape_count(p.zx, p.zy, p.cx, p.cy, trip, r2);
        out[k] = static_cast<Out>(count);
    }
}

template <class Source, typename Out>
static int launch_as(const Source& source, Out* out, int height, int width, int max_iter,
                     int trip, float r2, cudaStream_t stream) {
    if (height == 0 || width == 0) {
        return 0;
    }
    const int row_blocks = (height + BLOCK_ROWS - 1) / BLOCK_ROWS;
    const dim3 grid((width + BLOCK_COLS - 1) / BLOCK_COLS, row_blocks < 65535 ? row_blocks : 65535);
    escape_kernel<Source, Out><<<grid, BLOCK_THREADS, 0, stream>>>(
        source, out, height, width, max_iter, trip, r2);
    return static_cast<int>(cudaGetLastError());
}

template <class Source>
static int launch(const Source& source, void* out, int out_f32, int height, int width,
                  int max_iter, int trip, float r2, cudaStream_t stream) {
    return out_f32 ? launch_as(source, static_cast<float*>(out), height, width, max_iter, trip,
                               r2, stream)
                   : launch_as(source, static_cast<int*>(out), height, width, max_iter, trip,
                               r2, stream);
}

// Plain C entry point (bound with ctypes). `out` is (height, width),
// row-major, float32 when out_f32 != 0 else int32. Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (0 on success).
extern "C" int escape_lines(const void* cx_line, const void* cy_line,
                            void* out, int out_f32, int height, int width,
                            int max_iter, int trip, float r2, void* stream) {
    const LinesC source{static_cast<const float*>(cx_line), static_cast<const float*>(cy_line)};
    return launch(source, out, out_f32, height, width, max_iter, trip, r2,
                  static_cast<cudaStream_t>(stream));
}

// c_kind values of escape_planes
enum { C_IS_Z0 = 0, C_PLANES = 1, C_SCALARS = 2 };
// interior_kind values of escape_planes
enum { INTERIOR_NONE = 0, INTERIOR_FROM_C = 1, INTERIOR_PLANE = 2 };

// Plain C entry point (bound with ctypes). z0 is read at zx0[k * z_stride],
// zy0[k * z_stride] for the k-th pixel of `n` (row-major, `width` pixels a
// row); c per c_kind: C_IS_Z0 (cx, cy unused; the interior test from c,
// interior_kind INTERIOR_FROM_C, which no other kind takes), C_PLANES
// (cx[k * c_stride], cy[k * c_stride]) or C_SCALARS (one value each, on the
// device). interior_kind for the others: none or a contiguous bool plane.
// `out` is n counts, float32 when out_f32 != 0 else int32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a combination it does not take).
extern "C" int escape_planes(const void* zx0, const void* zy0, long long z_stride,
                             const void* cx, const void* cy, long long c_stride,
                             int c_kind, const void* interior_plane, int interior_kind,
                             void* out, int out_f32, long long n, int width, int max_iter,
                             int trip, float r2, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* zx = static_cast<const float*>(zx0);
    const float* zy = static_cast<const float*>(zy0);
    if (n == 0) {
        return 0;
    }
    if ((c_kind == C_IS_Z0) != (interior_kind == INTERIOR_FROM_C) || width <= 0
        || n % width != 0 || n / width > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int height = static_cast<int>(n / width);
    if (c_kind == C_IS_Z0) {
        const bool pair = z_stride == 2 && zy == zx + 1
                          && reinterpret_cast<std::uintptr_t>(zx) % alignof(float2) == 0;
        if (pair) {
            const PairC source{reinterpret_cast<const float2*>(zx)};
            return launch(source, out, out_f32, height, width, max_iter, trip, r2, s);
        }
        const StridedC source{zx, zy, z_stride};
        return launch(source, out, out_f32, height, width, max_iter, trip, r2, s);
    }
    const ApartC source{zx, zy, z_stride, static_cast<const float*>(cx),
                        static_cast<const float*>(cy), c_kind == C_SCALARS ? 0 : c_stride,
                        interior_kind == INTERIOR_PLANE
                            ? static_cast<const bool*>(interior_plane) : nullptr};
    return launch(source, out, out_f32, height, width, max_iter, trip, r2, s);
}
