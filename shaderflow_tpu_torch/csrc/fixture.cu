// T3: the cost walker's fixture, x * 2 + 1 over a grid of (32, 128) blocks.
//
// Replaces tests/test_flopcount.py:kern, the Pallas fixture (pallas_call
// :72) that pins tools/flopcount.py's body-times-grid rule. Its counterpart
// pins shaderflow_tpu_torch/tools/flopcount.py: the wrapper (`fixture`)
// declares one logical block's cost (2 ops and 8 bytes per element of a
// (32, 128) block) and the walker multiplies it by the logical grid, rows /
// 32 blocks. The launch grid below is not that grid: the kernel sees the
// tensor as one flat run of float4 and the wrapper chooses the CTAs.
//
// Bound on this card: bytes (2 operations per 8 bytes moved). So the
// kernel is one 16-byte stream over every SM: the wrapper's geometry
// (flopcount.fixture_geometry) gives each thread one float4, in CTAs of
// 128 threads, or smaller ones where that spreads a small tensor over more
// SMs (a 128x128 call: 128 CTAs of one warp on 128 SMs, not 4 CTAs). On
// the H100 a persistent grid that strides over the tensor, several loads a
// thread before its stores, ran slower than this one pass (PERF.md §6).
// Loads and stores carry the streaming hint (ld/st.global.cs): nothing is
// read twice. The float4 past the end are masked. The product and the sum
// are each rounded (_rn intrinsics, and the build passes -fmad=false), as
// the plain version computes them.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float twice_plus_one(float v) {
    return __fadd_rn(__fmul_rn(v, 2.0f), 1.0f);
}

// Thread t of CTA c maps float4 c * blockDim.x + t
__global__ void fixture_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                               long long vectors) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < vectors) {
        const float4 v = __ldcs(x + i);
        __stcs(out + i, make_float4(twice_plus_one(v.x), twice_plus_one(v.y),
                                    twice_plus_one(v.z), twice_plus_one(v.w)));
    }
}

// The floor every launch sits at: one thread that does nothing.
__global__ void empty_kernel() {}

}  // namespace

// x, out: `vectors` float4 (a contiguous float32 tensor), 16-byte aligned.
// The geometry comes from the wrapper: `ctas` CTAs of `threads` threads,
// ctas * threads >= vectors. Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (0 on success).
extern "C" int fixture_launch(const void* x, void* out, long long vectors, int ctas,
                              int threads, void* stream) {
    if (vectors <= 0) {
        return 0;
    }
    fixture_kernel<<<ctas, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out), vectors);
    return static_cast<int>(cudaGetLastError());
}

// One launch of the empty kernel on `stream`: what a launch costs the card
// with no work in it. Returns cudaGetLastError() (0 on success).
extern "C" int empty_launch(void* stream) {
    empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
