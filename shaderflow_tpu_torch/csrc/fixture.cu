// T3: the cost walker's fixture, x * 2 + 1 over a grid of (32, 128) blocks.
//
// Replaces tests/test_flopcount.py:kern, the Pallas fixture (pallas_call
// :72) that pins tools/flopcount.py's body-times-grid rule. Its counterpart
// pins shaderflow_tpu_torch/tools/flopcount.py: the wrapper (`fixture`)
// declares one block's cost (2 ops and 8 bytes per element of a (32, 128)
// block) and the walker multiplies it by this kernel's grid, one CUDA block
// per (32, 128) block of the input.
//
// Bound on this card: bytes (2 operations per 8 bytes moved). Each thread
// moves 16-byte vectors, neighbouring threads on neighbouring addresses.
// The product and the sum are each rounded (_rn intrinsics, and the build
// passes -fmad=false), as the plain version computes them.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockElements = 32 * 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float twice_plus_one(float v) {
    return __fadd_rn(__fmul_rn(v, 2.0f), 1.0f);
}

__global__ void fixture_kernel(const float4* __restrict__ x, float4* __restrict__ out) {
    const long long base = static_cast<long long>(blockIdx.x) * (kBlockElements / 4);
    for (int i = threadIdx.x; i < kBlockElements / 4; i += kThreads) {
        float4 v = x[base + i];
        v.x = twice_plus_one(v.x);
        v.y = twice_plus_one(v.y);
        v.z = twice_plus_one(v.z);
        v.w = twice_plus_one(v.w);
        out[base + i] = v;
    }
}

// The floor every launch sits at: one thread that does nothing.
__global__ void empty_kernel() {}

}  // namespace

// x, out: contiguous float32 (32 * blocks, 128), 16-byte aligned. Launches
// on `stream`, allocates nothing, returns cudaGetLastError() (0 on success).
extern "C" int fixture_launch(const void* x, void* out, int blocks, void* stream) {
    if (blocks <= 0) {
        return 0;
    }
    fixture_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out));
    return static_cast<int>(cudaGetLastError());
}

// One launch of the empty kernel on `stream`: what a launch costs the card
// with no work in it. Returns cudaGetLastError() (0 on success).
extern "C" int empty_launch(void* stream) {
    empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
