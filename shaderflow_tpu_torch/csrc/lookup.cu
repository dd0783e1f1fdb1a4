// Kernel K2: per-frame tables expanded over one static index field.
//
// Replaces shaderflow_tpu/ops/sampling.py:lookup_nearest_1d_select_batched,
// the Pallas TPU kernel of the music visualizer's bar-field prelude:
//   out[b, p] = table16[b, idx[p]]
// with table16 the (frames, n) tables rounded to bf16 once and idx the
// flat (row * C + channel) index of pixel p (computed by the wrapper, in
// the reference's expression order). The TPU kernel built a one-hot per
// pixel block and multiplied it on the MXU, because the TPU serialises
// gathers; here the expand is a gather from shared memory.
//
// Bound on this card: bytes written. Each pixel's index is read once (4
// bytes) and each frame's value is written once (2 bytes in bf16): at the
// visualizer's shapes (128 frames, 2160 x 3840) that is 2.12 GB of writes
// against 33 MB of reads per batch. The design keeps the writes at full
// width: the block stages every frame's table in shared memory (dynamic,
// above 48 KB when frames * n * 2 bytes needs it; the launcher splits the
// frames into chunks that fit), each thread reads the indices of 8
// contiguous pixels once and, for every frame, gathers 8 values from shared
// memory and writes them as one 16-byte store, so a warp writes 512
// contiguous bytes per frame. Values are copied bits: the result equals the
// plain gather exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 8;   // contiguous pixels per thread (one 16-byte bf16 store)

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ void store8(uint16_t* out, const uint16_t (&v)[kPixels]) {
    uint4 packed;
    packed.x = static_cast<uint32_t>(v[0]) | (static_cast<uint32_t>(v[1]) << 16);
    packed.y = static_cast<uint32_t>(v[2]) | (static_cast<uint32_t>(v[3]) << 16);
    packed.z = static_cast<uint32_t>(v[4]) | (static_cast<uint32_t>(v[5]) << 16);
    packed.w = static_cast<uint32_t>(v[6]) | (static_cast<uint32_t>(v[7]) << 16);
    *reinterpret_cast<uint4*>(out) = packed;
}

__device__ __forceinline__ void store8(float* out, const uint16_t (&v)[kPixels]) {
    float4* vec = reinterpret_cast<float4*>(out);
    vec[0] = make_float4(bf16_bits_to_float(v[0]), bf16_bits_to_float(v[1]),
                         bf16_bits_to_float(v[2]), bf16_bits_to_float(v[3]));
    vec[1] = make_float4(bf16_bits_to_float(v[4]), bf16_bits_to_float(v[5]),
                         bf16_bits_to_float(v[6]), bf16_bits_to_float(v[7]));
}

__device__ __forceinline__ void store1(uint16_t* out, uint16_t v) { *out = v; }
__device__ __forceinline__ void store1(float* out, uint16_t v) { *out = bf16_bits_to_float(v); }

// frames x n tables (bf16 bits) -> out (frames, npx). `groups` is the
// number of 8-pixel groups taken with vector loads and stores (0 when npx
// is not a multiple of 8); the pixels after them go one at a time.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
lookup_expand_kernel(const int* __restrict__ idx, const uint16_t* __restrict__ tables,
                     Out* __restrict__ out, int frames, int n, long long npx,
                     long long groups) {
    extern __shared__ uint16_t table[];   // (frames, n)
    const int total = frames * n;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
        table[k] = tables[k];
    }
    __syncthreads();

    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    for (long long g = first; g < groups; g += stride) {
        const long long p = g * kPixels;
        const int4 i0 = *reinterpret_cast<const int4*>(idx + p);
        const int4 i1 = *reinterpret_cast<const int4*>(idx + p + 4);
        const int ix[kPixels] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
        for (int b = 0; b < frames; ++b) {
            const uint16_t* row = table + b * n;
            uint16_t v[kPixels];
#pragma unroll
            for (int k = 0; k < kPixels; ++k) {
                v[k] = row[ix[k]];
            }
            store8(out + b * npx + p, v);
        }
    }
    for (long long p = groups * kPixels + first; p < npx; p += stride) {
        const int i = idx[p];
        for (int b = 0; b < frames; ++b) {
            store1(out + b * npx + p, table[b * n + i]);
        }
    }
}

template <typename Out>
int launch(const int* idx, const uint16_t* tables, Out* out, int frames, int n,
           long long npx, cudaStream_t stream) {
    int device = 0;
    cudaError_t status = cudaGetDevice(&device);
    if (status != cudaSuccess) return static_cast<int>(status);
    int sms = 0, smem_optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    const int row_bytes = n * static_cast<int>(sizeof(uint16_t));
    const int chunk = row_bytes > 0 ? smem_optin / row_bytes : 0;
    if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);

    // Vector path only when every frame's row starts 16-byte aligned
    const long long groups = (npx % kPixels == 0) ? npx / kPixels : 0;
    const long long work = groups > 0 ? groups : npx;
    for (int b0 = 0; b0 < frames; b0 += chunk) {
        const int count = frames - b0 < chunk ? frames - b0 : chunk;
        const size_t smem = static_cast<size_t>(count) * row_bytes;
        status = cudaFuncSetAttribute(lookup_expand_kernel<Out>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem));
        if (status != cudaSuccess) return static_cast<int>(status);
        // A few resident blocks per SM: each one loads the tables once
        const int per_sm = static_cast<int>((smem_optin + 1024) / (smem + 1024));
        long long blocks = (work + kThreads - 1) / kThreads;
        const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
        if (blocks > cap) blocks = cap;
        if (blocks < 1) blocks = 1;
        lookup_expand_kernel<Out><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            idx, tables + static_cast<long long>(b0) * n, out + b0 * npx, count, n, npx,
            groups);
        status = cudaGetLastError();
        if (status != cudaSuccess) return static_cast<int>(status);
    }
    return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). idx: (npx,) int32 in [0, n);
// tables: (frames, n) bf16; out: (frames, npx) float32 when out_f32 != 0,
// else bf16. Launches on `stream`, allocates nothing, returns a cudaError_t
// (0 on success).
extern "C" int lookup_expand(const void* idx, const void* tables, void* out,
                             int out_f32, int frames, int n, long long npx,
                             void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* index = static_cast<const int*>(idx);
    const uint16_t* table = static_cast<const uint16_t*>(tables);
    if (out_f32) {
        return launch<float>(index, table, static_cast<float*>(out), frames, n, npx, s);
    }
    return launch<uint16_t>(index, table, static_cast<uint16_t*>(out), frames, n, npx, s);
}
