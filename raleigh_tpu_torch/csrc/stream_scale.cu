// Streaming scale y = a * x over a contiguous f32 array, for NVIDIA Hopper
// (sm_90a).
//
// Replaces bench.py::_extra_pallas_copy_roofline, the Pallas copy kernel
// whose rate bounds the memory-bound SpMM kernels: it reads every element
// once and writes it once, so 8 bytes move per element and per multiply.
//
// What bounds it: memory, and nothing else.  What the design does about it:
// one grid-stride kernel with 16-byte loads and stores, neighbouring threads
// on neighbouring addresses, four independent loads in flight per thread
// and enough blocks to fill every SM several times.  Arrays that are not
// 16-byte aligned take the same loop with 4-byte accesses; the last
// count % 4 elements always do.
// The kernel allocates nothing and does not synchronise.  The entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 16;

template <typename V>
__device__ __forceinline__ V scaled(V v, float a);
template <>
__device__ __forceinline__ float scaled<float>(float v, float a) {
    return a * v;
}
template <>
__device__ __forceinline__ float4 scaled<float4>(float4 v, float a) {
    return make_float4(a * v.x, a * v.y, a * v.z, a * v.w);
}

// y[i] = a * x[i] for i < count, in units of V (float or float4)
template <typename V>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const V* __restrict__ x, V* __restrict__ y, float a,
             int64_t count) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    for (; i + (kUnroll - 1) * stride < count; i += kUnroll * stride) {
        V v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) v[k] = x[i + k * stride];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) y[i + k * stride] = scaled(v[k], a);
    }
    for (; i < count; i += stride) y[i] = scaled(x[i], a);
}

template <typename V>
cudaError_t launch(const V* x, V* y, float a, int64_t count, int sms,
                   cudaStream_t stream) {
    if (count <= 0) return cudaSuccess;
    int64_t blocks = (count + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
    if (blocks > most) blocks = most;
    scale_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                      stream>>>(x, y, a, count);
    return cudaGetLastError();
}

}  // namespace

extern "C" int stream_scale_f32(const void* x, void* y, float a,
                                int64_t count, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0
                          && reinterpret_cast<uintptr_t>(y) % 16 == 0);
    if (!aligned) {
        return static_cast<int>(launch<float>(xf, yf, a, count, sms, s));
    }
    const int64_t vecs = count / 4;
    err = launch<float4>(reinterpret_cast<const float4*>(xf),
                         reinterpret_cast<float4*>(yf), a, vecs, sms, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch<float>(xf + 4 * vecs, yf + 4 * vecs, a,
                                          count - 4 * vecs, sms, s));
}
