// Streaming scale y = a * x over a contiguous f32 array, for NVIDIA Hopper
// (sm_90a).
//
// Replaces bench.py::_extra_pallas_copy_roofline, the Pallas copy kernel
// whose rate bounds the memory-bound SpMM kernels: it reads every element
// once and writes it once, so 8 bytes move per element and per multiply.
//
// What bounds it: memory, and nothing else.  What the design does about it:
// a NON-persistent grid of one 16-byte element per thread, block b scaling
// the contiguous span of kThreads vectors at b * kThreads, with streaming
// cache hints (__ldcs / __stcs: neither the data read nor the data written
// is used again).  A block walks no stride and waits for no other block:
// the hardware starts a new block on an SM as soon as one retires, so the
// SMs that stream faster take more of the array.  The previous design, a
// fixed grid of 16 blocks an SM each striding over the whole array with
// four loads in flight a thread, gave every SM the same share, and the
// slowest set the end: 4-5% behind torch.mul.  Spans of 2, 4 or 8 vectors
// a thread measured no faster, and a persistent grid of one wave (8 blocks
// an SM) slower still.  Arrays that are not 16-byte aligned take the same
// spans with 4-byte accesses; the last count % 4 elements always do.
//
// stream_scale_prev_f32 keeps the previous design (the fixed grid-stride
// loop), to be timed in turns with the new one; no path launches it.
//
// The kernels allocate nothing and do not synchronise.  The entry points
// return cudaGetLastError() after their launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the previous design's loads in flight a thread, and its fixed grid
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

// y[i] = a * x[i] for the one i of this thread, if i < count, in units of V
// (float or float4)
template <typename V>
__global__ void __launch_bounds__(kThreads)
span_kernel(const V* __restrict__ x, V* __restrict__ y, float a,
            int64_t count) {
    const int64_t i =
        static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i < count) __stcs(y + i, scaled(__ldcs(x + i), a));
}

template <typename V>
cudaError_t launch(const V* x, V* y, float a, int64_t count,
                   cudaStream_t stream) {
    if (count <= 0) return cudaSuccess;
    const int64_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    span_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                     stream>>>(x, y, a, count);
    return cudaGetLastError();
}

// The previous design: y[i] = a * x[i] for i < count by a grid-stride loop.
template <typename V>
__global__ void __launch_bounds__(kThreads)
stride_kernel(const V* __restrict__ x, V* __restrict__ y, float a,
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
cudaError_t launch_prev(const V* x, V* y, float a, int64_t count, int sms,
                        cudaStream_t stream) {
    if (count <= 0) return cudaSuccess;
    int64_t blocks = (count + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
    if (blocks > most) blocks = most;
    stride_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       stream>>>(x, y, a, count);
    return cudaGetLastError();
}

// The whole array through kernel(V = float4) where both pointers are
// 16-byte aligned, then its count % 4 tail through kernel(V = float);
// all of it through kernel(V = float) where they are not.
template <typename Float4Launch, typename FloatLaunch>
int scale_all(const void* x, void* y, int64_t count, Float4Launch vec,
              FloatLaunch one) {
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0
                          && reinterpret_cast<uintptr_t>(y) % 16 == 0);
    if (!aligned) return static_cast<int>(one(xf, yf, count));
    const int64_t vecs = count / 4;
    cudaError_t err = vec(reinterpret_cast<const float4*>(xf),
                          reinterpret_cast<float4*>(yf), vecs);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(one(xf + 4 * vecs, yf + 4 * vecs,
                                count - 4 * vecs));
}

}  // namespace

extern "C" int stream_scale_f32(const void* x, void* y, float a,
                                int64_t count, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return scale_all(
        x, y, count,
        [&](const float4* xv, float4* yv, int64_t n) {
            return launch<float4>(xv, yv, a, n, s);
        },
        [&](const float* xv, float* yv, int64_t n) {
            return launch<float>(xv, yv, a, n, s);
        });
}

extern "C" int stream_scale_prev_f32(const void* x, void* y, float a,
                                     int64_t count, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return scale_all(
        x, y, count,
        [&](const float4* xv, float4* yv, int64_t n) {
            return launch_prev<float4>(xv, yv, a, n, sms, s);
        },
        [&](const float* xv, float* yv, int64_t n) {
            return launch_prev<float>(xv, yv, a, n, sms, s);
        });
}
