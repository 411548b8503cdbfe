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
// The kernel allocates nothing and does not synchronise.  The entry point
// returns cudaGetLastError() after its launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

}  // namespace

// The whole array through the kernel at V = float4 where both pointers are
// 16-byte aligned, then its count % 4 tail at V = float; all of it at
// V = float where they are not.
extern "C" int stream_scale_f32(const void* x, void* y, float a,
                                int64_t count, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0
                          && reinterpret_cast<uintptr_t>(y) % 16 == 0);
    if (!aligned) return static_cast<int>(launch<float>(xf, yf, a, count, s));
    const int64_t vecs = count / 4;
    err = launch<float4>(reinterpret_cast<const float4*>(xf),
                         reinterpret_cast<float4*>(yf), a, vecs, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch<float>(xf + 4 * vecs, yf + 4 * vecs, a,
                                          count - 4 * vecs, s));
}
