// Two launch and pipeline structures of the streaming scale y = a * x over a
// contiguous f32 array, for NVIDIA Hopper (sm_90a).  Both compute what
// stream_scale.cu computes; they differ from it, and from each other, in how
// the work is cut into blocks and how the data travel.
//
// stream_scale_tiled_f32 replaces benches/bench_grid_shapes.py::
// build_blockspec, the Pallas grid pipeline with one (or per_step) tile(s)
// per grid step.  Here: a NON-persistent grid, one thread block per chunk of
// tile * per_step contiguous elements, 16-byte loads and stores, four
// independent loads in flight per thread, no grid stride.  The opposite
// launch shape to stream_scale.cu, whose fixed grid strides over the array.
//
// stream_scale_pipelined_f32 replaces benches/bench_grid_shapes.py::
// build_manual, the single grid step that pipelines every chunk by hand
// through `depth` rotating on-chip buffers.  Here: ONE launch of a
// persistent grid, as many blocks per SM as their shared memory allows; each
// block streams its chunks (block b takes chunks b, b + grid, ...) through
// `depth` rotating shared-memory stages filled by 16-byte cp.async copies.
// The copy of chunk k + depth - 1 is in flight while chunk k is scaled out of
// shared memory and stored: the data make the on-chip round trip, as the
// reference insists.  depth is a template parameter because
// cp.async.wait_group takes a compile-time count.
//
// What bounds both: memory, 8 bytes per element.  The kernels allocate
// nothing and do not synchronise the device.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float4 scaled(float4 v, float a) {
    return make_float4(a * v.x, a * v.y, a * v.z, a * v.w);
}

// Block b scales the chunk4 float4s that start at b * chunk4.
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float4* __restrict__ x, float4* __restrict__ y, float a,
             int64_t chunk4) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk4;
    const float4* xb = x + base;
    float4* yb = y + base;
    int64_t i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < chunk4; i += kUnroll * kThreads) {
        float4 v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) v[k] = xb[i + k * kThreads];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            yb[i + k * kThreads] = scaled(v[k], a);
        }
    }
    for (; i < chunk4; i += kThreads) yb[i] = scaled(xb[i], a);
}

__device__ __forceinline__ void cp_async16(float4* smem_dst,
                                           const float4* src) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Starts the copy of this block's k-th chunk into stage k % kDepth.
template <int kDepth>
__device__ __forceinline__ void start_chunk(const float4* __restrict__ x,
                                            float4* stages, int64_t first,
                                            int64_t k, int tile4) {
    const float4* src = x + (first + k * gridDim.x) * tile4;
    float4* dst = stages + (k % kDepth) * tile4;
    for (int i = threadIdx.x; i < tile4; i += kThreads) {
        cp_async16(dst + i, src + i);
    }
}

// Every thread commits one group per chunk slot, empty past the block's last
// chunk, so that wait_group<kDepth - 1> always means "chunk k has landed".
template <int kDepth>
__global__ void __launch_bounds__(kThreads)
pipelined_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                 float a, int64_t nchunks, int tile4) {
    extern __shared__ __align__(16) float4 stages[];
    const int64_t first = blockIdx.x;
    if (first >= nchunks) return;
    const int64_t mine = (nchunks - first + gridDim.x - 1) / gridDim.x;
    for (int s = 0; s < kDepth - 1; ++s) {
        if (s < mine) start_chunk<kDepth>(x, stages, first, s, tile4);
        cp_async_commit();
    }
    for (int64_t k = 0; k < mine; ++k) {
        // the stage this refills was drained in the previous iteration
        if (k + kDepth - 1 < mine) {
            start_chunk<kDepth>(x, stages, first, k + kDepth - 1, tile4);
        }
        cp_async_commit();
        cp_async_wait<kDepth - 1>();
        __syncthreads();
        const float4* src = stages + (k % kDepth) * tile4;
        float4* dst = y + (first + k * gridDim.x) * tile4;
        for (int i = threadIdx.x; i < tile4; i += kThreads) {
            dst[i] = scaled(src[i], a);
        }
        __syncthreads();
    }
}

template <int kDepth>
cudaError_t launch_pipelined(const float4* x, float4* y, float a,
                             int64_t nchunks, int64_t tile4, int sms,
                             cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(kDepth) * tile4 * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        pipelined_kernel<kDepth>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pipelined_kernel<kDepth>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    int64_t blocks = static_cast<int64_t>(sms) * per_sm;
    if (blocks > nchunks) blocks = nchunks;
    pipelined_kernel<kDepth><<<static_cast<unsigned int>(blocks), kThreads,
                               smem, stream>>>(x, y, a, nchunks,
                                               static_cast<int>(tile4));
    return cudaGetLastError();
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y = a * x over count f32 elements, one block per chunk elements.  Needs
// chunk % 4 == 0, count % chunk == 0 and 16-byte aligned pointers.
extern "C" int stream_scale_tiled_f32(const void* x, void* y, float a,
                                      int64_t count, int64_t chunk,
                                      int device, void* stream) {
    if (count <= 0) return static_cast<int>(cudaSuccess);
    if (chunk <= 0 || chunk % 4 != 0 || count % chunk != 0
            || !aligned16(x) || !aligned16(y)
            || count / chunk > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    tiled_kernel<<<static_cast<unsigned int>(count / chunk), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(y), a,
        chunk / 4);
    return static_cast<int>(cudaGetLastError());
}

// y = a * x over count f32 elements in chunks of tile elements through depth
// (2 or 4) shared-memory stages.  Needs tile % 4 == 0, count % tile == 0,
// 16-byte aligned pointers and depth * tile * 4 bytes of shared memory.
extern "C" int stream_scale_pipelined_f32(const void* x, void* y, float a,
                                          int64_t count, int64_t tile,
                                          int depth, int device,
                                          void* stream) {
    if (count <= 0) return static_cast<int>(cudaSuccess);
    if (tile <= 0 || tile % 4 != 0 || count % tile != 0 || !aligned16(x)
            || !aligned16(y) || tile / 4 > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float4* xv = static_cast<const float4*>(x);
    float4* yv = static_cast<float4*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (depth == 2) {
        err = launch_pipelined<2>(xv, yv, a, count / tile, tile / 4, sms, s);
    } else if (depth == 4) {
        err = launch_pipelined<4>(xv, yv, a, count / tile, tile / 4, sms, s);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
