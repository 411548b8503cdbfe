// Two launch and pipeline structures of the streaming scale y = a * x over a
// contiguous f32 array, for NVIDIA Hopper (sm_90a).  Both compute what
// stream_scale.cu computes; they differ from it, and from each other, in how
// the work is cut into blocks and how the data travel.
//
// stream_scale_tiled_f32 replaces benches/bench_grid_shapes.py::
// build_blockspec, the Pallas grid pipeline with one (or per_step) tile(s)
// per grid step.  Here: a NON-persistent grid, one thread block per chunk of
// tile * per_step contiguous elements, 16-byte loads and stores, four
// independent loads in flight per thread, no grid stride.
//
// stream_scale_pipelined_f32 replaces benches/bench_grid_shapes.py::
// build_manual, the single grid step that pipelines every chunk by hand
// through `depth` rotating on-chip buffers with DMAs and DMA semaphores:
// in-DMA chunk k into a buffer, scale it there, out-DMA it, and wait for
// that out-DMA before the next in-DMA reuses the buffer.  Here the same
// steps with the H100's own DMA engine, the Tensor Memory Accelerator: ONE
// launch of a persistent grid, as many blocks per SM as their shared memory
// allows.  Each block keeps `depth` stages of `tile` elements in dynamic
// shared memory and, behind them, an mbarrier and a chunk index per stage.
//   load   one elected thread draws the next chunk from a counter in global
//          memory, arms the stage's mbarrier with the chunk's bytes
//          (arrive.expect_tx) and starts a bulk copy global -> shared
//          (cp.async.bulk ... mbarrier::complete_tx); the threads wait on
//          the barrier's phase parity, with no block barrier;
//   scale  the threads scale the stage in place in shared memory, the
//          on-chip round trip the reference makes;
//   store  after fence.proxy.async (the threads' writes made visible to the
//          copy engine) and one block barrier, the elected thread starts a
//          bulk copy shared -> global of the stage (bulk_group) and commits
//          it;
//   reuse  before it refills the stage, the elected thread waits until
//          that store has read the stage (cp.async.bulk.wait_group.read),
//          the reference's out-DMA wait.
// The prologue fills every stage, so while one stage is scaled the loads of
// the next depth - 1 chunks are in flight.  No thread spends a register or
// an instruction on an address of the copies.  Both copies carry an L2
// evict-first policy, as the stream kernel's loads and stores carry
// streaming hints: the stream reuses no line.  Chunks are drawn, not dealt:
// with a fixed share per block (b, b + grid, ...) the blocks whose SMs
// stream slower set the end and the kernel ran 5% behind torch.mul; drawn
// from one counter, a block that is ahead takes more.  A stage whose draw
// finds no chunk left gets the index -1 and a plain arrival, which ends
// the block's loop once the chunks before it are done.  The last block to
// finish sets the counter back to 0 for the next launch.
//
// What bounds all of them: memory, 8 bytes per element.  The kernels
// allocate nothing and do not synchronise the device.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "mbarrier.cuh"

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

// ---- the pipelined probe: bulk copies through an mbarrier ring ----------

// bytes behind each stage in dynamic shared memory: its mbarrier and the
// index of the chunk it holds (ops/stream.py counts them in its
// shared-memory check); a stage of tile * 4 bytes, tile a multiple of 4,
// keeps both 8-byte aligned
constexpr int kStageExtraBytes = 16;
// An L2 policy that evicts the lines a copy touches first: the stream
// reads nothing twice and nobody reads what it writes.
__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    return policy;
}

// One thread: starts the bulk copy of `bytes` from shared `src` to global
// `dst` under the L2 `policy`, as a bulk group of its own.
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                 ".L2::cache_hint [%0], [%1], %2, %3;\n"
                 :: "l"(dst), "r"(src), "r"(bytes), "l"(policy) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The chunks are the tile elements at c * tile, c < nchunks, drawn from
// counter[0]; counter[1] counts the blocks that have finished.  Both are 0
// at launch, and the last block leaves them 0.
template <int kDepth>
__global__ void __launch_bounds__(kThreads)
pipelined_kernel(const float* __restrict__ x, float* __restrict__ y,
                 float a, int64_t nchunks, int tile,
                 unsigned long long* counter) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t bytes = static_cast<uint32_t>(tile) * 4;
    const uint32_t stage0 = smem_addr(smem);
    const uint32_t bar0 = stage0 + kDepth * bytes;
    volatile int64_t* held =
        reinterpret_cast<int64_t*>(smem + kDepth * (bytes + 8));
    const bool issuer = threadIdx.x == 0;
    const uint64_t policy = issuer ? evict_first_policy() : 0;
    // issuer only: draws the next chunk into stage s, or marks it the end
    auto fill = [&](int s) {
        const unsigned long long c = atomicAdd(counter, 1ULL);
        const uint32_t bar = bar0 + s * 8;
        if (c < static_cast<unsigned long long>(nchunks)) {
            held[s] = static_cast<int64_t>(c);
            expect_bytes(bar, bytes);
            bulk_load(stage0 + s * bytes, x + c * tile, bytes, bar, policy);
        } else {
            held[s] = -1;
            barrier_arrive(bar);
        }
    };
    if (issuer) {
        for (int s = 0; s < kDepth; ++s) barrier_init(bar0 + s * 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < kDepth; ++s) fill(s);
    }
    __syncthreads();
    const int tile4 = tile / 4;
    for (int64_t k = 0;; ++k) {
        const int s = static_cast<int>(k % kDepth);
        barrier_wait(bar0 + s * 8, static_cast<uint32_t>(k / kDepth) & 1);
        const int64_t c = held[s];
        if (c < 0) break;   // every stage after it is past the end too
        float4* stage = reinterpret_cast<float4*>(smem + s * bytes);
        for (int i = threadIdx.x; i < tile4; i += kThreads) {
            stage[i] = scaled(stage[i], a);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (issuer) {
            bulk_store(y + c * tile, stage0 + s * bytes, bytes, policy);
            // the stage is free once its store has read it
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            fill(s);
        }
    }
    if (issuer) {
        // the stages must outlive the stores that read them
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        __threadfence();   // this block's draws before its count
        if (atomicAdd(counter + 1, 1ULL) == gridDim.x - 1) {
            counter[0] = 0;
            counter[1] = 0;
        }
    }
}

// One persistent grid of as many blocks as fit the SMs with the stages'
// shared memory each, at most nchunks.
template <int kDepth>
cudaError_t launch_pipelined(const float* x, float* y, float a,
                             int64_t nchunks, int64_t tile,
                             unsigned long long* counter, int sms,
                             cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(kDepth)
                        * (tile * sizeof(float) + kStageExtraBytes);
    auto kernel = pipelined_kernel<kDepth>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    int64_t blocks = static_cast<int64_t>(sms) * per_sm;
    if (blocks > nchunks) blocks = nchunks;
    kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
        x, y, a, nchunks, static_cast<int>(tile), counter);
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
// (2 or 4) shared-memory stages filled and drained by bulk copies.  Needs
// tile % 4 == 0, count % tile == 0, 16-byte aligned pointers,
// depth * (tile * 4 + 16) bytes of shared memory, and `counter`: two
// unsigned 64-bit ints on the device, 0 at launch (the kernel leaves them
// 0), used by no other launch in flight.
extern "C" int stream_scale_pipelined_f32(const void* x, void* y, float a,
                                          int64_t count, int64_t tile,
                                          int depth, void* counter,
                                          int device, void* stream) {
    if (count <= 0) return static_cast<int>(cudaSuccess);
    if (tile <= 0 || tile % 4 != 0 || count % tile != 0 || !aligned16(x)
            || !aligned16(y) || tile > 0x7fffffffLL / 4 || counter == nullptr
            || (depth != 2 && depth != 4)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto launch = depth == 2 ? launch_pipelined<2>
                                   : launch_pipelined<4>;
    return static_cast<int>(launch(
        static_cast<const float*>(x), static_cast<float*>(y), a,
        count / tile, tile, static_cast<unsigned long long*>(counter), sms,
        static_cast<cudaStream_t>(stream)));
}
