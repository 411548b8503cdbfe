// BSR SpMM on row-layout operand blocks, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_pallas.py::_pallas_bsr_matmat (kernel body
// _spmm_kernel), the block-sparse tile contraction of the finite-element
// operator path.  It computes
//
//     y[r, i*bs + p] = sum_{t = indptr[i]}^{indptr[i+1]-1} sum_q
//                      blocks[t][p, q] * x[r, cols[t]*bs + q]
//
// with blocks (nblocks, bs, bs) in f32 or bf16, x and y (m, n) contiguous in
// f32 or bf16, n unpadded: rows i*bs + p >= n are not written and columns
// cols[t]*bs + q >= n are read as zero.  Every product and sum is an f32
// fused multiply-add on the CUDA cores (no TF32, no tensor cores: the
// reference runs this product at full f32 precision); the result is rounded
// to the operand type once, on store.
//
// What bounds it: memory, by the count of bytes.  The tiles are read once
// (nblocks*bs*bs*b bytes) for 2*nblocks*bs*bs*m flops, so at m = 16 and f32
// tiles it does 8 flops per byte of tile: under the card's f32 balance, but
// near enough to it that a kernel must keep its multiply-add pipes and its
// shared-memory reads lean to stay on the memory side.  This one does not
// yet: on an H100 (80GB HBM3, 700 W) bf16 tiles, half the bytes, take the
// same time as f32 tiles, and 24 operand rows take 1.8 times as long as 16,
// so its own arithmetic and shared-memory work limit it, not the device
// memory (PERF.md has the times).
//
// What the design does about it:
//   * One thread block per (block row, slab of 128 tile rows, group of 16
//     operand rows).  The Pallas grid is sequential and keeps the output
//     tile in VMEM across a tile list padded to the longest block row; here
//     each thread block loops over its own block row's tiles as the
//     block-CSR arrays give them, and block rows run in parallel.
//   * Thread p owns tile row p and keeps 16 f32 accumulators, one per
//     operand row: one shared-memory read of blocks[t][p, q] and four
//     16-byte broadcast reads of the operand slab feed 16 multiply-adds.
//   * Tiles pass through shared memory in chunks of 32 columns.  A warp
//     reads one tile row's 32 consecutive values at a time (coalesced along
//     q), and the chunk is stored with a row stride of 33 words so that the
//     threads' reads of column q fall in 32 different banks.
//   * The next chunk's global loads are started into registers before the
//     current chunk is contracted, so a block overlaps its own loads with
//     its arithmetic; several blocks per SM overlap the rest.
//   * The groups of operand rows of one block row are neighbouring thread
//     blocks, so when m > 16 the tiles' second reads find them in L2.
//   * x is re-read once per tile from L2 (it is m*n*b bytes, a few MB).
//   * Index arithmetic is 64-bit; bs, m and n have no alignment limits, and
//     a block row with no tile writes zeros.
// The kernel allocates nothing and does not synchronise.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // tile rows per thread block (one a thread)
constexpr int kRows = 16;       // operand rows per thread block
constexpr int kChunk = 32;      // tile columns staged at a time
constexpr int kTileStride = kChunk + 1;
constexpr int kSlabStride = kRows + 4;   // 16-byte aligned, spreads banks
constexpr int kWarps = kThreads / 32;
// blocks per SM the register count is held to (102 registers a thread):
// five resident blocks hide one another's loads and barriers
constexpr int kMinBlocks = 5;
constexpr int kTileLoads = kThreads / kWarps;        // rows a warp loads
constexpr int kSlabLoads = kChunk * kRows / kThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
    return __float2bfloat16(0.0f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// Global loads of chunk c of a block row (tile t0 + c / nq, columns
// (c % nq) * kChunk ...) into registers: this thread's share of the tile
// chunk and of the operand slab under it, in their storage types (they are
// converted to f32 on the way to shared memory, so that no load waits for
// a conversion), zero where the tile, the operand block or the matrix
// ends.
template <typename TB, typename TX>
__device__ __forceinline__ void fetch_chunk(
        const TB* __restrict__ blocks, const int* __restrict__ cols,
        const TX* __restrict__ x, int64_t bs, int64_t m, int64_t n,
        int64_t t0, int64_t nq, int64_t p0, int64_t r0, int64_t c,
        TB (&tile_g)[kTileLoads], TX (&slab_g)[kSlabLoads]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t t = t0 + c / nq;
    const int64_t q = (c % nq) * kChunk + lane;
    const TB* tile = blocks + t * bs * bs;
    // warp w reads tile rows p0 + w, p0 + w + kWarps, ...: 32 consecutive
    // values of one row per load
#pragma unroll
    for (int k = 0; k < kTileLoads; ++k) {
        const int64_t p = p0 + warp + k * kWarps;
        tile_g[k] = (p < bs && q < bs) ? tile[p * bs + q] : zero<TB>();
    }
    // operand slab: rows r0 .. r0 + kRows - 1, the same 32 columns
    const int64_t j = static_cast<int64_t>(cols[t]) * bs + q;
#pragma unroll
    for (int k = 0; k < kSlabLoads; ++k) {
        const int64_t r = r0 + warp + k * kWarps;
        slab_g[k] = (r < m && q < bs && j < n) ? x[r * n + j] : zero<TX>();
    }
}

// Thread block b covers operand-row group b % groups, tile-row slab
// (b / groups) % slabs and block row b / (groups * slabs).
template <typename TB, typename TX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bsr_rows_kernel(const TB* __restrict__ blocks, const int* __restrict__ indptr,
                const int* __restrict__ cols, const TX* __restrict__ x,
                TX* __restrict__ y, int64_t bs, int64_t m, int64_t n,
                int64_t groups, int64_t slabs) {
    __shared__ float tile_s[kThreads * kTileStride];
    __shared__ __align__(16) float slab_s[kChunk * kSlabStride];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t p0 = ((b / groups) % slabs) * kThreads;
    const int64_t brow = b / (groups * slabs);

    const int64_t t0 = indptr[brow];
    const int64_t ntiles = indptr[brow + 1] - t0;
    const int64_t nq = (bs + kChunk - 1) / kChunk;   // chunks per tile
    const int64_t nchunks = ntiles * nq;

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

    // registers holding the chunk in flight from global memory
    TB tile_g[kTileLoads];
    TX slab_g[kSlabLoads];
#define FETCH(c) \
    fetch_chunk(blocks, cols, x, bs, m, n, t0, nq, p0, r0, (c), tile_g, slab_g)

    if (nchunks > 0) FETCH(0);
    for (int64_t c = 0; c < nchunks; ++c) {
#pragma unroll
        for (int k = 0; k < kTileLoads; ++k) {
            tile_s[(warp + k * kWarps) * kTileStride + lane] =
                to_f32(tile_g[k]);
        }
#pragma unroll
        for (int k = 0; k < kSlabLoads; ++k) {
            slab_s[lane * kSlabStride + warp + k * kWarps] =
                to_f32(slab_g[k]);
        }
        __syncthreads();
        if (c + 1 < nchunks) FETCH(c + 1);
        const float* trow = tile_s + tid * kTileStride;
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
            const float a = trow[q];
            const float4* xs =
                reinterpret_cast<const float4*>(slab_s + q * kSlabStride);
#pragma unroll
            for (int r4 = 0; r4 < kRows / 4; ++r4) {
                const float4 v = xs[r4];
                acc[4 * r4 + 0] = fmaf(a, v.x, acc[4 * r4 + 0]);
                acc[4 * r4 + 1] = fmaf(a, v.y, acc[4 * r4 + 1]);
                acc[4 * r4 + 2] = fmaf(a, v.z, acc[4 * r4 + 2]);
                acc[4 * r4 + 3] = fmaf(a, v.w, acc[4 * r4 + 3]);
            }
        }
        __syncthreads();
    }

#undef FETCH
    const int64_t p = p0 + tid;
    const int64_t i = brow * bs + p;
    if (p < bs && i < n) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r0 + r < m) store(y + (r0 + r) * n + i, acc[r]);
        }
    }
}

template <typename TB, typename TX>
int launch(const void* blocks, const void* indptr, const void* cols,
           const void* x, void* y, int64_t bs, int64_t m, int64_t n,
           int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t nb = (n + bs - 1) / bs;
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t slabs = (bs + kThreads - 1) / kThreads;
    const int64_t grid = nb * groups * slabs;
    if (grid <= 0 || grid > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    bsr_rows_kernel<TB, TX><<<static_cast<unsigned int>(grid), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TB*>(blocks), static_cast<const int*>(indptr),
        static_cast<const int*>(cols), static_cast<const TX*>(x),
        static_cast<TX*>(y), bs, m, n, groups, slabs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BSR_ENTRY(name, TB, TX)                                             \
    extern "C" int name(const void* blocks, const void* indptr,             \
                        const void* cols, const void* x, void* y,           \
                        int64_t bs, int64_t m, int64_t n, int device,       \
                        void* stream) {                                     \
        return launch<TB, TX>(blocks, indptr, cols, x, y, bs, m, n, device, \
                              stream);                                      \
    }

// entry points: bsr_spmm_rows_<block type>_<operand type>
BSR_ENTRY(bsr_spmm_rows_f32_f32, float, float)
BSR_ENTRY(bsr_spmm_rows_f32_bf16, float, __nv_bfloat16)
BSR_ENTRY(bsr_spmm_rows_bf16_f32, __nv_bfloat16, float)
BSR_ENTRY(bsr_spmm_rows_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
