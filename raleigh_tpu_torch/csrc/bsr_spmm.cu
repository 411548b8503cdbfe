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
// cols[t]*bs + q >= n are read as zero; a block row with no tile writes
// zeros.  Every product and sum is an f32 fused multiply-add on the CUDA
// cores (no TF32, no tensor cores: the reference runs this product at full
// f32 precision); the result is rounded to the operand type once, on store.
//
// What bounds it, as measured.  The tiles are read once
// (nblocks*bs*bs*b bytes) for 2*nblocks*bs*bs*m flops.  At the FE-BSR shape
// (10,602 tiles of 128^2, m = 16) that is 0.213 ms of f32 tiles or 0.109 ms
// of bf16 tiles at 3.35 TB/s, and 0.083 ms of f32 FMA at 67 TFLOP/s.  The
// previous design, now the general path below, took 0.378 ms for either
// tile type on an H100, and 1.8 times as long at m = 24: its own
// instructions bounded it, not memory.  Each of its threads owns one tile
// row, stages every chunk through registers (a scalar load and a st.shared
// per value) and feeds 16 FMA with 5 shared-memory reads.
//
// What this design does about it:
//   * A warp owns the block row's 128-row slab and 16 operand rows; each
//     lane a register tile of 4 tile rows x 16 operand rows (64 f32
//     accumulators).  One 16-byte shared read brings 4 f32 or 8 bf16 tile
//     values of a row, one broadcast 16-byte read 4 values of an operand
//     row: 64 FMA for every 5 shared reads in f32, 128 for every 6 in bf16.
//   * Tiles reach shared memory by 16-byte cp.async, 64 bytes of every row
//     of the slab per chunk (16 f32 or 32 bf16 columns), in a ring of two
//     stages per warp: no registers, no st.shared, and the next chunk is
//     in flight while this one is contracted.  bf16 tiles stay bf16 in
//     shared memory, half the bytes from device memory, and become f32 on
//     the shared read.  A row of a stage is 80 bytes apart from the next,
//     so the 8 lanes of a 16-byte read phase hit 32 distinct banks.
//   * The warps of a block (8 for f32 tiles, 4 for bf16 tiles: eight warps
//     an SM either way, 180 or 96 KB of shared memory a block) share the
//     block row's chunks, chunk c to warp c % warps, and add their partial
//     sums once, at the end, through shared memory.  Each warp waits only
//     for its own copies: no block barrier inside the loop.  A warp walks
//     its chunks with a cursor (tile, column chunk), and a lane's copy and
//     load addresses are fixed for the block but for the chunk: no
//     division and little address arithmetic in the loop.
//   * The operand slab (16 rows x the chunk's columns, a few MB in all and
//     L2-resident) is loaded a chunk ahead into registers and stored to
//     shared memory as f32; x rows need no alignment.
//   * Operand-row groups of one block row are neighbouring blocks, so when
//     m > 16 the second group finds the tiles in L2; a group of 8 or fewer
//     rows takes a half-width register tile.
//   * The 16-byte path needs bs * sizeof(tile) % 16 == 0 and a 16-byte
//     aligned tile base.  Any other shape (bs = 3, 5, ...) takes the
//     general path below, which has no alignment limit.
//   * Index arithmetic is 64-bit; bs, m and n have no size limits (bs over
//     128 takes several row slabs).
// What is left, as measured (PERF.md): f32 FMA are about half of the
// loop's instructions; the rest are the copies' predicates and addresses,
// the operand slab's loads and register moves.
//
// The f64 instantiation (bsr_spmm_rows_f32_f64 / _f64_f64) serves the core
// Solver's f64 blocks: x and y f64, tiles f32 (the card's canonical
// storage) or f64, each value widened to f64 (exactly), every product and
// sum an IEEE f64 fused multiply-add.  The tiles are read once: at the
// FE-BSR shape (10,602 tiles of 128^2) 0.213 ms of f32 tiles or 0.420 ms
// of f64 tiles at 3.35 TB/s.  Its 2*nblocks*bs*bs*m flops, 2.78 GFLOP at
// m = 8 and 5.56 at m = 16, take 0.082 / 0.164 ms on the CUDA cores' 34
// TFLOP/s of f64 FMA, and 0.041 / 0.083 ms on the f64 tensor cores' 67.
// Its previous design, now the f64 general path below, is the f32 general
// path widened, a thread a tile row: 0.64 ms at m = 8 or 16 with either
// tile type, so neither bytes nor the FMA bounded it but its own
// instructions (16 FMA for 9 shared reads, two barriers a chunk).
//
// What the f64 design does about it (namespace wide):
//   * The products run on the f64 tensor cores, mma.sync m16n8k4 (an
//     sm_90 shape; the sm_80 m8n8k4 runs slower on an H100).  Tile rows
//     are M, tile columns K, operand rows N: 8 operand rows are one n8
//     tile, the core block exactly; a block takes 16 operand rows (two n8
//     tiles) or, with 8 or fewer left, 8.  Each lane reads 16 bytes of a
//     tile row from shared memory (4 f32 or 2 f64 values, widened in
//     registers) for as many k-steps: the k-steps take the chunk's columns
//     in the order the lanes read them, and the B fragments (x, in f64
//     straight from device memory, L2-resident) in the same order.
//   * Tiles reach shared memory as in the f32 design: 16-byte cp.async,
//     64 bytes of every row of the 128-row slab a chunk, here in a ring
//     of three stages per warp with rows 64 bytes apart (a 16-byte read
//     phase covers two whole rows: no bank conflict).  8 warps a block,
//     one block an SM (192 KB), so a lane may hold 255 registers: a
//     register tile of up to 128 accumulators.  More, smaller blocks (4
//     or 2 warps, 64- or 32-row slabs) were slower.
//   * The warps split a block row's chunks and add their partial sums
//     once at the end, in warp order, through shared memory.
//   * The widening (cvt.f64.f32, 16 a clock an SM) and the MMA run beside
//     the copies; bytes of tiles are what is left.
//   * The 16-byte path needs bs * sizeof(tile) % 16 == 0 and a 16-byte
//     aligned tile base; any other shape takes the general path, which
//     takes any bs and alignment.
// What is left, as measured (PERF.md): at m = 8 with f32 tiles 1.13 times
// the tiles' time at the card's measured stream rate; with f32 tiles the
// 16-row branch spills 52 bytes.
// The kernels allocate nothing and do not synchronise.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// ---- the kernel on the path ---------------------------------------------

constexpr int kSlab = 128;                 // tile rows a block: 4 a lane
constexpr int kRowsPerLane = kSlab / 32;
constexpr int kGroup = 16;                 // operand rows a block
constexpr int kChunkBytes = 64;            // bytes of every tile row a chunk
constexpr int kRowBytes = kChunkBytes + 16;   // stage row stride
constexpr int kUnits = kChunkBytes / 16;   // cp.async of one row's chunk
constexpr int kStageBytes = kSlab * kRowBytes;
constexpr int kStages = 2;                 // chunks in a warp's ring

// warps a block (they split a block row's chunks) and blocks an SM the
// registers are held to, by tile type
template <typename TB>
struct Occupancy;
template <>
struct Occupancy<float> {
    static constexpr int kWarps = 8;
    static constexpr int kMinBlocks = 1;
};
template <>
struct Occupancy<__nv_bfloat16> {
    static constexpr int kWarps = 4;
    static constexpr int kMinBlocks = 2;
};

// 16-byte copy to the shared-memory address dst; src_bytes = 0 fills
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(unsigned int dst,
                                           const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// tile values a 16-byte read brings, converted to f32
__device__ __forceinline__ void unpack16(const float* s, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* s, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        f[2 * k] = __uint_as_float(w[k] << 16);
        f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
}

// A warp's share of a block row's chunks (64 bytes of every row of the
// slab, tile by tile and column chunk by column chunk; chunk c goes to
// warp c % kWarps), walked by a cursor (tile, column chunk) with no
// division in the loop.
template <int kWarps>
struct Cursor {
    int64_t t;   // tile
    int q;       // column chunk
    int nq;      // column chunks a tile
    __device__ __forceinline__ void advance() {
        q += kWarps;
        while (q >= nq) {
            q -= nq;
            ++t;
        }
    }
};

// This warp's first chunk of block row brow (into first) and how many
// chunks it has: warp, warp + kWarps, ...
template <int kWarps>
__device__ __forceinline__ int warp_share(const int* __restrict__ indptr,
                                          int64_t brow, int nq, int warp,
                                          Cursor<kWarps>& first) {
    const int64_t t0 = indptr[brow];
    const int64_t nch = (indptr[brow + 1] - t0) * nq;
    first = Cursor<kWarps>{t0 + warp / nq, warp % nq, nq};
    return nch > warp
        ? static_cast<int>((nch - warp + kWarps - 1) / kWarps) : 0;
}

// A lane's 16-byte copies of a chunk into a stage of its warp's ring whose
// rows are kRowBytes apart: slab rows prow, prow + kRowStep, ..., part
// `part` of each row's chunk, zero past the tile; fixed for the block but
// the chunk.
template <typename TB, int kWarps, int kRowBytes>
struct ChunkCopy {
    static constexpr int kCols = kChunkBytes / sizeof(TB);
    static constexpr int kPerRead = 16 / sizeof(TB);
    static constexpr int kCopies = kSlab * kUnits / 32;
    static constexpr int kRowStep = 32 / kUnits;
    const TB* blocks;
    int64_t bs, tile_elems, src_lane, src_step;
    unsigned int sdst, rows_ok;
    int part;
    Cursor<kWarps> at;   // the next chunk to copy

    __device__ __forceinline__ ChunkCopy(const TB* blocks_, int64_t bs_,
                                         int64_t p0,
                                         const unsigned char* ring, int lane,
                                         Cursor<kWarps> first)
            : blocks(blocks_), bs(bs_), tile_elems(bs_ * bs_), at(first) {
        const int prow = lane / kUnits;
        part = lane % kUnits;
        sdst = static_cast<unsigned int>(__cvta_generic_to_shared(ring))
            + prow * kRowBytes + part * 16;
        src_lane = (p0 + prow) * bs + part * kPerRead;
        src_step = kRowStep * bs;
        rows_ok = 0;
#pragma unroll
        for (int k = 0; k < kCopies; ++k) {
            if (p0 + prow + k * kRowStep < bs) rows_ok |= 1u << k;
        }
    }

    // the chunk at the cursor into the stage `stage` bytes into the ring;
    // the cursor on to the warp's next chunk
    __device__ __forceinline__ void copy(unsigned int stage) {
        const int64_t q0 = static_cast<int64_t>(at.q) * kCols;
        const bool col_ok = q0 + part * kPerRead < bs;
        const TB* src = blocks + at.t * tile_elems + src_lane + q0;
        const unsigned int dst = sdst + stage;
#pragma unroll
        for (int k = 0; k < kCopies; ++k) {
            const bool ok = col_ok && ((rows_ok >> k) & 1u);
            cp_async16(dst + k * kRowStep * kRowBytes,
                       ok ? src + k * src_step : blocks, ok ? 16 : 0);
        }
        at.advance();
    }
};

template <typename TB, typename TX>
struct Layout {
    static constexpr int kWarps = Occupancy<TB>::kWarps;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kMinBlocks = Occupancy<TB>::kMinBlocks;
    static_assert(kThreads >= kSlab, "a block stores a slab row a thread");
    static constexpr int kCols = kChunkBytes / sizeof(TB);  // per chunk
    static constexpr int kPerRead = 16 / sizeof(TB);        // per LDS.128
    static constexpr int kXBytes = kGroup * kCols * 4;      // f32 slab
    static constexpr int kWarpBytes = kStages * kStageBytes + 2 * kXBytes;
    static constexpr int kReduceBytes = kWarps * kGroup * kSlab * 4;
    static constexpr int kSmem = kWarps * kWarpBytes > kReduceBytes
        ? kWarps * kWarpBytes : kReduceBytes;
};

// Block b covers operand-row group b % groups, tile-row slab
// (b / groups) % slabs and block row b / (groups * slabs).  kC operand
// rows of the group are computed (16, or 8 when 8 or fewer are left).
template <typename TB, typename TX, int kC>
__device__ __forceinline__ void bsr_block(
        unsigned char* smem, const TB* __restrict__ blocks,
        const int* __restrict__ indptr, const int* __restrict__ cols,
        const TX* __restrict__ x, TX* __restrict__ y, int64_t bs, int64_t m,
        int64_t n, int64_t r0, int64_t p0, int64_t brow) {
    using L = Layout<TB, TX>;
    constexpr int kWarps = L::kWarps;
    constexpr int kCols = L::kCols;
    constexpr int kPerRead = L::kPerRead;
    constexpr int kXLoads = kC * kCols / 32;   // operand values a lane
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    unsigned char* wbase = smem + warp * L::kWarpBytes;
    float* xbuf = reinterpret_cast<float*>(wbase + kStages * kStageBytes);

    // this warp's chunks, and cursors of the next chunk to copy (in
    // tiles) and of the next operand slab to load (xat)
    Cursor<kWarps> xat;
    const int mine = warp_share(
        indptr, brow, static_cast<int>((bs + kCols - 1) / kCols), warp, xat);
    ChunkCopy<TB, kWarps, kRowBytes> tiles(blocks, bs, p0, wbase, lane, xat);
    // the tile chunk of this warp's c-th chunk into stage c % kStages
    auto copy_tile = [&](int c) {
        if (c < mine) tiles.copy((c % kStages) * kStageBytes);
        cp_async_commit();   // an empty group keeps the count in step
    };

    // this lane's operand values: rows xrow, xrow + kXStep, ... of the
    // group, column xcol of the chunk (zero past m, bs, n)
    constexpr int kXStep = 32 / kCols;
    const int xrow = lane / kCols;
    const int xcol = lane % kCols;
    const int64_t x_lane = (r0 + xrow) * n + xcol;
    const int64_t x_step = kXStep * n;
    unsigned int xrows_ok = 0;
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
        if (r0 + xrow + k * kXStep < m) xrows_ok |= 1u << k;
    }
    TX xg[kXLoads];
    auto load_x = [&]() {
        const int64_t q0 = static_cast<int64_t>(xat.q) * kCols;
        const int64_t j0 = static_cast<int64_t>(cols[xat.t]) * bs + q0;
        const bool col_ok = q0 + xcol < bs && j0 + xcol < n;
        const TX* src = x + x_lane + j0;
#pragma unroll
        for (int k = 0; k < kXLoads; ++k) {
            const bool ok = col_ok && ((xrows_ok >> k) & 1u);
            xg[k] = ok ? src[k * x_step] : zero<TX>();
        }
        xat.advance();
    };
    auto store_x = [&](int c) {
        float* xs = xbuf + (c & 1) * (kGroup * kCols);
#pragma unroll
        for (int k = 0; k < kXLoads; ++k) xs[lane + 32 * k] = to_f32(xg[k]);
    };

    float acc[kRowsPerLane][kC];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
#pragma unroll
        for (int r = 0; r < kC; ++r) acc[j][r] = 0.0f;
    }

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) copy_tile(s);
    if (mine > 0) {
        load_x();
        store_x(0);
    }
    for (int c = 0; c < mine; ++c) {
        copy_tile(c + kStages - 1);
        if (c + 1 < mine) load_x();
        cp_async_wait<kStages - 1>();
        __syncwarp();
        const TB* st = reinterpret_cast<const TB*>(
            wbase + (c % kStages) * kStageBytes);
        const float* xs = xbuf + (c & 1) * (kGroup * kCols);
#pragma unroll 1
        for (int qg = 0; qg < kCols / kPerRead; ++qg) {
            float a[kRowsPerLane][kPerRead];
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
                unpack16(st + (lane + 32 * j) * (kRowBytes / sizeof(TB))
                             + qg * kPerRead,
                         a[j]);
            }
#pragma unroll
            for (int r = 0; r < kC; ++r) {
#pragma unroll
                for (int h = 0; h < kPerRead / 4; ++h) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        xs + r * kCols + qg * kPerRead + 4 * h);
                    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
#pragma unroll
                        for (int j = 0; j < kRowsPerLane; ++j) {
                            acc[j][r] = fmaf(a[j][4 * h + e], xv[e],
                                             acc[j][r]);
                        }
                    }
                }
            }
        }
        __syncwarp();   // every lane is done with this stage and slab
        if (c + 1 < mine) store_x(c + 1);
    }
    cp_async_wait<0>();

    // the warps' partial sums, added in warp order
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
#pragma unroll
        for (int r = 0; r < kC; ++r) {
            red[(warp * kGroup + r) * kSlab + lane + 32 * j] = acc[j][r];
        }
    }
    __syncthreads();
    const int64_t p = p0 + threadIdx.x;
    const int64_t i = brow * bs + p;
    if (threadIdx.x < kSlab && p < bs && i < n) {
#pragma unroll
        for (int r = 0; r < kC; ++r) {
            if (r0 + r < m) {
                float s = red[r * kSlab + threadIdx.x];
#pragma unroll
                for (int w = 1; w < kWarps; ++w) {
                    s += red[(w * kGroup + r) * kSlab + threadIdx.x];
                }
                store(y + (r0 + r) * n + i, s);
            }
        }
    }
}

template <typename TB, typename TX>
__global__ void __launch_bounds__(Layout<TB, TX>::kThreads,
                                  Layout<TB, TX>::kMinBlocks)
bsr_rows_kernel(const TB* __restrict__ blocks, const int* __restrict__ indptr,
                const int* __restrict__ cols, const TX* __restrict__ x,
                TX* __restrict__ y, int64_t bs, int64_t m, int64_t n,
                int64_t groups, int64_t slabs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kGroup;
    const int64_t p0 = ((b / groups) % slabs) * kSlab;
    const int64_t brow = b / (groups * slabs);
    if (m - r0 > 8) {
        bsr_block<TB, TX, 16>(smem, blocks, indptr, cols, x, y, bs, m, n, r0,
                              p0, brow);
    } else {
        bsr_block<TB, TX, 8>(smem, blocks, indptr, cols, x, y, bs, m, n, r0,
                             p0, brow);
    }
}

template <typename TB, typename TX>
int launch_general(const void* blocks, const void* indptr,
                   const void* cols, const void* x, void* y, int64_t bs,
                   int64_t m, int64_t n, int device, void* stream);

template <typename TB, typename TX>
int launch(const void* blocks, const void* indptr, const void* cols,
           const void* x, void* y, int64_t bs, int64_t m, int64_t n,
           int device, void* stream) {
    if (bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if ((bs * static_cast<int64_t>(sizeof(TB))) % 16 != 0
            || reinterpret_cast<uintptr_t>(blocks) % 16 != 0) {
        // the general path: no 16-byte rows to copy
        return launch_general<TB, TX>(blocks, indptr, cols, x, y, bs, m,
                                      n, device, stream);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t nb = (n + bs - 1) / bs;
    const int64_t groups = (m + kGroup - 1) / kGroup;
    const int64_t slabs = (bs + kSlab - 1) / kSlab;
    const int64_t grid = nb * groups * slabs;
    if (grid <= 0 || grid > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    constexpr int smem = Layout<TB, TX>::kSmem;
    // past 48 KB a kernel must ask for its dynamic shared memory, once on
    // each device
    static bool ready[64] = {};
    if (device >= 64 || !ready[device]) {
        err = cudaFuncSetAttribute(bsr_rows_kernel<TB, TX>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (device < 64) ready[device] = true;
    }
    bsr_rows_kernel<TB, TX><<<static_cast<unsigned int>(grid),
                              Layout<TB, TX>::kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TB*>(blocks), static_cast<const int*>(indptr),
        static_cast<const int*>(cols), static_cast<const TX*>(x),
        static_cast<TX*>(y), bs, m, n, groups, slabs);
    return static_cast<int>(cudaGetLastError());
}

// ---- the general path ---------------------------------------------------
//
// One thread a tile row, 16 operand rows a block, chunks of 32 columns
// staged through registers into shared memory.  It takes any bs and any
// alignment: the kernel above hands it the tiles it cannot copy in 16-byte
// rows.

namespace general {

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

}  // namespace general

template <typename TB, typename TX>
int launch_general(const void* blocks, const void* indptr,
                   const void* cols, const void* x, void* y, int64_t bs,
                   int64_t m, int64_t n, int device, void* stream) {
    return general::launch<TB, TX>(blocks, indptr, cols, x, y, bs, m, n,
                                   device, stream);
}

// ---- the f64 instantiation's general path --------------------------------
//
// The general path above widened: f64 operand and sums, f32 or f64 tiles,
// a thread a tile row.  It takes any bs and any alignment: the f64 kernel
// below hands it the tiles it cannot copy in 16-byte rows.

namespace wide_general {

constexpr int kThreads = 128;   // tile rows per thread block (one a thread)
constexpr int kRows = 16;       // operand rows per thread block
constexpr int kChunk = 32;      // tile columns staged at a time
constexpr int kTileStride = kChunk + 1;
constexpr int kSlabStride = kRows + 2;   // 16-byte aligned rows of f64
constexpr int kWarps = kThreads / 32;
constexpr int kTileLoads = kThreads / kWarps;        // rows a warp loads
constexpr int kSlabLoads = kChunk * kRows / kThreads;

__device__ __forceinline__ double to_f64(float v) {
    return static_cast<double>(v);
}
__device__ __forceinline__ double to_f64(double v) { return v; }

// Global loads of chunk c of a block row into registers, as in the
// general path, zero where the tile, the operand block or the matrix
// ends.
template <typename TB>
__device__ __forceinline__ void fetch_chunk(
        const TB* __restrict__ blocks, const int* __restrict__ cols,
        const double* __restrict__ x, int64_t bs, int64_t m, int64_t n,
        int64_t t0, int64_t nq, int64_t p0, int64_t r0, int64_t c,
        TB (&tile_g)[kTileLoads], double (&slab_g)[kSlabLoads]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t t = t0 + c / nq;
    const int64_t q = (c % nq) * kChunk + lane;
    const TB* tile = blocks + t * bs * bs;
#pragma unroll
    for (int k = 0; k < kTileLoads; ++k) {
        const int64_t p = p0 + warp + k * kWarps;
        tile_g[k] = (p < bs && q < bs) ? tile[p * bs + q] : TB(0);
    }
    const int64_t j = static_cast<int64_t>(cols[t]) * bs + q;
#pragma unroll
    for (int k = 0; k < kSlabLoads; ++k) {
        const int64_t r = r0 + warp + k * kWarps;
        slab_g[k] = (r < m && q < bs && j < n) ? x[r * n + j] : 0.0;
    }
}

// Thread block b covers operand-row group b % groups, tile-row slab
// (b / groups) % slabs and block row b / (groups * slabs).
template <typename TB>
__global__ void __launch_bounds__(kThreads, 2)
bsr_rows_kernel(const TB* __restrict__ blocks, const int* __restrict__ indptr,
                const int* __restrict__ cols, const double* __restrict__ x,
                double* __restrict__ y, int64_t bs, int64_t m, int64_t n,
                int64_t groups, int64_t slabs) {
    __shared__ double tile_s[kThreads * kTileStride];
    __shared__ __align__(16) double slab_s[kChunk * kSlabStride];

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

    double acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0;

    TB tile_g[kTileLoads];
    double slab_g[kSlabLoads];
    if (nchunks > 0) {
        fetch_chunk(blocks, cols, x, bs, m, n, t0, nq, p0, r0, 0, tile_g,
                    slab_g);
    }
    for (int64_t c = 0; c < nchunks; ++c) {
#pragma unroll
        for (int k = 0; k < kTileLoads; ++k) {
            tile_s[(warp + k * kWarps) * kTileStride + lane] =
                to_f64(tile_g[k]);
        }
#pragma unroll
        for (int k = 0; k < kSlabLoads; ++k) {
            slab_s[lane * kSlabStride + warp + k * kWarps] = slab_g[k];
        }
        __syncthreads();
        if (c + 1 < nchunks) {
            fetch_chunk(blocks, cols, x, bs, m, n, t0, nq, p0, r0, c + 1,
                        tile_g, slab_g);
        }
        const double* trow = tile_s + tid * kTileStride;
#pragma unroll 4
        for (int q = 0; q < kChunk; ++q) {
            const double a = trow[q];
            const double2* xs =
                reinterpret_cast<const double2*>(slab_s + q * kSlabStride);
#pragma unroll
            for (int r2 = 0; r2 < kRows / 2; ++r2) {
                const double2 v = xs[r2];
                acc[2 * r2 + 0] = fma(a, v.x, acc[2 * r2 + 0]);
                acc[2 * r2 + 1] = fma(a, v.y, acc[2 * r2 + 1]);
            }
        }
        __syncthreads();
    }

    const int64_t p = p0 + tid;
    const int64_t i = brow * bs + p;
    if (p < bs && i < n) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r0 + r < m) y[(r0 + r) * n + i] = acc[r];
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
    bsr_rows_kernel<TB><<<static_cast<unsigned int>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TB*>(blocks), static_cast<const int*>(indptr),
        static_cast<const int*>(cols), static_cast<const double*>(x),
        static_cast<double*>(y), bs, m, n, groups, slabs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wide_general

// ---- the f64 instantiation on the path ----------------------------------

namespace wide {

constexpr int kWarps = 8;                  // a block, one block an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 16;                 // operand rows a block: 2 n8 tiles
constexpr int kStages = 3;                 // chunks in a warp's ring
constexpr int kStageBytes = kSlab * kChunkBytes;   // rows 64 bytes apart
constexpr int kWarpBytes = kStages * kStageBytes;
constexpr int kMTiles = kSlab / 16;        // m16 tiles of the slab
constexpr int kRedStride = kSlab + 4;      // f64 partial sums of a row
constexpr int kSmem = kWarps * kWarpBytes;
static_assert(kWarps * kGroup * kRedStride * 8 <= kSmem,
              "the warps' partial sums fit in their rings");

// c += a b on the f64 tensor cores: A 16 x 4 (a0 row g, a1 row g + 8,
// column t), B 4 x 8 (row t, column g), C 16 x 8 (c0, c1 row g, c2, c3 row
// g + 8, columns 2t, 2t + 1), for lane 4g + t
__device__ __forceinline__ void mma16x8x4(double (&c)[4], double a0,
                                          double a1, double b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a0), "d"(a1), "d"(b));
}

// tile values a 16-byte shared read brings, widened to f64 (exactly)
__device__ __forceinline__ void widen16(const float* s, double* d) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
}
__device__ __forceinline__ void widen16(const double* s, double* d) {
    const double2 v = *reinterpret_cast<const double2*>(s);
    d[0] = v.x;
    d[1] = v.y;
}

// Block b covers operand-row group b % groups, tile-row slab
// (b / groups) % slabs and block row b / (groups * slabs); kNT n8 tiles of
// the group are computed (2, or 1 when 8 or fewer rows are left).
template <typename TB, int kNT>
__device__ __forceinline__ void bsr_block(
        unsigned char* smem, const TB* __restrict__ blocks,
        const int* __restrict__ indptr, const int* __restrict__ cols,
        const double* __restrict__ x, double* __restrict__ y, int64_t bs,
        int64_t m, int64_t n, int64_t r0, int64_t p0, int64_t brow) {
    constexpr int kCols = kChunkBytes / sizeof(TB);   // columns a chunk
    constexpr int kPerRead = 16 / sizeof(TB);   // k-steps a 16-byte read
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    unsigned char* ring = smem + warp * kWarpBytes;

    Cursor<kWarps> xat;   // the next B fragments to load
    const int mine = warp_share(
        indptr, brow, static_cast<int>((bs + kCols - 1) / kCols), warp, xat);
    ChunkCopy<TB, kWarps, kChunkBytes> tiles(blocks, bs, p0, ring, lane,
                                             xat);
    auto copy_tile = [&](int c) {
        if (c < mine) tiles.copy((c % kStages) * kStageBytes);
        cp_async_commit();   // an empty group keeps the count in step
    };

    // B fragments of a chunk: k-step j of n8 tile nt is x[r0 + 8 nt + g]
    // at the chunk's column kPerRead t + j (zero past m, bs, n), the
    // column this lane's A fragment of k-step j reads
    const double* x_lane = x + (r0 + g) * n + kPerRead * t;
    unsigned int xrows_ok = 0;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
        if (r0 + 8 * nt + g < m) xrows_ok |= 1u << nt;
    }
    double bx[kNT][kPerRead] = {}, bn[kNT][kPerRead] = {};
    auto load_x = [&](double (&b)[kNT][kPerRead]) {
        const int64_t q0 = static_cast<int64_t>(xat.q) * kCols + kPerRead * t;
        const int64_t j0 = static_cast<int64_t>(cols[xat.t]) * bs
            + static_cast<int64_t>(xat.q) * kCols;
        const double* src = x_lane + j0;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int j = 0; j < kPerRead; ++j) {
                const bool ok = ((xrows_ok >> nt) & 1u) && q0 + j < bs
                    && j0 + kPerRead * t + j < n;
                b[nt][j] = ok ? src[8 * nt * n + j] : 0.0;
            }
        }
        xat.advance();
    };

    double acc[kMTiles][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
        }
    }

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) copy_tile(s);
    if (mine > 0) load_x(bx);
    for (int c = 0; c < mine; ++c) {
        copy_tile(c + kStages - 1);
        if (c + 1 < mine) load_x(bn);
        cp_async_wait<kStages - 1>();
        __syncwarp();
        // this lane's A fragments: rows g and g + 8 of each m16 tile,
        // columns kPerRead t ... of the chunk
        const TB* st = reinterpret_cast<const TB*>(
            ring + (c % kStages) * kStageBytes) + g * kCols + kPerRead * t;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
            double lo[kPerRead], hi[kPerRead];
            widen16(st + 16 * mt * kCols, lo);
            widen16(st + (16 * mt + 8) * kCols, hi);
#pragma unroll
            for (int j = 0; j < kPerRead; ++j) {
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                    mma16x8x4(acc[mt][nt], lo[j], hi[j], bx[nt][j]);
                }
            }
        }
        __syncwarp();   // every lane is done with this stage
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int j = 0; j < kPerRead; ++j) bx[nt][j] = bn[nt][j];
        }
    }
    cp_async_wait<0>();

    // the warps' partial sums, added in warp order
    __syncthreads();
    double* red = reinterpret_cast<double*>(smem);
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = 8 * nt + 2 * t + (i & 1);
                const int p = 16 * mt + g + 8 * (i >> 1);
                red[(warp * kGroup + r) * kRedStride + p] = acc[mt][nt][i];
            }
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 8 * kNT * kSlab; e += kThreads) {
        const int p = e % kSlab;
        const int r = e / kSlab;
        const int64_t i = brow * bs + p0 + p;
        if (p0 + p < bs && i < n && r0 + r < m) {
            double s = red[r * kRedStride + p];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) {
                s += red[(w * kGroup + r) * kRedStride + p];
            }
            y[(r0 + r) * n + i] = s;
        }
    }
}

template <typename TB>
__global__ void __launch_bounds__(kThreads, 1)
bsr_rows_kernel(const TB* __restrict__ blocks, const int* __restrict__ indptr,
                const int* __restrict__ cols, const double* __restrict__ x,
                double* __restrict__ y, int64_t bs, int64_t m, int64_t n,
                int64_t groups, int64_t slabs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kGroup;
    const int64_t p0 = ((b / groups) % slabs) * kSlab;
    const int64_t brow = b / (groups * slabs);
    if (m - r0 > 8) {
        bsr_block<TB, 2>(smem, blocks, indptr, cols, x, y, bs, m, n, r0, p0,
                         brow);
    } else {
        bsr_block<TB, 1>(smem, blocks, indptr, cols, x, y, bs, m, n, r0, p0,
                         brow);
    }
}

template <typename TB, typename TX>
int launch(const void* blocks, const void* indptr, const void* cols,
           const void* x, void* y, int64_t bs, int64_t m, int64_t n,
           int device, void* stream) {
    if (bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if ((bs * static_cast<int64_t>(sizeof(TB))) % 16 != 0
            || reinterpret_cast<uintptr_t>(blocks) % 16 != 0) {
        // the general path: no 16-byte rows to copy
        return wide_general::launch<TB, TX>(blocks, indptr, cols, x, y, bs,
                                            m, n, device, stream);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t nb = (n + bs - 1) / bs;
    const int64_t groups = (m + kGroup - 1) / kGroup;
    const int64_t slabs = (bs + kSlab - 1) / kSlab;
    const int64_t grid = nb * groups * slabs;
    if (grid <= 0 || grid > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    // past 48 KB a kernel must ask for its dynamic shared memory, once on
    // each device
    static bool ready[64] = {};
    if (device >= 64 || !ready[device]) {
        err = cudaFuncSetAttribute(bsr_rows_kernel<TB>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (device < 64) ready[device] = true;
    }
    bsr_rows_kernel<TB><<<static_cast<unsigned int>(grid), kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TB*>(blocks), static_cast<const int*>(indptr),
        static_cast<const int*>(cols), static_cast<const double*>(x),
        static_cast<double*>(y), bs, m, n, groups, slabs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

}  // namespace

#define BSR_ENTRY(name, impl, TB, TX)                                       \
    extern "C" int name(const void* blocks, const void* indptr,             \
                        const void* cols, const void* x, void* y,           \
                        int64_t bs, int64_t m, int64_t n, int device,       \
                        void* stream) {                                     \
        return impl<TB, TX>(blocks, indptr, cols, x, y, bs, m, n, device,   \
                            stream);                                        \
    }

// entry points: bsr_spmm_rows_<block type>_<operand type>
BSR_ENTRY(bsr_spmm_rows_f32_f32, launch, float, float)
BSR_ENTRY(bsr_spmm_rows_f32_bf16, launch, float, __nv_bfloat16)
BSR_ENTRY(bsr_spmm_rows_bf16_f32, launch, __nv_bfloat16, float)
BSR_ENTRY(bsr_spmm_rows_bf16_bf16, launch, __nv_bfloat16, __nv_bfloat16)
BSR_ENTRY(bsr_spmm_rows_f32_f64, wide::launch, float, double)
BSR_ENTRY(bsr_spmm_rows_f64_f64, wide::launch, double, double)
