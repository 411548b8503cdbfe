// DIA SpMM on row-layout operand blocks through a shared-memory ring of four
// whole lane tiles per operand row, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_window.py::build_dia_window_tiles, the
// variant of the sliding-window Pallas kernel with NO halo copy: a rolling
// ring of four whole (m, T) tiles in VMEM, each fetched from HBM once;
// output tile t reads tiles t - 1, t and t + 1, and every diagonal is at
// most two slices split at a tile boundary.  Needs max|offset| <= T.  It
// computes what dia_spmm.cu computes,
//
//     y[r, i] = sum_k val[k, i] * x[r, i + off_k]      (terms with
//               i + off_k outside [0, n) are zero)
//
// for f32 val (noff, n) and f32 x, y (m, n), reading x from device memory
// once through explicitly staged tiles, where dia_spmm.cu leaves the shifted
// re-reads of x to L1 and L2.
//
// What bounds it: memory, noff*n*4 + 2*m*n*4 bytes for 2*noff*m*n flops.
//
// What the design does about it:
//   * Persistent blocks, one wave.  A block owns kRows operand rows and a
//     run of consecutive tiles; tiles sit at absolute multiples of T, so tile
//     t of a row always lives in ring slot t % 4.
//   * The ring holds tiles t - 1, t, t + 1 of the output tile in work and
//     tile t + 2, whose copy (into the slot tile t - 2 left) is in flight
//     while tile t is computed.  A shifted lane is found by ring arithmetic:
//     lane jj + off of the current tile, or of its left or right neighbour
//     when the sum leaves [0, T).  No halo is copied and nothing moves inside
//     shared memory; a run of tiles costs two extra tiles at its start.
//   * Tiles are whole, contiguous and at fixed slots, which is what wide
//     copies want: 16-byte cp.async when n and T are multiples of 4 and x is
//     16-byte aligned (kVec), 4-byte cp.async for every other shape.
//   * Each thread owns lanes of the tile and keeps kRows f32 accumulators, so
//     one load of val[k, i] serves kRows rows.  A wide reach leaves room for
//     one block per SM, so the block has 1024 threads and each starts its
//     loads of val for kBatch diagonals together before it sums them:
//     nothing else hides their latency.  With T >= max|offset| the
//     ring of one row is 16 T bytes: few rows fit a block's 227 KB when the
//     reach is wide, and val is then read once per row group, from L2 where
//     the row groups of one run of tiles run together.
//   * Products and sums are rounded separately (__fmul_rn, __fadd_rn) in the
//     order of the diagonals, the order of the plain PyTorch version, so the
//     two agree bit for bit (the Pallas kernel sums aligned and unaligned
//     offsets apart and does not).
//   * The offsets travel as a kernel argument (constant memory), at most
//     kMaxOffsets of them.
// The kernel allocates nothing and does not synchronise the device.  The
// entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxOffsets = 128;
constexpr int kBatch = 8;
constexpr int kRing = 4;

struct Offsets {
    int v[kMaxOffsets];
};

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* src) {
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

// Starts the copy of tile t (its lanes below n) of `rows` operand rows into
// ring slot t % 4; a tile wholly outside [0, n) is left alone, since no term
// that would read it is summed.
template <int kRows, bool kVec>
__device__ __forceinline__ void fetch_tile(float* ring, int tile,
                                           const float* xr, int64_t n,
                                           int rows, int64_t t) {
    if (t < 0 || t * tile >= n) return;
    const int64_t g0 = t * tile;
    const int width = n - g0 < tile ? static_cast<int>(n - g0) : tile;
    const int slot = static_cast<int>(t % kRing);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            const float* src = xr + r * n + g0;
            float* dst = ring + (r * kRing + slot) * tile;
            if (kVec) {
                for (int q = 4 * threadIdx.x; q < width; q += 4 * kThreads) {
                    cp_async16(dst + q, src + q);
                }
            } else {
                for (int q = threadIdx.x; q < width; q += kThreads) {
                    cp_async4(dst + q, src + q);
                }
            }
        }
    }
}

// Block b covers row group b % groups and the tiles [ta, tb) of run
// b / groups.  Every thread commits one cp.async group per tile, empty after
// the run's last fetch, so that wait_group<1> always means "tiles t - 1, t
// and t + 1 have landed".
template <int kRows, bool kVec>
__global__ void __launch_bounds__(kThreads)
tiles_kernel(const float* __restrict__ val, const float* __restrict__ x,
             float* __restrict__ y, Offsets offs, int noff, int64_t m,
             int64_t n, int tile, int64_t tiles, int64_t per_run,
             int64_t groups) {
    extern __shared__ __align__(16) float ring[];
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t ta = (b / groups) * per_run;
    const int64_t tb = ta + per_run < tiles ? ta + per_run : tiles;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;
    const float* xr = x + r0 * n;

    fetch_tile<kRows, kVec>(ring, tile, xr, n, rows, ta - 1);
    fetch_tile<kRows, kVec>(ring, tile, xr, n, rows, ta);
    fetch_tile<kRows, kVec>(ring, tile, xr, n, rows, ta + 1);
    cp_async_commit();
    for (int64_t t = ta; t < tb; ++t) {
        if (t + 1 < tb) {
            // tile t + 1's right neighbour, into the slot of tile t - 2,
            // which tile t - 1 was the last to read
            fetch_tile<kRows, kVec>(ring, tile, xr, n, rows, t + 2);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int slot = static_cast<int>(t % kRing);
        const int64_t t0 = t * tile;
        for (int jj = threadIdx.x; jj < tile; jj += kThreads) {
            const int64_t i = t0 + jj;
            if (i >= n) break;
            float acc[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
            // kBatch diagonals at a time: their loads of val are started
            // together, then summed in order; p < 0 marks a term that is
            // not summed (past the diagonals, or outside [0, n))
            for (int k0 = 0; k0 < noff; k0 += kBatch) {
                float v[kBatch];
                int p[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int k = k0 + u;
                    const int off = k < noff ? offs.v[k] : 0;
                    const int64_t g = i + off;
                    const bool in = k < noff && g >= 0 && g < n;
                    v[u] = in ? val[k * n + i] : 0.0f;
                    // |off| <= tile: the lane is in this tile or in a
                    // neighbour, one ring slot to the left or right
                    int q = jj + off;
                    int s = slot;
                    if (q < 0) {
                        q += tile;
                        s = (slot + kRing - 1) % kRing;
                    } else if (q >= tile) {
                        q -= tile;
                        s = (slot + 1) % kRing;
                    }
                    p[u] = in ? s * tile + q : -1;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    if (p[u] >= 0) {
#pragma unroll
                        for (int r = 0; r < kRows; ++r) {
                            if (r < rows) {
                                acc[r] = __fadd_rn(
                                    acc[r],
                                    __fmul_rn(v[u],
                                              ring[r * kRing * tile + p[u]]));
                            }
                        }
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r < rows) y[(r0 + r) * n + i] = acc[r];
            }
        }
        __syncthreads();
    }
}

template <int kRows, bool kVec>
cudaError_t launch(const float* val, const float* x, float* y,
                   const Offsets& offs, int noff, int64_t m, int64_t n,
                   int tile, int sms, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(kRows) * kRing
        * static_cast<size_t>(tile) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        tiles_kernel<kRows, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tiles_kernel<kRows, kVec>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // one wave: as many runs of tiles as keep every resident block busy
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t tiles = (n + tile - 1) / tile;
    int64_t runs = static_cast<int64_t>(sms) * per_sm / groups;
    if (runs < 1) runs = 1;
    const int64_t per_run = (tiles + runs - 1) / runs;
    runs = (tiles + per_run - 1) / per_run;
    const int64_t blocks = groups * runs;
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return cudaErrorInvalidConfiguration;
    }
    tiles_kernel<kRows, kVec><<<static_cast<unsigned int>(blocks), kThreads,
                                smem, stream>>>(val, x, y, offs, noff, m, n,
                                                tile, tiles, per_run,
                                                groups);
    return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch(int rows, const float* val, const float* x, float* y,
                     const Offsets& offs, int noff, int64_t m, int64_t n,
                     int tile, int sms, cudaStream_t stream) {
    switch (rows) {
        case 1: return launch<1, kVec>(val, x, y, offs, noff, m, n, tile,
                                       sms, stream);
        case 2: return launch<2, kVec>(val, x, y, offs, noff, m, n, tile,
                                       sms, stream);
        case 4: return launch<4, kVec>(val, x, y, offs, noff, m, n, tile,
                                       sms, stream);
        case 8: return launch<8, kVec>(val, x, y, offs, noff, m, n, tile,
                                       sms, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// offsets: noff ints on the HOST, each at most `tile` in size.  rows: operand
// rows per block, 1, 2, 4 or 8; rows * 4 * tile * 4 bytes of shared memory
// must fit a block.
extern "C" int dia_spmm_rows_tiles_f32(const void* val, const void* x,
                                       void* y, const int* offsets,
                                       int64_t noff, int64_t m, int64_t n,
                                       int64_t tile, int rows, int device,
                                       void* stream) {
    if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
    if (noff < 0 || noff > kMaxOffsets || tile < 1 || tile > 0x0fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Offsets offs = {};
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t off = offsets[k];
        if (off > tile || -off > tile) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        offs.v[k] = offsets[k];
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* v = static_cast<const float*>(val);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int t = static_cast<int>(tile);
    const int k = static_cast<int>(noff);
    const bool vec = n % 4 == 0 && tile % 4 == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    err = vec ? dispatch<true>(rows, v, xf, yf, offs, k, m, n, t, sms, s)
              : dispatch<false>(rows, v, xf, yf, offs, k, m, n, t, sms, s);
    return static_cast<int>(err);
}
