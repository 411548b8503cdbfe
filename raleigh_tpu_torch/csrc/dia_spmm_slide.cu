// DIA SpMM on row-layout operand blocks through ONE sliding shared-memory
// window per operand row, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_window.py::build_dia_window_slide, the
// variant of the sliding-window Pallas kernel that keeps one (m, T + H)
// window in VMEM, slides it by T lanes per grid step and fetches only the T
// new lanes, into a double-buffered stage, while the tile computes.  It
// computes what dia_spmm.cu computes,
//
//     y[r, i] = sum_k val[k, i] * x[r, i + off_k]      (terms with
//               i + off_k outside [0, n) are zero)
//
// for f32 val (noff, n) and f32 x, y (m, n), but reads x from device memory
// ONCE, through an explicitly staged window, where dia_spmm.cu leaves the
// shifted re-reads of x to L1 and L2.  The two are an A/B of that choice.
//
// What bounds it: memory, noff*n*4 + 2*m*n*4 bytes for 2*noff*m*n flops.
//
// What the design does about it:
//   * Persistent blocks, one wave.  A block owns kRows operand rows and a
//     contiguous segment of lanes, a whole number of tiles of T lanes, and
//     walks the segment tile by tile.
//   * Per row it keeps a CIRCULAR buffer of H + 2T lanes in shared memory
//     (H = lo + hi, the stencil's reach to the left and right): the window
//     [t0 - lo, t0 + T + hi) of the tile being computed, and the T lanes
//     that the next tile adds.  Sliding is an index, not a copy: nothing of
//     the overlap moves.
//   * Per step only the T new lanes are fetched, with cp.async (4 bytes, so
//     that no n, offset or pointer alignment is asked for), and they are in
//     flight while the current tile is computed from shared memory.  x
//     leaves device memory once per segment plus one halo of H lanes per
//     segment start.
//   * The diagonal shifts are offsets into the window: each thread owns
//     lanes of the tile and keeps kRows f32 accumulators, so one load of
//     val[k, i] serves kRows rows.  A wide reach leaves room for one block
//     per SM, so the block has 1024 threads and each starts its loads of val
//     for kBatch diagonals together before it sums them: nothing else hides
//     their latency.  val is read once per row group; with a
//     wide reach few rows fit in a block's 227 KB and val is read many
//     times, from L2 where the row groups of one segment run together.
//   * Products and sums are rounded separately (__fmul_rn, __fadd_rn) in the
//     order of the diagonals, the order of the plain PyTorch version, so the
//     two agree bit for bit.
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

struct Offsets {
    int v[kMaxOffsets];
};

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Starts the copies of lanes [g0, g1), clipped to [0, n), of `rows` operand
// rows into their circular windows of `cap` lanes; lane g0 lands at window
// index p0 < cap, and g1 - g0 <= cap.
template <int kRows>
__device__ __forceinline__ void fetch(float* win, int cap, const float* xr,
                                      int64_t n, int rows, int64_t g0,
                                      int64_t g1, int p0) {
    const int64_t a = g0 < 0 ? 0 : g0;
    const int64_t b = g1 < n ? g1 : n;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            const float* src = xr + r * n;
            float* dst = win + r * cap;
            for (int64_t g = a + threadIdx.x; g < b; g += kThreads) {
                int p = p0 + static_cast<int>(g - g0);
                if (p >= cap) p -= cap;
                cp_async4(dst + p, src + g);
            }
        }
    }
}

// Block b covers row group b % groups and lane segment b / groups.  Every
// thread commits one cp.async group per tile, empty after the segment's last
// fetch, so that wait_group<1> always means "this tile's window has landed".
template <int kRows>
__global__ void __launch_bounds__(kThreads)
slide_kernel(const float* __restrict__ val, const float* __restrict__ x,
             float* __restrict__ y, Offsets offs, int noff, int64_t m,
             int64_t n, int tile, int lo, int hi, int64_t seg_len,
             int64_t groups) {
    extern __shared__ __align__(16) float win[];
    const int cap = lo + hi + 2 * tile;
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t seg0 = (b / groups) * seg_len;
    const int64_t seg1 = seg0 + seg_len < n ? seg0 + seg_len : n;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;
    const float* xr = x + r0 * n;

    fetch<kRows>(win, cap, xr, n, rows, seg0 - lo, seg0 + tile + hi, 0);
    cp_async_commit();
    int wbase = 0;      // window index of lane t0 - lo
    for (int64_t t0 = seg0; t0 < seg1; t0 += tile) {
        if (t0 + tile < seg1) {
            // the T lanes the next tile adds; their slots held lanes the
            // previous tile was the last to read
            int p = wbase + tile + lo + hi;
            if (p >= cap) p -= cap;
            fetch<kRows>(win, cap, xr, n, rows, t0 + tile + hi,
                         t0 + 2 * static_cast<int64_t>(tile) + hi, p);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        for (int jj = threadIdx.x; jj < tile; jj += kThreads) {
            const int64_t i = t0 + jj;
            if (i >= seg1) break;
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
                    int q = wbase + jj + off + lo;
                    if (q >= cap) q -= cap;
                    p[u] = in ? q : -1;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    if (p[u] >= 0) {
#pragma unroll
                        for (int r = 0; r < kRows; ++r) {
                            if (r < rows) {
                                acc[r] = __fadd_rn(
                                    acc[r],
                                    __fmul_rn(v[u], win[r * cap + p[u]]));
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
        wbase += tile;
        if (wbase >= cap) wbase -= cap;
    }
}

template <int kRows>
cudaError_t launch(const float* val, const float* x, float* y,
                   const Offsets& offs, int noff, int64_t m, int64_t n,
                   int tile, int lo, int hi, int sms, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(kRows)
        * (static_cast<size_t>(lo) + hi + 2 * static_cast<size_t>(tile))
        * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        slide_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slide_kernel<kRows>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // one wave: as many segments as keep every resident block busy
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t tiles = (n + tile - 1) / tile;
    int64_t segments = static_cast<int64_t>(sms) * per_sm / groups;
    if (segments < 1) segments = 1;
    const int64_t per_segment = (tiles + segments - 1) / segments;
    segments = (tiles + per_segment - 1) / per_segment;
    const int64_t blocks = groups * segments;
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return cudaErrorInvalidConfiguration;
    }
    slide_kernel<kRows><<<static_cast<unsigned int>(blocks), kThreads, smem,
                          stream>>>(val, x, y, offs, noff, m, n, tile, lo,
                                    hi, per_segment * tile, groups);
    return cudaGetLastError();
}

}  // namespace

// offsets: noff ints on the HOST.  rows: operand rows per block, 1, 2, 4 or
// 8; rows * (lo + hi + 2 * tile) * 4 bytes of shared memory must fit a block.
extern "C" int dia_spmm_rows_slide_f32(const void* val, const void* x,
                                       void* y, const int* offsets,
                                       int64_t noff, int64_t m, int64_t n,
                                       int64_t tile, int rows, int device,
                                       void* stream) {
    if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
    if (noff < 0 || noff > kMaxOffsets || tile < 1 || tile > 0x3fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Offsets offs = {};
    int64_t lo = 0, hi = 0;
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t off = offsets[k];
        offs.v[k] = offsets[k];
        if (-off > lo) lo = -off;
        if (off > hi) hi = off;
    }
    if (lo + hi + 2 * tile > 0x3fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
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
    const int l = static_cast<int>(lo), h = static_cast<int>(hi);
    const int k = static_cast<int>(noff);
    switch (rows) {
        case 1: err = launch<1>(v, xf, yf, offs, k, m, n, t, l, h, sms, s);
                break;
        case 2: err = launch<2>(v, xf, yf, offs, k, m, n, t, l, h, sms, s);
                break;
        case 4: err = launch<4>(v, xf, yf, offs, k, m, n, t, l, h, sms, s);
                break;
        case 8: err = launch<8>(v, xf, yf, offs, k, m, n, t, l, h, sms, s);
                break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
