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
// What bounds it: memory, noff*n*4 + 2*m*n*4 bytes for 2*noff*m*n flops
// (0.060 ms at the tile sweep's shape, lap3d 100x100x128, m = 16, on an
// H100).  The previous design (PERF.md; deleted since) held two rows a
// block at T = 4,096 (110 KB of window a row), read val from L2 in every
// block, copied x with 4-byte cp.async fenced by two block barriers a
// tile, and took 0.2429 ms.
//
// What this design does about it (chosen on the H100 among variants that
// the comments below name):
//   * val by multicast.  The blocks that hold the row groups of one run of
//     tiles (a segment) form thread-block clusters of kClusterBlocks = 2.
//     val comes in chunks of at most 2,048 lanes into two stages in every
//     block: the cluster's rank 0 copies each chunk's noff rows once, with
//     bulk copies multicast to both blocks
//     (cp.async.bulk ... multicast::cluster), so val leaves L2 once per
//     cluster.  A stage is refilled once both blocks have read it: each
//     block arrives once on rank 0's "empty" barrier through the cluster's
//     shared memory (mapa) after its consumers pass a named barrier, and
//     each block arms its own "full" barrier with the bytes it expects.
//     Clusters of 4, 8 and 16 blocks ran slower (16: the multicast to 16
//     blocks could not keep up), and clusters of 1 (no multicast) slower
//     too.  The launch (cudaLaunchKernelEx) takes the number of segments
//     from cudaOccupancyMaxActiveClusters.  With the stages beside it, a
//     window of T = 4,096 leaves room for one row a block, not two: val
//     enters the SMs once per row, and the wider chunk pays for that.
//   * x by TMA bulk copies under mbarriers.  Per row a CIRCULAR buffer of
//     cap = lo + hi + 2T lanes (lo, hi: the stencil's reach to the left
//     and right, rounded up to 4 lanes so that every copy starts on 16
//     bytes) holds lane L at position L mod cap: the window
//     [t0 - lo, t0 + T + hi) of the tile being computed and the T lanes the
//     next tile adds.  Sliding is an index, not a copy.  Producer warp
//     thread 1 copies the first window, then the T new lanes of each step
//     (two bulk copies where they wrap), in flight while the tile is
//     computed; thread 0 issues the val chunks.  A full/empty barrier pair
//     per step's parity replaces the block barriers.  x leaves device
//     memory once per segment plus one halo of lo + hi lanes per segment
//     start.
//   * 512 consumer threads, four lanes each: val as one 16-byte shared read
//     from the stage, x as one aligned quad when the offset is a multiple
//     of 4 and as two with a register shift otherwise, as dia_spmm.cu does.
//     Quads at an edge of [0, n) go lane by lane.  Fewer threads (256), one
//     lane a thread (992 threads), and starting the reads of 2 to 8
//     diagonals before their sums all ran slower.
//   * Where no stage of val of MIN_CHUNK_LANES (ops/spmm_window.py) fits
//     beside the windows, the consumers read val from device memory, four
//     lanes a thread with 16-byte loads, in a cluster of one block.  This
//     is a per-shape branch of the same kernel (kStage false), chosen by
//     the wrapper and passed as chunk = 0.
//   * Shapes a bulk copy cannot take (n or T not a multiple of 4, an
//     operand not 16-byte aligned) take a third branch of the same kernel:
//     the producer warp's 32 threads copy x with 4-byte cp.async that
//     arrive on the same barriers (cp.async.mbarrier.arrive.noinc), the
//     consumers read val from device memory one lane a thread, and the
//     cluster is one block.
//   * What the two kernels share (the copy and barrier helpers, the val
//     chunks, the consumers' sums over a tile, the cluster launch) is in
//     staged_window.cuh; this source holds the x-copy schedule.
//   * Products and sums are rounded separately (__fmul_rn, __fadd_rn) in the
//     order of the diagonals, the order of the plain PyTorch version, so the
//     two agree bit for bit.
//   * The offsets travel as a kernel argument (constant memory), at most
//     kMaxOffsets of them.
//   * Every barrier wait traps after about 10 s instead of hanging the card.
// At T = 4,096 it takes 0.1463 ms there, 1.66 times faster than the
// previous design in turns, and 1.35 times K1's time (dia_spmm.cu): the
// consumers' shared reads and sums, not device memory, bound it.  At
// T = 16,384 no stage of 800 lanes fits beside the window and val comes
// from device memory: 0.2850 ms against the previous design's 0.2965.
//
// The kernels allocate nothing and do not synchronise the device.  Each
// entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "staged_window.cuh"

namespace {

// barriers, by slot in the first kBarrierBytes of shared memory
constexpr int kXFull = 0;       // 2 barriers, by step parity: lanes landed
constexpr int kXEmpty = 2;      // 2, by tile parity: a tile is done
constexpr int kVFull = 4;       // kStages: a val chunk has landed
constexpr int kVEmpty = kVFull + kStages;   // kStages (rank 0's): every
                                            // block has read it

// ---- the kernel: bulk copies, val multicast across a cluster -----------

// Block rank c of cluster q holds row group (q % cps) * size + c (rows may
// be 0 in the last cluster of a segment: it still reads every val chunk)
// and the tiles [ta, tb) of segment q / cps.  The producer warp loads step
// u = 0, 1, ... (the first window, then the T lanes tile ta + u adds) on
// barrier u % 2 (step u + 1 once tile ta + u - 1 is done), and (kStage) the
// val chunks j = 0, 1, ... of the segment's tiles in order into stage
// j % kStages.  lo, hi: multiples of 4 (the entry point rounds them).
template <int kRows, bool kVec, bool kStage>
__global__ void __launch_bounds__(kThreads, 1)
slide_kernel(const float* __restrict__ val, const float* __restrict__ x,
             float* __restrict__ y, Offsets offs, int noff, int64_t m,
             int64_t n, int tile, int chunk, int lo, int hi, int64_t tiles,
             int64_t per_seg, int cps) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t bar0 = smem_addr(smem);
    auto bar = [&](int slot) { return bar0 + 8 * slot; };
    float* win = reinterpret_cast<float*>(smem + kBarrierBytes);
    const int cap = lo + hi + 2 * tile;
    float* stage = win + kRows * cap;
    const uint32_t size = cluster_blocks();
    const uint32_t rank = cluster_rank();
    const int64_t q = blockIdx.x / size;
    const int64_t r0 = ((q % cps) * size + rank) * kRows;
    const int rows = r0 >= m ? 0 : (m - r0 < kRows ? static_cast<int>(m - r0)
                                                   : kRows);
    const int64_t ta = (q / cps) * per_seg;
    const int64_t tb = ta + per_seg < tiles ? ta + per_seg : tiles;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // window position of lane g >= -lo
    auto pos = [&](int64_t g) {
        return static_cast<int>(((g % cap) + cap) % cap);
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < 2; ++s) {
            barrier_init(bar(kXFull + s), kVec ? 1 : 32);
            barrier_init(bar(kXEmpty + s), 1);
        }
        for (int s = 0; s < kStages; ++s) {
            barrier_init(bar(kVFull + s), 1);
            barrier_init(bar(kVEmpty + s), size);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // every barrier of the cluster is set before any copy or arrival
    cluster_sync();

    if (warp == kWarps) {
        // The producer warp: x by its thread 1 (bulk copies) or by all 32
        // (per-thread copies), val by its thread 0, each in its own order.
        if (kVec ? lane == 1 : true) {
            auto load_step = [&](int64_t u) {
                if (u >= 2) {
                    // its lanes' slots were last read by tile ta + u - 2
                    barrier_wait<true>(bar(kXEmpty + ((u - 2) & 1)),
                                       ((u - 2) >> 1) & 1);
                }
                const uint32_t full = bar(kXFull + (u & 1));
                const int64_t t0 = (ta + u) * tile;
                int64_t a = u == 0 ? t0 - lo : t0 + hi;
                int64_t b = t0 + tile + hi;
                a = a < 0 ? 0 : a;
                b = b < n ? b : n;
                const int len = rows == 0 || a >= b ? 0
                                                    : static_cast<int>(b - a);
                const int pa = pos(a);
                if (kVec) {
                    if (len == 0) {
                        barrier_arrive(full);
                        return;
                    }
                    expect_bytes(full, rows * len * 4);
                    // two copies where the lanes wrap round the window
                    const int first = cap - pa < len ? cap - pa : len;
                    for (int r = 0; r < rows; ++r) {
                        const float* src = x + (r0 + r) * n + a;
                        float* dst = win + r * cap;
                        bulk_load(smem_addr(dst + pa), src, first * 4, full);
                        if (first < len) {
                            bulk_load(smem_addr(dst), src + first,
                                      (len - first) * 4, full);
                        }
                    }
                } else {
                    for (int r = 0; r < rows; ++r) {
                        for (int c = lane; c < len; c += 32) {
                            const int p = pa + c;
                            cp_async4(win + r * cap + (p >= cap ? p - cap : p),
                                      x + (r0 + r) * n + a + c);
                        }
                    }
                    cp_async_arrive(full);
                }
            };
            // step u + 1 once tile ta + u - 1 is done
            for (int64_t u = 0; u < tb - ta; ++u) load_step(u);
        } else if (kStage && lane == 0) {
            load_val_chunks(val, n, stage, noff, chunk, ta * tile,
                            tb * tile < n ? tb * tile : n, tile, rank, size,
                            bar(kVFull), bar(kVEmpty));
        }
    } else {
        int lo_off, hi_off;
        offset_extent(offs, noff, &lo_off, &hi_off);
        int64_t j = 0;
        for (int64_t t = ta; t < tb; ++t) {
            const int64_t u = t - ta;
            barrier_wait<true>(bar(kXFull + (u & 1)), (u >> 1) & 1);
            const int64_t t0 = t * tile;
            const int width = n - t0 < tile ? static_cast<int>(n - t0) : tile;
            consume_tile<kRows, kVec, kStage>(
                val, y, offs, noff, n, win, cap,
                pos(t0 - lo) + lo /* of lane t0; < 2 cap */, stage, chunk,
                r0, rows, t0, width, lo_off, hi_off, bar(kVFull),
                bar(kVEmpty), bar(kXEmpty + (u & 1)), j);
        }
    }
    // no block leaves while another may still arrive on its barriers
    cluster_sync();
}

// The operands of one call; lo, hi as the kernel takes them.
struct Call {
    const float* val;
    const float* x;
    float* y;
    Offsets offs;
    int noff;
    int64_t m, n;
    int tile, chunk, lo, hi;
};

// Launches the kernel on `stream`, or with `query` fills it with the plan
// the launch would take and launches nothing.
template <int kRows, bool kVec, bool kStage>
cudaError_t launch(const Call& a, cudaStream_t stream, ClusterPlan* query) {
    auto kernel = slide_kernel<kRows, kVec, kStage>;
    const size_t smem = kBarrierBytes
        + sizeof(float) * (static_cast<size_t>(kRows)
                           * (static_cast<size_t>(a.lo) + a.hi + 2 * a.tile)
                           + (kStage ? static_cast<size_t>(kStages) * a.noff
                                           * a.chunk : 0));
    const int64_t groups = (a.m + kRows - 1) / kRows;
    const int64_t tiles = (a.n + a.tile - 1) / a.tile;
    // kClusterBlocks row groups a cluster where they share val chunks
    const int c = kStage && groups > 1 ? kClusterBlocks : 1;
    static ActiveClusters cache;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    ClusterPlan p;
    cudaError_t err = plan_clusters(kernel, smem, c, groups, tiles, stream,
                                    &cache, &cfg, &attr, &p);
    if (err != cudaSuccess) return err;
    if (query != nullptr) {
        *query = p;
        return cudaSuccess;
    }
    err = cudaLaunchKernelEx(&cfg, kernel, a.val, a.x, a.y, a.offs, a.noff,
                             a.m, a.n, a.tile, a.chunk, a.lo, a.hi, tiles,
                             p.per, static_cast<int>(p.cps));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool kVec, bool kStage>
cudaError_t dispatch(int rows, const Call& a, cudaStream_t stream,
                     ClusterPlan* query) {
    switch (rows) {
        case 1: return launch<1, kVec, kStage>(a, stream, query);
        case 2: return launch<2, kVec, kStage>(a, stream, query);
        case 4: return launch<4, kVec, kStage>(a, stream, query);
        case 8: return launch<8, kVec, kStage>(a, stream, query);
        default: return cudaErrorInvalidValue;
    }
}

// The branch: bulk copies with (chunk > 0) or without a stage of val, or
// per-thread copies.
cudaError_t run(bool vec, int rows, const Call& a, cudaStream_t stream,
                ClusterPlan* query) {
    if (!vec) return dispatch<false, false>(rows, a, stream, query);
    return a.chunk > 0 ? dispatch<true, true>(rows, a, stream, query)
                       : dispatch<true, false>(rows, a, stream, query);
}

// The checks both entry points make: offsets to `offs`, and the reach to
// the left and right, each rounded up to a multiple of 4.
cudaError_t read_offsets(const int* offsets, int64_t noff, int64_t tile,
                         Offsets* offs, int* lo, int* hi) {
    if (noff < 0 || noff > kMaxOffsets || tile < 1 || tile > 0x3fffffffLL) {
        return cudaErrorInvalidValue;
    }
    *offs = {};
    int64_t l = 0, h = 0;
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t off = offsets[k];
        offs->v[k] = offsets[k];
        if (-off > l) l = -off;
        if (off > h) h = off;
    }
    l = (l + 3) / 4 * 4;
    h = (h + 3) / 4 * 4;
    if (l + h + 2 * tile > 0x3fffffffLL) return cudaErrorInvalidValue;
    *lo = static_cast<int>(l);
    *hi = static_cast<int>(h);
    return cudaSuccess;
}

}  // namespace

// offsets: noff ints on the HOST.  rows: operand rows per block, 1, 2, 4 or
// 8; chunk: lanes of val per stage, a multiple of 4, or 0 for no stage (val
// read from global memory).  With lo and hi the reach to the left and
// right rounded up to a multiple of 4, 256 + rows * (lo + hi + 2 * tile) * 4
// + 2 * noff * chunk * 4 bytes of shared memory must fit a block on the
// bulk-copy branch, 256 + rows * (lo + hi + 2 * tile) * 4 on the others.
extern "C" int dia_spmm_rows_slide_f32(const void* val, const void* x,
                                       void* y, const int* offsets,
                                       int64_t noff, int64_t m, int64_t n,
                                       int64_t tile, int64_t chunk, int rows,
                                       int device, void* stream) {
    if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
    Call a = {static_cast<const float*>(val), static_cast<const float*>(x),
              static_cast<float*>(y), {}, static_cast<int>(noff), m, n,
              static_cast<int>(tile), static_cast<int>(chunk), 0, 0};
    cudaError_t err = read_offsets(offsets, noff, tile, &a.offs, &a.lo,
                                   &a.hi);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!chunk_ok(chunk)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = bulk_shape(n, tile, reinterpret_cast<uintptr_t>(val)
                                | reinterpret_cast<uintptr_t>(x)
                                | reinterpret_cast<uintptr_t>(y));
    if (!vec) a.chunk = 0;
    return static_cast<int>(
        run(vec, rows, a, static_cast<cudaStream_t>(stream), nullptr));
}

// The launch plan dia_spmm_rows_slide_f32 takes for these shapes on the
// bulk-copy branch (bulk != 0) or the per-thread one, into kPlanSlots
// int64s on the HOST: cluster size, clusters that fit the card at once,
// clusters per segment, segments, blocks.  Launches nothing.
extern "C" int dia_spmm_rows_slide_plan(const int* offsets, int64_t noff,
                                        int64_t m, int64_t n, int64_t tile,
                                        int64_t chunk, int rows, int bulk,
                                        int device, int64_t* plan) {
    if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Call a = {nullptr, nullptr, nullptr, {}, static_cast<int>(noff), m, n,
              static_cast<int>(tile), bulk ? static_cast<int>(chunk) : 0, 0,
              0};
    cudaError_t err = read_offsets(offsets, noff, tile, &a.offs, &a.lo,
                                   &a.hi);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!chunk_ok(chunk)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    ClusterPlan p;
    err = run(bulk != 0, rows, a, nullptr, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
    report_plan(p, plan);
    return static_cast<int>(cudaSuccess);
}
