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
// What bounds it: memory, noff*n*4 + 2*m*n*4 bytes for 2*noff*m*n flops
// (0.060 ms at the tile sweep's shape, lap3d 100x100x128, m = 16, on an
// H100).  But with T = 10,240 the ring of one row takes 160 KB, so a block
// holds one row: each block takes in all noff rows of val for its lanes
// (16 times val's bytes into the SMs at m = 16) and does the whole sum of
// a lane with no reuse across rows.  The previous design (PERF.md;
// deleted since) read val from L2 in every block, copied x with
// per-thread cp.async fenced by two block barriers a tile, and took
// 0.3265 ms.
//
// What this design does about it (chosen on the H100 among variants that
// the comments below name):
//   * val by multicast.  The blocks that hold the row groups of one run of
//     tiles (a segment) form thread-block clusters of kClusterBlocks = 2.
//     val comes in chunks of at most 2,048 lanes (1,220 beside the ring at
//     T = 10,240) into two stages in every block: the cluster's rank 0
//     copies each chunk's noff rows once, with bulk copies multicast to
//     both blocks (cp.async.bulk ... multicast::cluster), so val leaves L2
//     once per cluster.  A stage is refilled once both blocks have read it:
//     each block arrives once on rank 0's "empty" barrier through the
//     cluster's shared memory (mapa) after its consumers pass a named
//     barrier, and each block arms its own "full" barrier with the bytes
//     it expects.  Clusters of 4, 8 and 16 blocks ran slower (16: the
//     multicast to 16 blocks could not keep up), and clusters of 1 (no
//     multicast) slower too.  The launch (cudaLaunchKernelEx) takes the
//     number of segments from cudaOccupancyMaxActiveClusters.
//   * x by TMA bulk copies under mbarriers.  Producer warp thread 1 copies
//     each whole tile of each row with one bulk copy into ring slot t % 4,
//     so lane L of a row sits at ring position L mod 4T; thread 0 issues
//     the val chunks, each in its own order.  A full/empty barrier pair per
//     slot replaces the block barriers: tile t + 2 is in flight while tile
//     t is computed, and a slot is refilled once the consumers have left
//     the last tile that reads it.
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
//     two agree bit for bit (the Pallas kernel sums aligned and unaligned
//     offsets apart and does not).
//   * The offsets travel as a kernel argument (constant memory), at most
//     kMaxOffsets of them.
//   * Every barrier wait traps after about 10 s instead of hanging the card.
// At T = 10,240 it takes 0.2211 ms there, 1.48 times faster than the
// previous design in turns, and 2.0 times K1's time (dia_spmm.cu): one row
// a block leaves the consumers' shared reads and sums, not device memory,
// as the bound.  At T = 12,288 and 14,336 no stage of 800 lanes fits
// beside the ring and val comes from device memory: 0.2952 ms against the
// previous design's 0.339.
//
// The kernels allocate nothing and do not synchronise the device.  Each
// entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "staged_window.cuh"

namespace {

constexpr int kRing = 4;
// barriers, by slot in the first kBarrierBytes of shared memory
constexpr int kXFull = 0;       // kRing barriers: a tile has landed
constexpr int kXEmpty = 4;      // kRing: a tile is read no more
constexpr int kVFull = 8;       // kStages: a val chunk has landed
constexpr int kVEmpty = kVFull + kStages;   // kStages (rank 0's): every
                                            // block has read it

// ---- the kernel: bulk copies, val multicast across a cluster -----------

// Block rank c of cluster q holds row group (q % cps) * size + c (rows may
// be 0 in the last cluster of a segment: it still reads every val chunk)
// and the tiles [ta, tb) of segment q / cps.  The producer warp loads tiles
// ta - 1 .. tb, load u = t - ta + 1 into slot t % 4 on its use u / 4 (tile
// t + 3 once tile t is done), and (kStage) the val chunks j = 0, 1, ... of
// the segment's tiles in order into stage j % kStages.
template <int kRows, bool kVec, bool kStage>
__global__ void __launch_bounds__(kThreads, 1)
tiles_kernel(const float* __restrict__ val, const float* __restrict__ x,
             float* __restrict__ y, Offsets offs, int noff, int64_t m,
             int64_t n, int tile, int chunk, int64_t tiles, int64_t per_seg,
             int cps) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t bar0 = smem_addr(smem);
    auto bar = [&](int slot) { return bar0 + 8 * slot; };
    float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
    const int ringL = kRing * tile;
    float* stage = ring + kRows * ringL;
    const uint32_t size = cluster_blocks();
    const uint32_t rank = cluster_rank();
    const int64_t q = blockIdx.x / size;
    const int64_t r0 = ((q % cps) * size + rank) * kRows;
    const int rows = r0 >= m ? 0 : (m - r0 < kRows ? static_cast<int>(m - r0)
                                                   : kRows);
    const int64_t ta = (q / cps) * per_seg;
    const int64_t tb = ta + per_seg < tiles ? ta + per_seg : tiles;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    auto slot_of = [](int64_t t) {
        return static_cast<int>(((t % kRing) + kRing) % kRing);
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < kRing; ++s) {
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
            auto load_x = [&](int64_t t) {
                const int64_t u = t - ta + 1;
                const int slot = slot_of(t);
                if (u >= kRing) {
                    barrier_wait<true>(bar(kXEmpty + slot),
                                       (u / kRing - 1) & 1);
                }
                const uint32_t full = bar(kXFull + slot);
                const int64_t g0 = t * tile;
                const int width = t < 0 || g0 >= n || rows == 0 ? 0
                    : (n - g0 < tile ? static_cast<int>(n - g0) : tile);
                float* dst = ring + slot * tile;
                if (kVec) {
                    if (width == 0) {
                        barrier_arrive(full);
                        return;
                    }
                    expect_bytes(full, rows * width * 4);
                    for (int r = 0; r < rows; ++r) {
                        bulk_load(smem_addr(dst + r * ringL),
                                  x + (r0 + r) * n + g0, width * 4, full);
                    }
                } else {
                    for (int r = 0; r < rows; ++r) {
                        for (int c = lane; c < width; c += 32) {
                            cp_async4(dst + r * ringL + c,
                                      x + (r0 + r) * n + g0 + c);
                        }
                    }
                    cp_async_arrive(full);
                }
            };
            // tiles ta - 1 .. tb; tile t + 2 once tile t - 1 is done
            for (int64_t t = ta - 1; t <= tb; ++t) load_x(t);
        } else if (kStage && lane == 0) {
            load_val_chunks(val, n, stage, noff, chunk, ta * tile,
                            tb * tile < n ? tb * tile : n, tile, rank, size,
                            bar(kVFull), bar(kVEmpty));
        }
    } else {
        auto wait_x = [&](int64_t t) {
            barrier_wait<true>(bar(kXFull + slot_of(t)),
                               ((t - ta + 1) / kRing) & 1);
        };
        int lo_off, hi_off;
        offset_extent(offs, noff, &lo_off, &hi_off);
        wait_x(ta - 1);
        wait_x(ta);
        int64_t j = 0;
        for (int64_t t = ta; t < tb; ++t) {
            wait_x(t + 1);
            const int64_t t0 = t * tile;
            const int width = n - t0 < tile ? static_cast<int>(n - t0) : tile;
            // once the tile is done, tile t - 1 is read by no later tile
            consume_tile<kRows, kVec, kStage>(
                val, y, offs, noff, n, ring, ringL, slot_of(t) * tile, stage,
                chunk, r0, rows, t0, width, lo_off, hi_off, bar(kVFull),
                bar(kVEmpty), bar(kXEmpty + slot_of(t - 1)), j);
        }
    }
    // no block leaves while another may still arrive on its barriers
    cluster_sync();
}

// The operands of one call.
struct Call {
    const float* val;
    const float* x;
    float* y;
    Offsets offs;
    int noff;
    int64_t m, n;
    int tile, chunk;
};

// Launches the kernel on `stream`, or with `query` fills it with the plan
// the launch would take and launches nothing.
template <int kRows, bool kVec, bool kStage>
cudaError_t launch(const Call& a, cudaStream_t stream, ClusterPlan* query) {
    auto kernel = tiles_kernel<kRows, kVec, kStage>;
    const size_t smem = kBarrierBytes
        + sizeof(float) * (static_cast<size_t>(kRows) * kRing * a.tile
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
                             a.m, a.n, a.tile, a.chunk, tiles, p.per,
                             static_cast<int>(p.cps));
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

// The checks both entry points make: offsets to `offs`, each at most
// `tile` in size.
cudaError_t read_offsets(const int* offsets, int64_t noff, int64_t tile,
                         Offsets* offs) {
    if (noff < 0 || noff > kMaxOffsets || tile < 1 || tile > 0x0fffffffLL) {
        return cudaErrorInvalidValue;
    }
    *offs = {};
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t off = offsets[k];
        if (off > tile || -off > tile) return cudaErrorInvalidValue;
        offs->v[k] = offsets[k];
    }
    return cudaSuccess;
}

}  // namespace

// offsets: noff ints on the HOST, each at most `tile` in size.  rows:
// operand rows per block, 1, 2, 4 or 8; chunk: lanes of val per stage, a
// multiple of 4, or 0 for no stage (val read from global memory).  On the
// bulk-copy branch 256 + rows * 4 * tile * 4 + 2 * noff * chunk * 4 bytes
// of shared memory must fit a block, on the others 256 + rows * 4 * tile *
// 4.
extern "C" int dia_spmm_rows_tiles_f32(const void* val, const void* x,
                                       void* y, const int* offsets,
                                       int64_t noff, int64_t m, int64_t n,
                                       int64_t tile, int64_t chunk, int rows,
                                       int device, void* stream) {
    if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
    Call a = {static_cast<const float*>(val), static_cast<const float*>(x),
              static_cast<float*>(y), {}, static_cast<int>(noff), m, n,
              static_cast<int>(tile), static_cast<int>(chunk)};
    cudaError_t err = read_offsets(offsets, noff, tile, &a.offs);
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

// The launch plan dia_spmm_rows_tiles_f32 takes for these shapes on the
// bulk-copy branch (bulk != 0) or the per-thread one, into kPlanSlots
// int64s on the HOST: cluster size, clusters that fit the card at once,
// clusters per segment, segments, blocks.  Launches nothing.
extern "C" int dia_spmm_rows_tiles_plan(const int* offsets, int64_t noff,
                                        int64_t m, int64_t n, int64_t tile,
                                        int64_t chunk, int rows, int bulk,
                                        int device, int64_t* plan) {
    if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Call a = {nullptr, nullptr, nullptr, {}, static_cast<int>(noff), m, n,
              static_cast<int>(tile), bulk ? static_cast<int>(chunk) : 0};
    cudaError_t err = read_offsets(offsets, noff, tile, &a.offs);
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
