// What the two staged-window DIA SpMM kernels share (dia_spmm_slide.cu,
// dia_spmm_tiles.cu): the cluster and copy helpers, the val chunks
// multicast to a cluster, the consumers' sums over one tile and the
// cluster launch.  Only the kernels' x-copy schedules and windows differ.
//
// A block has kConsumers threads that compute and one producer warp.  Its
// dynamic shared memory holds kBarrierBytes of barriers, then the x windows
// of its rows, then (kStage) kStages stages of noff * chunk val lanes.
// Three per-shape branches of each kernel (template parameters):
//   kVec && kStage   x by bulk copies, val multicast into the stages,
//                    four lanes a thread;
//   kVec && !kStage  x by bulk copies, val read from global memory four
//                    lanes a thread (the stages do not fit beside the
//                    windows, or a chunk that fits is too narrow to pay);
//   !kVec            x by 4-byte cp.async (n or T not a multiple of 4, an
//                    operand not 16-byte aligned), val from global memory,
//                    one lane a thread.
// Without a stage a cluster is one block.  sm_90a.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "mbarrier.cuh"

namespace {

constexpr int kMaxOffsets = 128;

struct Offsets {
    int v[kMaxOffsets];
};

constexpr int kConsumers = 512;               // threads that compute
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and one producer warp
// blocks a cluster, the fastest size on an H100 (the kernels' notes)
constexpr int kClusterBlocks = 2;
// bytes of barriers before the windows (ops/spmm_window.py counts the same
// bytes), and val stages
constexpr int kBarrierBytes = 256;
constexpr int kStages = 2;

// Arrives on the barrier at the same offset as `bar` in block `rank` of
// the cluster, releasing this thread's reads of shared memory.
__device__ __forceinline__ void barrier_arrive_at(uint32_t bar,
                                                  uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(bar), "r"(rank));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
                 "[%0];\n" :: "r"(remote) : "memory");
}

// Bulk copy of `bytes` from global `src` into `dst` of every block in
// `mask`, each counted on its own barrier at `bar`'s offset.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const float* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes.multicast::cluster [%0], [%1], %2, "
                 "[%3], %4;\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(smem_dst)), "l"(src) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n"
                 "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return r;
}

// p in (-L, 2L) to [0, L)
__device__ __forceinline__ int wrap(int p, int L) {
    return p < 0 ? p + L : (p >= L ? p - L : p);
}

// The consumer warps' own barrier (named barrier 1; the producer warp is
// not in it).
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Thread 0 of the producer warp: the val chunks of lanes [a, b), cut at
// multiples of `tile` into chunks of at most `chunk` lanes, chunk j into
// stage j % kStages behind barriers full0 + 8 s (this block's) and
// empty0 + 8 s (rank 0's).  Every block arms its own barrier for the
// bytes of chunk j once chunk j - kStages has landed there; rank 0 copies
// the chunk's noff rows of val once, multicast to every block of the
// cluster, once every block has read chunk j - kStages.
__device__ __forceinline__ void load_val_chunks(
        const float* val, int64_t n, float* stage, int noff, int chunk,
        int64_t a, int64_t b, int tile, uint32_t rank, uint32_t size,
        uint32_t full0, uint32_t empty0) {
    const uint16_t mask = static_cast<uint16_t>((1u << size) - 1);
    const uint32_t stage0 = smem_addr(stage);
    const int stage_lanes = noff * chunk;
    int64_t j = 0;
    for (int64_t t0 = a; t0 < b; t0 += tile) {
        const int64_t t1 = t0 + tile < b ? t0 + tile : b;
        for (int64_t c0 = t0; c0 < t1; c0 += chunk, ++j) {
            const int w = t1 - c0 < chunk ? static_cast<int>(t1 - c0)
                                          : chunk;
            const int s = static_cast<int>(j % kStages);
            const uint32_t full = full0 + 8 * s;
            const uint32_t use = static_cast<uint32_t>(j / kStages);
            // the stage's previous chunk has landed here, so its phase is
            // over
            if (use > 0) barrier_wait<true>(full, (use - 1) & 1);
            expect_bytes(full, noff * w * 4);
            if (rank != 0) continue;
            if (use > 0) barrier_wait<true>(empty0 + 8 * s, (use - 1) & 1);
            for (int k = 0; k < noff; ++k) {
                bulk_multicast(stage0 + 4 * (s * stage_lanes + k * chunk),
                               val + k * n + c0, w * 4, full, mask);
            }
        }
    }
}

// One diagonal's terms for the four lanes of a quad: acc[e] += v[e] *
// f[S + e], f the quads lo and hi side by side.
template <int S>
__device__ __forceinline__ void add_shifted(float (&acc)[4], const float4& v,
                                            const float4& lo,
                                            const float4& hi) {
    const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        acc[e] = __fadd_rn(acc[e], __fmul_rn(w[e], f[S + e]));
    }
}

// The consumers' work on lanes [t0 + c0, t0 + c0 + w) of `rows` rows: the
// window holds lane L of row r at win[r * winL + wrap(p0 + L - t0)].
// kVec: four lanes a thread, val's chunk from the stage,
// vs[k * chunk + (L - t0 - c0)] (kStage), or from global memory, x as one
// aligned quad where the offset is a multiple of 4 and as two with a
// register shift otherwise; a quad with a term outside [0, n) goes lane by
// lane (interior: the chunk has none).  Else one lane a thread and val
// from global memory.
template <int kRows, bool kVec, bool kStage>
__device__ __forceinline__ void compute_chunk(
        const float* __restrict__ val, float* __restrict__ y,
        const Offsets& offs, int noff, int64_t n, const float* win,
        int winL, int p0, const float* vs, int chunk, int64_t r0, int rows,
        int64_t t0, int c0, int w, bool interior) {
    if (!kVec) {
        for (int q = threadIdx.x; q < w; q += kConsumers) {
            const int jj = c0 + q;
            const int64_t i = t0 + jj;
            float acc[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
            for (int k = 0; k < noff; ++k) {
                const int off = offs.v[k];
                if (i + off < 0 || i + off >= n) continue;
                const float v = __ldg(val + k * n + i);
                const int p = wrap(p0 + jj + off, winL);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    if (r < rows) {
                        acc[r] = __fadd_rn(
                            acc[r], __fmul_rn(v, win[r * winL + p]));
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r < rows) y[(r0 + r) * n + i] = acc[r];
            }
        }
        return;
    }
    for (int q = 4 * static_cast<int>(threadIdx.x); q < w;
         q += 4 * kConsumers) {
        const int jj = c0 + q;
        const int64_t i = t0 + jj;
        const int pq = p0 + jj;
        float acc[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
        }
        for (int k = 0; k < noff; ++k) {
            const int off = offs.v[k];
            const int s = off & 3;   // the same for every thread
            const float4 v = kStage
                ? *reinterpret_cast<const float4*>(vs + k * chunk + q)
                : __ldg(reinterpret_cast<const float4*>(val + k * n + i));
            if (interior || (i + off >= 0 && i + off + 3 < n)) {
                const int p = wrap(pq + off - s, winL);
                const int p2 = p + 4 >= winL ? p + 4 - winL : p + 4;
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    if (r < rows) {
                        const float* xr = win + r * winL;
                        const float4 lo =
                            *reinterpret_cast<const float4*>(xr + p);
                        if (s == 0) {
                            add_shifted<0>(acc[r], v, lo, lo);
                            continue;
                        }
                        const float4 hi =
                            *reinterpret_cast<const float4*>(xr + p2);
                        switch (s) {
                            case 1: add_shifted<1>(acc[r], v, lo, hi); break;
                            case 2: add_shifted<2>(acc[r], v, lo, hi); break;
                            default: add_shifted<3>(acc[r], v, lo, hi);
                                     break;
                        }
                    }
                }
                continue;
            }
            // a quad at an edge of [0, n): lane by lane, a term outside
            // skipped
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int64_t g = i + e + off;
                const int p = wrap(pq + e + off, winL);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    if (r < rows && g >= 0 && g < n) {
                        acc[r][e] = __fadd_rn(
                            acc[r][e], __fmul_rn(vv[e], win[r * winL + p]));
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
                *reinterpret_cast<float4*>(y + (r0 + r) * n + i) =
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            }
        }
    }
}

// The consumers' work on the `width` lanes of the tile at lane t0, whose
// window is in place: chunk by chunk (kStage: the val chunks j, j + 1, ...
// of stage j % kStages, behind barriers vfull0 + 8 s and rank 0's
// vempty0 + 8 s; else the whole tile at once), each followed by the
// consumers' barrier; then thread 0 arrives on `x_empty`.  [lo_off,
// hi_off]: the offsets' extent.
template <int kRows, bool kVec, bool kStage>
__device__ __forceinline__ void consume_tile(
        const float* __restrict__ val, float* __restrict__ y,
        const Offsets& offs, int noff, int64_t n, const float* win,
        int winL, int p0, const float* stage, int chunk, int64_t r0,
        int rows, int64_t t0, int width, int lo_off, int hi_off,
        uint32_t vfull0, uint32_t vempty0, uint32_t x_empty, int64_t& j) {
    const int step = kStage ? chunk : width;
    for (int c0 = 0; c0 < width; c0 += step) {
        const int w = width - c0 < step ? width - c0 : step;
        const int s = static_cast<int>(j % kStages);
        if (kStage) barrier_wait<true>(vfull0 + 8 * s, (j / kStages) & 1);
        if (rows > 0) {
            const int64_t i0 = t0 + c0;
            compute_chunk<kRows, kVec, kStage>(
                val, y, offs, noff, n, win, winL, p0,
                stage + s * noff * chunk, chunk, r0, rows, t0, c0, w,
                i0 + lo_off >= 0 && i0 + w - 1 + hi_off < n);
        }
        // every consumer is done with the chunk (and the tile)
        consumers_sync();
        if (threadIdx.x == 0) {
            if (c0 + step >= width) barrier_arrive(x_empty);
            if (kStage) barrier_arrive_at(vempty0 + 8 * s, 0);
        }
        if (kStage) ++j;
    }
}

// The offsets' extent [lo, hi], lo <= 0 <= hi.
__device__ __forceinline__ void offset_extent(const Offsets& offs, int noff,
                                              int* lo, int* hi) {
    *lo = 0;
    *hi = 0;
    for (int k = 0; k < noff; ++k) {
        *lo = offs.v[k] < *lo ? offs.v[k] : *lo;
        *hi = offs.v[k] > *hi ? offs.v[k] : *hi;
    }
}

// What a launch chooses: blocks a cluster, clusters that fit the card at
// once, clusters a segment (a run of whole tiles), segments, tiles a
// segment, blocks.
struct ClusterPlan {
    int64_t cluster, active, cps, segs, per, blocks;
};

// The clusters of one kernel that fit the card at once, asked once per
// device, cluster size and shared-memory size.
struct ActiveClusters {
    int device = -1, cluster = 0, active = 0;
    size_t smem = 0;
};

// Sets the kernel's dynamic shared memory to `smem`; fills `cfg` (which
// points to `attr`) for a launch on `stream` of clusters of `cluster`
// blocks of kThreads, and `plan` for `groups` row groups over `tiles`
// tiles: a segment takes ceil(groups / cluster) clusters, and there are as
// many segments as keep every cluster that fits busy.
template <typename Kernel>
cudaError_t plan_clusters(Kernel kernel, size_t smem, int cluster,
                          int64_t groups, int64_t tiles, cudaStream_t stream,
                          ActiveClusters* cache, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr, ClusterPlan* plan) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = {};
    cfg->gridDim = dim3(cluster);
    cfg->blockDim = dim3(kThreads);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    int device = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device != cache->device || cluster != cache->cluster
            || smem != cache->smem) {
        err = cudaOccupancyMaxActiveClusters(&cache->active, kernel, cfg);
        if (err != cudaSuccess) return err;
        cache->device = device;
        cache->cluster = cluster;
        cache->smem = smem;
    }
    const int64_t active = cache->active;
    if (active < 1) return cudaErrorInvalidConfiguration;
    const int64_t cps = (groups + cluster - 1) / cluster;
    int64_t segs = active / cps < 1 ? 1 : active / cps;
    const int64_t per = (tiles + segs - 1) / segs;
    segs = (tiles + per - 1) / per;
    const int64_t blocks = segs * cps * cluster;
    if (blocks > 0x7fffffffLL || cps > 0x7fffffff) {
        return cudaErrorInvalidConfiguration;
    }
    *plan = {cluster, active, cps, segs, per, blocks};
    cfg->gridDim = dim3(static_cast<unsigned int>(blocks));
    return cudaSuccess;
}

// The launch plan the query entry points report, in this order.
constexpr int kPlanSlots = 5;

__host__ inline void report_plan(const ClusterPlan& p, int64_t* out) {
    const int64_t slots[kPlanSlots] = {p.cluster, p.active, p.cps, p.segs,
                                       p.blocks};
    for (int i = 0; i < kPlanSlots; ++i) out[i] = slots[i];
}

// Whether a launch takes the bulk-copy branch: n and tile multiples of 4,
// every operand on 16 bytes (ops/spmm_window.py decides the same).
__host__ inline bool bulk_shape(int64_t n, int64_t tile, uintptr_t bases) {
    return n % 4 == 0 && tile % 4 == 0 && bases % 16 == 0;
}

// chunk: 0 (val from global memory) or a multiple of 4 lanes.
__host__ inline bool chunk_ok(int64_t chunk) {
    return chunk == 0 || (chunk >= 4 && chunk % 4 == 0
                          && chunk <= 0x00ffffffLL);
}

}  // namespace
