// ELL SpMM, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm.py::_ell_matmat, the padded-row (ELLPACK)
// apply of scattered sparse patterns.  That is no Pallas kernel but one
// jitted lax.scan over the padded columns, which XLA fuses into a single
// program; eager PyTorch runs the same scan as a zeros, then one
// index_select and one addcmul_ a padded column (ops/spmm.py's plain
// version).  It computes
//
//     y[i, r] = sum_{k = 0}^{K-1} val[i, k] * x[idx[i, k], r]
//
// with idx (n, K) int32 and val (n, K) row-major as EllMatrix stores them
// (rows padded with column 0 and value 0, which add a zero as in the plain
// version: the padding is read and summed like any entry, so a non-finite
// x[0] propagates as it does there), x an (n_x, m) operand with row stride
// ldx, and y written through two strides, so the same launch writes the
// (n, m) column layout (ys_row = m, ys_col = 1) or the (m, n) row layout
// (ys_row = 1, ys_col = n).  The sums run over k in the plain version's
// order, one fused multiply-add a term, in the promoted type of the value
// and operand types; the result is rounded to the operand type once, on
// store.  So every instantiation equals the plain version bit for bit.
// Instantiations (value type, operand type, sum type): (f32, f32, f32),
// (f32, bf16, f32), (f32, f64, f64), (f64, f64, f64).  Every idx must lie in
// [0, n_x): the kernel does not check it (the matrices check their
// columns when they are built).
//
// What bounds it.  idx, val and x are each needed once and y written once:
// at the finite-element flagship (n = 139,179, K = 80, m = 16, f32) that is
// 89.1 MB of idx and val and 8.9 MB each of x and y, 107 MB, 0.032 ms at
// 3.35 TB/s; its 2 n K m flops (0.36 GFLOP) take 0.005 ms.  Bytes bound it.
// But x is gathered, n K rows of m values (712 MB at that shape), from the
// 50 MB L2 and the SMs' L1, where the 9 MB block lives.  Every lane also
// loads its row's idx and val (G lanes a row, below): at m = 16, 356 MB
// more through L1.  Both pass through the SMs' load path.
//
// What paced the previous design (PERF.md; deleted since; 0.0827 ms
// at that shape on an H100, 2.6 times the bound, and as long at m = 8 as
// at m = 16): a thread walked its row in steps of 8 entries, and a step's
// idx and val loads had to land before its 8 gathers could issue and the
// gathers before its multiply-adds, with nothing of the next step in
// flight, a device-memory wait then an L2 wait ten times a row; and 2,175
// blocks of 256 threads ran as about three waves, the last partial.
//
// What this design does about it:
//   * The next step's idx and val are loaded right after this step's 8
//     gathers are issued and before its multiply-adds, so the wait for
//     them overlaps the wait for the gathers.  That takes registers: 70 to
//     76 a thread against 40 to 44, three blocks of 256 threads an SM
//     against five or six (the launch bounds ask for three: unbounded, f32
//     values with an f64 operand took 84 registers and fit only two).
//   * A persistent grid, as many blocks as fit the SMs at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once per
//     kernel and device), each walking tiles of 256 / G rows with a stride
//     of the grid, so the SMs work on one band of rows at a time and no
//     partial last wave is left.
//   * x is read in its (n, m) layout: the m values of one gathered row are
//     one contiguous run, read by G neighbouring lanes as 16-byte vectors
//     (4 f32, 8 bf16 or 2 f64 values a lane; G the power of two that
//     covers m, at most 32; wider m in column chunks, each a tile's item).
//     Neighbouring rows often share columns (the dofs of one mesh node have
//     one pattern), so many gathers of one instruction fall on one row.
//   * idx and val are read as 16-byte vectors of 8 entries with
//     evict-first loads, so that they do not push x out of L2.  This needs
//     K % 8 == 0 (EllMatrix pads to 8) and 16-byte aligned bases; any other
//     K takes a scalar loop.  An operand whose rows are not whole 16-byte
//     vectors (m % V != 0, an unaligned base or row stride) takes one value
//     a lane (V = 1).
// Designs measured beside it and not kept (PERF.md): idx and val
// streamed by TMA bulk copies through a ring of shared-memory stages with
// a producer warp (slower at m <= 16, and by up to 2x where the stages
// take much of the SM's shared memory and L1, where the gathers hit), a
// contiguous run of tiles a block, the most L1 as the carveout, loads
// that ask L2 for 256 bytes, two vectors a lane (fewer lanes loading a
// row's idx and val, more registers), and six blocks an SM (spills).
// Index arithmetic is 64-bit.  The kernels allocate nothing and do not
// synchronise.  Each entry point returns cudaGetLastError() after its
// launch; ell_spmm_occupancy reports E1's registers and resident blocks an
// SM at a shape.
//
// The Chebyshev step (ell_step_kernel, entries ell_step_<value>_<operand>).
// Replaces no TPU kernel: one degree step of the recurrence of
// algebra/sparse.py::Chebyshev, which the JAX package leaves to XLA's
// fusion and eager PyTorch runs as an (n, m) copy, E1 and five passes over
// the block.  With the iterates d, r, y held in the (n, m) layout E1
// gathers from (row stride m), a launch computes for every row i and
// column c
//
//     t = sum_k val[i, k] * d[idx[i, k], c]     (E1's row sum, E1's order)
//     r' = r - t,  y' = d (first step) or y + d,  d' = c1 d + c2 r'
//
// each operation rounded once to the iterate's type and none contracted
// into an FMA (__fsub_rn, __fadd_rn, __fmul_rn and their f64 twins), so
// that it equals the eager step bit for bit: t is E1's result, and c1, c2
// arrive as doubles and are rounded to the iterate's type as PyTorch
// rounds a Python float against a tensor of that type.  r and y are
// updated in place (only a row's own lanes touch them); d' goes to a
// second buffer, since other blocks gather d during the launch.  The last
// step writes y' alone and gathers nothing (r' and d' would be dropped).
// Pairs: (f32, f32), (f32, f64), (f64, f64); no bf16 operand (bf16
// iterates stream through E1's eager step).
//
// What bounds it: idx, val and the row pointer of A's nonzeros (63.1 MB at
// the finite-element flagship's 7,819,533), d read once, r and y read, r',
// y' and d' written: at n = 139,179 and an 8.9 MB block ((16, n) f32 or
// (8, n) f64) that is 116.5 MB a step, 0.0348 ms at 3.35 TB/s, against
// 133.6 MB of eager passes besides E1's own launch.  What the design does
// about it: E1's walk, lane groups and persistent grid; the row's own d is
// loaded as a 16-byte vector before its gathers are issued, and r and y
// after its row sum, each with normal loads (not evict-first, so that the
// four 8.9 MB iterates stay in L2 while idx and val stream through).  r and
// y loaded before the gathers as well held 8 more registers across the
// row sum (80 a thread, and a 16-byte spill for f64 lanes) and took 1.7% to
// 3% longer on the H100 (PERF.md).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kStep = 8;        // entries of a row a step of the vector loop
constexpr int kMinBlocks = 3;   // resident blocks an SM the kernel asks for

__device__ __forceinline__ float fmadd(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
    return __fma_rn(a, b, c);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

// V consecutive operand values as loaded: one 16-byte vector (V * the
// operand size is 16 bytes, p 16-byte aligned), or one value (V = 1; a
// bf16 value as its bits).  They stay in this form until their
// multiply-adds, so 8 gathers in flight take 32 registers a lane.
template <typename TX, int V>
struct Raw { using type = uint4; };
template <typename TX>
struct Raw<TX, 1> { using type = TX; };
template <>
struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };

template <typename TX, int V>
__device__ __forceinline__ typename Raw<TX, V>::type load_x(const TX* p) {
    using R = typename Raw<TX, V>::type;
    return __ldg(reinterpret_cast<const R*>(p));
}

// the loaded values widened to the sum type TA (exactly)
template <typename TX, typename TA, int V>
__device__ __forceinline__ void widen(typename Raw<TX, V>::type r,
                                      TA (&out)[V]) {
    if constexpr (V == 1) {
        if constexpr (sizeof(TX) == 2) {
            out[0] = bf16_lo(static_cast<uint32_t>(r));
        } else {
            out[0] = static_cast<TA>(r);
        }
    } else if constexpr (sizeof(TX) == 4) {
        out[0] = __uint_as_float(r.x);
        out[1] = __uint_as_float(r.y);
        out[2] = __uint_as_float(r.z);
        out[3] = __uint_as_float(r.w);
    } else if constexpr (sizeof(TX) == 8) {
        out[0] = __hiloint2double(static_cast<int>(r.y),
                                  static_cast<int>(r.x));
        out[1] = __hiloint2double(static_cast<int>(r.w),
                                  static_cast<int>(r.z));
    } else {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            out[2 * q] = bf16_lo(w[q]);
            out[2 * q + 1] = bf16_hi(w[q]);
        }
    }
}

// 8 consecutive entries of a row: idx, and val widened to TA
__device__ __forceinline__ void load_idx8(const int32_t* p, int32_t (&j)[8]) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(p) + 1);
    j[0] = a.x; j[1] = a.y; j[2] = a.z; j[3] = a.w;
    j[4] = b.x; j[5] = b.y; j[6] = b.z; j[7] = b.w;
}

template <typename TA>
__device__ __forceinline__ void load_val8(const float* p, TA (&v)[8]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename TA>
__device__ __forceinline__ void load_val8(const double* p, TA (&v)[8]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const double2 a = __ldcs(reinterpret_cast<const double2*>(p) + q);
        v[2 * q] = a.x;
        v[2 * q + 1] = a.y;
    }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// acc += the k terms of one row (k a positive multiple of 8, ip and vp
// 16-byte aligned), in k order, one FMA a term.  The entries of step
// kk + 8 are loaded after the gathers of step kk are issued and before
// its multiply-adds.
template <typename TV, typename TX, typename TA, int V>
__device__ __forceinline__ void row_sum(const int32_t* ip, const TV* vp,
                                        const TX* xc, int64_t k,
                                        int64_t ldx, TA (&acc)[V]) {
    int32_t j[kStep];
    TA v[kStep];
    load_idx8(ip, j);
    load_val8(vp, v);
    for (int64_t kk = 0; kk < k; kk += kStep) {
        typename Raw<TX, V>::type raw[kStep];
#pragma unroll
        for (int e = 0; e < kStep; ++e) {
            raw[e] = load_x<TX, V>(xc + static_cast<int64_t>(j[e]) * ldx);
        }
        TA w[kStep];
#pragma unroll
        for (int e = 0; e < kStep; ++e) w[e] = v[e];
        if (kk + kStep < k) {
            load_idx8(ip + kk + kStep, j);
            load_val8(vp + kk + kStep, v);
        }
#pragma unroll
        for (int e = 0; e < kStep; ++e) {
            TA xv[V];
            widen<TX, TA, V>(raw[e], xv);
#pragma unroll
            for (int c = 0; c < V; ++c) acc[c] = fmadd(w[e], xv[c], acc[c]);
        }
    }
}

// acc += the k terms of one row, one entry at a time (any k, any base)
template <typename TV, typename TX, typename TA, int V>
__device__ __forceinline__ void row_sum_scalar(const int32_t* ip,
                                               const TV* vp, const TX* xc,
                                               int64_t k, int64_t ldx,
                                               TA (&acc)[V]) {
    for (int64_t kk = 0; kk < k; ++kk) {
        const int64_t j = __ldcs(ip + kk);
        const TA v = static_cast<TA>(__ldcs(vp + kk));
        TA xv[V];
        widen<TX, TA, V>(load_x<TX, V>(xc + j * ldx), xv);
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = fmadd(v, xv[c], acc[c]);
    }
}

template <typename TX, typename TA, int V>
__device__ __forceinline__ void store_row(TX* y, int64_t row, int64_t col,
                                          int64_t ys_row, int64_t ys_col,
                                          const TA (&acc)[V]) {
    TX* yp = y + row * ys_row + col * ys_col;
#pragma unroll
    for (int c = 0; c < V; ++c) store(yp + c * ys_col, acc[c]);
}

// What a launch walks: tiles of `rows` = kThreads >> g_log2 rows, each in
// `chunks` column chunks of G = 1 << g_log2 lanes; item = tile * chunks +
// chunk.
struct Walk {
    int64_t n, k, m, ldx, ys_row, ys_col, chunks;
    int g_log2, rows;
    bool vec_entries;   // idx and val as 16-byte vectors of 8 entries
};

// One lane group of G lanes a row, kThreads >> g_log2 rows a tile, the
// tiles strided over a persistent grid; registers for kMinBlocks blocks an
// SM.
template <typename TV, typename TX, typename TA, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_rows_kernel(const int32_t* __restrict__ idx, const TV* __restrict__ val,
                const TX* __restrict__ x, TX* __restrict__ y, Walk w) {
    const int lane_row = threadIdx.x >> w.g_log2;
    const int64_t lane_col =
        static_cast<int64_t>(threadIdx.x & ((1 << w.g_log2) - 1)) * V;
    const int64_t items = (w.n + w.rows - 1) / w.rows * w.chunks;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t tile = item / w.chunks;
        const int64_t chunk = item - tile * w.chunks;
        const int64_t row = tile * w.rows + lane_row;
        const int64_t col = ((chunk << w.g_log2) * V) + lane_col;
        if (row >= w.n || col >= w.m) continue;
        TA acc[V];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = TA(0);
        if (w.vec_entries) {
            if (w.k > 0) {
                row_sum<TV, TX, TA, V>(idx + row * w.k, val + row * w.k,
                                       x + col, w.k, w.ldx, acc);
            }
        } else {
            row_sum_scalar<TV, TX, TA, V>(idx + row * w.k, val + row * w.k,
                                          x + col, w.k, w.ldx, acc);
        }
        store_row<TX, TA, V>(y, row, col, w.ys_row, w.ys_col, acc);
    }
}

// One rounding an operation, never contracted into an FMA.
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}

// V values of a row's own lanes (p 16-byte aligned for V > 1): a normal
// load, since the launch writes the same lanes afterwards
template <typename TX, int V>
__device__ __forceinline__ typename Raw<TX, V>::type load_own(const TX* p) {
    using R = typename Raw<TX, V>::type;
    return *reinterpret_cast<const R*>(p);
}

template <typename TX, int V>
__device__ __forceinline__ void store_own(TX* p, const TX (&v)[V]) {
    if constexpr (V == 1) {
        *p = v[0];
    } else if constexpr (sizeof(TX) == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(
            __float_as_uint(v[0]), __float_as_uint(v[1]),
            __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(
            static_cast<unsigned int>(__double2loint(v[0])),
            static_cast<unsigned int>(__double2hiint(v[0])),
            static_cast<unsigned int>(__double2loint(v[1])),
            static_cast<unsigned int>(__double2hiint(v[1])));
    }
}

// One Chebyshev degree step (the source note): E1's walk and row sums over
// the gathered d, the step's update as their epilogue.  d, d_next, r, y are
// (n, m) with row stride w.ldx = m; r and y are updated in place.
template <typename TV, typename TX, typename TA, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_step_kernel(const int32_t* __restrict__ idx, const TV* __restrict__ val,
                const TX* __restrict__ d, TX* __restrict__ d_next,
                TX* __restrict__ r, TX* __restrict__ y, TX c1, TX c2,
                Walk w, bool first, bool last) {
    using R = typename Raw<TX, V>::type;
    const int lane_row = threadIdx.x >> w.g_log2;
    const int64_t lane_col =
        static_cast<int64_t>(threadIdx.x & ((1 << w.g_log2) - 1)) * V;
    const int64_t items = (w.n + w.rows - 1) / w.rows * w.chunks;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t tile = item / w.chunks;
        const int64_t chunk = item - tile * w.chunks;
        const int64_t row = tile * w.rows + lane_row;
        const int64_t col = ((chunk << w.g_log2) * V) + lane_col;
        if (row >= w.n || col >= w.m) continue;
        const int64_t at = row * w.ldx + col;
        // the row's own d, in flight while the gathers are issued
        const R d_raw = load_x<TX, V>(d + at);
        TA acc[V];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = TA(0);
        if (!last) {
            if (w.vec_entries) {
                if (w.k > 0) {
                    row_sum<TV, TX, TA, V>(idx + row * w.k, val + row * w.k,
                                           d + col, w.k, w.ldx, acc);
                }
            } else {
                row_sum_scalar<TV, TX, TA, V>(idx + row * w.k,
                                              val + row * w.k, d + col, w.k,
                                              w.ldx, acc);
            }
        }
        R y_raw{}, r_raw{};
        if (!first) y_raw = load_own<TX, V>(y + at);
        if (!last) r_raw = load_own<TX, V>(r + at);
        TX dv[V];
        widen<TX, TX, V>(d_raw, dv);
        if (first) {
            store_own<TX, V>(y + at, dv);
        } else {
            TX yv[V];
            widen<TX, TX, V>(y_raw, yv);
#pragma unroll
            for (int c = 0; c < V; ++c) yv[c] = add_rn(yv[c], dv[c]);
            store_own<TX, V>(y + at, yv);
        }
        if (last) continue;
        TX rv[V];
        widen<TX, TX, V>(r_raw, rv);
#pragma unroll
        for (int c = 0; c < V; ++c) {
            rv[c] = sub_rn(rv[c], static_cast<TX>(acc[c]));
            dv[c] = add_rn(mul_rn(c1, dv[c]), mul_rn(c2, rv[c]));
        }
        store_own<TX, V>(r + at, rv);
        store_own<TX, V>(d_next + at, dv);
    }
}

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return err;
    return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Resident blocks an SM of `fn` at kThreads threads on `device`, and the
// device's SMs; cached, so that a launch asks the runtime once per kernel
// and device.
struct Fit {
    const void* fn;
    int device, per_sm;
};
constexpr int kMaxFits = 64;
Fit g_fits[kMaxFits];
int g_nfits = 0;
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

cudaError_t fit(const void* fn, int device, int* per_sm, int* sms) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    cudaError_t err;
    if (g_sms[device] == 0) {
        err = cudaDeviceGetAttribute(&g_sms[device],
                                     cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
    }
    *sms = g_sms[device];
    for (int i = 0; i < g_nfits; ++i) {
        if (g_fits[i].fn == fn && g_fits[i].device == device) {
            *per_sm = g_fits[i].per_sm;
            return cudaSuccess;
        }
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if (*per_sm < 1) return cudaErrorInvalidConfiguration;
    if (g_nfits < kMaxFits) g_fits[g_nfits++] = Fit{fn, device, *per_sm};
    return cudaSuccess;
}

// The shape of a launch: lane groups, rows a tile and column chunks from m
// and V, and whether idx and val take the vector loads.
Walk walk(const void* idx, const void* val, int64_t n, int64_t k, int64_t m,
          int64_t ldx, int64_t ys_row, int64_t ys_col, int vec) {
    const int64_t vectors = (m + vec - 1) / vec;
    int g_log2 = 0;
    while (g_log2 < 5 && (int64_t{1} << g_log2) < vectors) ++g_log2;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(idx)
        | reinterpret_cast<uintptr_t>(val);
    Walk w{};
    w.n = n;
    w.k = k;
    w.m = m;
    w.ldx = ldx;
    w.ys_row = ys_row;
    w.ys_col = ys_col;
    w.g_log2 = g_log2;
    w.chunks = (vectors + (int64_t{1} << g_log2) - 1) >> g_log2;
    w.rows = kThreads >> g_log2;
    w.vec_entries = k % kStep == 0 && bases % 16 == 0;
    return w;
}

template <typename TV, typename TX, typename TA, int V>
int launch_v(const void* idx, const void* val, const void* x, void* y,
             int64_t n, int64_t k, int64_t m, int64_t ldx, int64_t ys_row,
             int64_t ys_col, int device, void* stream) {
    const Walk w = walk(idx, val, n, k, m, ldx, ys_row, ys_col, V);
    auto kernel = ell_rows_kernel<TV, TX, TA, V>;
    int per_sm = 0, sms = 0;
    const cudaError_t err =
        fit(reinterpret_cast<const void*>(kernel), device, &per_sm, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t items = (n + w.rows - 1) / w.rows * w.chunks;
    const int64_t most = static_cast<int64_t>(per_sm) * sms;
    const int64_t blocks = items < most ? items : most;
    kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const TV*>(val),
        static_cast<const TX*>(x), static_cast<TX*>(y), w);
    return static_cast<int>(cudaGetLastError());
}

template <typename TX>
bool wide_operand(const void* x, int64_t m, int64_t ldx) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
    return m % kVec == 0
        && (ldx * static_cast<int64_t>(sizeof(TX))) % 16 == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// At V values a lane: 16 bytes where the operand's rows allow, else one.
template <typename TV, typename TX, typename TA>
int launch(const void* idx, const void* val, const void* x, void* y,
           int64_t n, int64_t k, int64_t m, int64_t ldx, int64_t ys_row,
           int64_t ys_col, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
    constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
    if (wide_operand<TX>(x, m, ldx)) {
        return launch_v<TV, TX, TA, kVec>(idx, val, x, y, n, k, m, ldx,
                                          ys_row, ys_col, device, stream);
    }
    return launch_v<TV, TX, TA, 1>(idx, val, x, y, n, k, m, ldx, ys_row,
                                   ys_col, device, stream);
}

template <typename TV, typename TX, typename TA, int V>
int launch_step_v(const void* idx, const void* val, const void* d,
                  void* d_next, void* r, void* y, double c1, double c2,
                  int64_t n, int64_t k, int64_t m, bool first, bool last,
                  int device, void* stream) {
    const Walk w = walk(idx, val, n, k, m, m, m, 1, V);
    auto kernel = ell_step_kernel<TV, TX, TA, V>;
    int per_sm = 0, sms = 0;
    const cudaError_t err =
        fit(reinterpret_cast<const void*>(kernel), device, &per_sm, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t items = (n + w.rows - 1) / w.rows * w.chunks;
    const int64_t most = static_cast<int64_t>(per_sm) * sms;
    const int64_t blocks = items < most ? items : most;
    // c1 and c2 rounded to the iterate's type as PyTorch rounds a Python
    // float against a tensor of that type (a cast, to nearest)
    kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const TV*>(val),
        static_cast<const TX*>(d), static_cast<TX*>(d_next),
        static_cast<TX*>(r), static_cast<TX*>(y), static_cast<TX>(c1),
        static_cast<TX>(c2), w, first, last);
    return static_cast<int>(cudaGetLastError());
}

// At 16 bytes a lane where m and all four iterates' bases allow, else one
// value a lane.
template <typename TV, typename TX, typename TA>
int launch_step(const void* idx, const void* val, const void* d,
                void* d_next, void* r, void* y, double c1, double c2,
                int64_t n, int64_t k, int64_t m, int first, int last,
                int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
    constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
    const uintptr_t bases = reinterpret_cast<uintptr_t>(d_next)
        | reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(y);
    if (wide_operand<TX>(d, m, m) && bases % 16 == 0) {
        return launch_step_v<TV, TX, TA, kVec>(
            idx, val, d, d_next, r, y, c1, c2, n, k, m, first != 0,
            last != 0, device, stream);
    }
    return launch_step_v<TV, TX, TA, 1>(idx, val, d, d_next, r, y, c1, c2,
                                        n, k, m, first != 0, last != 0,
                                        device, stream);
}

// out: registers a thread, resident blocks an SM, threads a block, local
// (spill) bytes a thread, for an operand of m columns that are whole
// 16-byte vectors when m allows.
template <typename TV, typename TX, typename TA>
cudaError_t occupancy(int64_t m, int device, int64_t* out) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
    const void* fn = m % kVec == 0
        ? reinterpret_cast<const void*>(ell_rows_kernel<TV, TX, TA, kVec>)
        : reinterpret_cast<const void*>(ell_rows_kernel<TV, TX, TA, 1>);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = fit(fn, device, &per_sm, &sms);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = per_sm;
    out[2] = kThreads;
    out[3] = static_cast<int64_t>(attr.localSizeBytes);
    return cudaSuccess;
}

}  // namespace

// entry points: ell_spmm_<value type>_<operand type>
extern "C" int ell_spmm_f32_f32(const void* idx, const void* val,
                                const void* x, void* y, int64_t n,
                                int64_t k, int64_t m, int64_t ldx,
                                int64_t ys_row, int64_t ys_col, int device,
                                void* stream) {
    return launch<float, float, float>(
        idx, val, x, y, n, k, m, ldx, ys_row, ys_col, device, stream);
}

extern "C" int ell_spmm_f32_bf16(const void* idx, const void* val,
                                 const void* x, void* y, int64_t n,
                                 int64_t k, int64_t m, int64_t ldx,
                                 int64_t ys_row, int64_t ys_col, int device,
                                 void* stream) {
    return launch<float, __nv_bfloat16, float>(
        idx, val, x, y, n, k, m, ldx, ys_row, ys_col, device, stream);
}

extern "C" int ell_spmm_f32_f64(const void* idx, const void* val,
                                const void* x, void* y, int64_t n,
                                int64_t k, int64_t m, int64_t ldx,
                                int64_t ys_row, int64_t ys_col, int device,
                                void* stream) {
    return launch<float, double, double>(
        idx, val, x, y, n, k, m, ldx, ys_row, ys_col, device, stream);
}

extern "C" int ell_spmm_f64_f64(const void* idx, const void* val,
                                const void* x, void* y, int64_t n,
                                int64_t k, int64_t m, int64_t ldx,
                                int64_t ys_row, int64_t ys_col, int device,
                                void* stream) {
    return launch<double, double, double>(
        idx, val, x, y, n, k, m, ldx, ys_row, ys_col, device, stream);
}

// entry points: ell_step_<value type>_<operand type>, one Chebyshev degree
// step on (n, m) iterates d (read), d_next (written), r and y (updated);
// first and last as 0 or 1
extern "C" int ell_step_f32_f32(const void* idx, const void* val,
                                const void* d, void* d_next, void* r,
                                void* y, double c1, double c2, int64_t n,
                                int64_t k, int64_t m, int first, int last,
                                int device, void* stream) {
    return launch_step<float, float, float>(
        idx, val, d, d_next, r, y, c1, c2, n, k, m, first, last, device,
        stream);
}

extern "C" int ell_step_f32_f64(const void* idx, const void* val,
                                const void* d, void* d_next, void* r,
                                void* y, double c1, double c2, int64_t n,
                                int64_t k, int64_t m, int first, int last,
                                int device, void* stream) {
    return launch_step<float, double, double>(
        idx, val, d, d_next, r, y, c1, c2, n, k, m, first, last, device,
        stream);
}

extern "C" int ell_step_f64_f64(const void* idx, const void* val,
                                const void* d, void* d_next, void* r,
                                void* y, double c1, double c2, int64_t n,
                                int64_t k, int64_t m, int first, int last,
                                int device, void* stream) {
    return launch_step<double, double, double>(
        idx, val, d, d_next, r, y, c1, c2, n, k, m, first, last, device,
        stream);
}

// pair: 0 f32_f32, 1 f32_bf16, 2 f32_f64, 3 f64_f64.  Fills out[4] as
// ``occupancy`` says; nothing is launched.
extern "C" int ell_spmm_occupancy(int pair, int64_t m, int device,
                                  int64_t* out) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (pair) {
        case 0: err = occupancy<float, float, float>(m, device, out); break;
        case 1:
            err = occupancy<float, __nv_bfloat16, float>(m, device, out);
            break;
        case 2: err = occupancy<float, double, double>(m, device, out); break;
        case 3: err = occupancy<double, double, double>(m, device, out); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
