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
// version), x an (n_x, m) operand with row stride ldx, and y written
// through two strides, so the same launch writes the (n, m) column layout
// (ys_row = m, ys_col = 1) or the (m, n) row layout (ys_row = 1,
// ys_col = n).  The sums run over k in the plain version's order, one
// fused multiply-add a term, in the promoted type of the value and operand
// types; the result is rounded to the operand type once, on store.
// Instantiations (value type, operand type, sum type): (f32, f32, f32),
// (f32, bf16, f32), (f32, f64, f64), (f64, f64, f64).  Every idx must lie in
// [0, n_x): the kernel does not check it (the matrices check their
// columns when they are built).
//
// What bounds it.  idx, val and x are each needed once and y written once:
// at the finite-element flagship (n = 139,179, K = 80, m = 16, f32) that is
// 89.1 MB of idx and val and 8.9 MB each of x and y, 107 MB, 0.032 ms at
// 3.35 TB/s; its 2 n K m flops (0.36 GFLOP) take 0.005 ms.  Bytes bound it.
// But x is gathered, n K rows of m values (712 MB at that shape), so what
// the design must keep cheap is the gather, and the x block (9 MB) lives in
// the 50 MB L2.
//
// What the design does about it:
//   * x is read in its (n, m) layout: the m values of one gathered row are
//     one contiguous run, read by G neighbouring lanes as 16-byte vectors
//     (4 f32, 8 bf16 or 2 f64 values a lane; G the power of two that
//     covers m, at most 32, wider m in column chunks by blockIdx.y).  At
//     m = 16 in f32 four lanes read a 64-byte row in one request; from the
//     (m, n) layout the same row would be 16 scattered 4-byte loads.
//     Neighbouring rows of a block often share columns (the dofs of one
//     mesh node have one pattern), so many of a warp's gathers of one
//     instruction fall on the same row and are served once.
//   * idx and val are read once, in their stored layout, as 16-byte
//     vectors of 8 consecutive entries of a row (a full 32-byte sector of
//     idx and of f32 val a step) with evict-first loads, so that they do
//     not push x out of L2; the G lanes of a row load the same vector in
//     the same request.  This needs K % 8 == 0 (EllMatrix pads to 8) and
//     16-byte aligned bases; any other K takes a scalar loop.
//   * Each lane keeps its 2 to 8 sums in registers; the 8 gathers of a
//     step are issued before their multiply-adds, so a lane has 8 loads in
//     flight, held as loaded (32 registers) and widened one at a time.
//     256 threads a block, rows in order (one row a lane group), no
//     shared memory and no barrier.
//   * An operand whose rows are not whole 16-byte vectors (m % V != 0, an
//     unaligned base or row stride) takes the same design with one value a
//     lane (V = 1).
// Index arithmetic is 64-bit.  The kernel allocates nothing and does not
// synchronise.  Each entry point returns cudaGetLastError() after its
// launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kStep = 8;        // entries of a row a step of the vector loop

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

// One lane group of G = 1 << g_log2 lanes a row; a lane sums V columns.
template <typename TV, typename TX, typename TA, int V>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const int32_t* __restrict__ idx, const TV* __restrict__ val,
                const TX* __restrict__ x, TX* __restrict__ y, int64_t n,
                int64_t k, int64_t m, int64_t ldx, int64_t ys_row,
                int64_t ys_col, int g_log2, bool vec_entries) {
    const int lane = threadIdx.x;
    const int64_t row = static_cast<int64_t>(blockIdx.x)
        * (kThreads >> g_log2) + (lane >> g_log2);
    const int64_t col = (static_cast<int64_t>(blockIdx.y) << g_log2) * V
        + static_cast<int64_t>(lane & ((1 << g_log2) - 1)) * V;
    if (row >= n || col >= m) return;

    const int32_t* ip = idx + row * k;
    const TV* vp = val + row * k;
    const TX* xc = x + col;
    TA acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = TA(0);

    if (vec_entries) {
        for (int64_t kk = 0; kk < k; kk += kStep) {
            int32_t j[kStep];
            TA v[kStep];
            load_idx8(ip + kk, j);
            load_val8(vp + kk, v);
            typename Raw<TX, V>::type raw[kStep];
#pragma unroll
            for (int e = 0; e < kStep; ++e) {
                raw[e] = load_x<TX, V>(xc
                                       + static_cast<int64_t>(j[e]) * ldx);
            }
#pragma unroll
            for (int e = 0; e < kStep; ++e) {
                TA xv[V];
                widen<TX, TA, V>(raw[e], xv);
#pragma unroll
                for (int c = 0; c < V; ++c) {
                    acc[c] = fmadd(v[e], xv[c], acc[c]);
                }
            }
        }
    } else {
        for (int64_t kk = 0; kk < k; ++kk) {
            const int64_t j = __ldcs(ip + kk);
            const TA v = static_cast<TA>(__ldcs(vp + kk));
            TA xv[V];
            widen<TX, TA, V>(load_x<TX, V>(xc + j * ldx), xv);
#pragma unroll
            for (int c = 0; c < V; ++c) acc[c] = fmadd(v, xv[c], acc[c]);
        }
    }
    TX* yp = y + row * ys_row + col * ys_col;
#pragma unroll
    for (int c = 0; c < V; ++c) store(yp + c * ys_col, acc[c]);
}

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return err;
    return current == device ? cudaSuccess : cudaSetDevice(device);
}

template <typename TV, typename TX, typename TA, int V>
int launch_v(const void* idx, const void* val, const void* x, void* y,
             int64_t n, int64_t k, int64_t m, int64_t ldx, int64_t ys_row,
             int64_t ys_col, void* stream) {
    // lanes a row: the power of two that covers the row's vectors, at
    // most a warp; wider rows in column chunks of 32 vectors
    const int64_t vectors = (m + V - 1) / V;
    int g_log2 = 0;
    while (g_log2 < 5 && (int64_t{1} << g_log2) < vectors) ++g_log2;
    const int64_t chunks = (vectors + (int64_t{1} << g_log2) - 1) >> g_log2;
    const int64_t rows_per_block = kThreads >> g_log2;
    const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL || chunks > 65535) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const uintptr_t bases = reinterpret_cast<uintptr_t>(idx)
        | reinterpret_cast<uintptr_t>(val);
    const bool vec_entries = k % kStep == 0 && bases % 16 == 0;
    const dim3 grid(static_cast<unsigned int>(blocks),
                    static_cast<unsigned int>(chunks));
    ell_rows_kernel<TV, TX, TA, V>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(idx), static_cast<const TV*>(val),
            static_cast<const TX*>(x), static_cast<TX*>(y), n, k, m, ldx,
            ys_row, ys_col, g_log2, vec_entries);
    return static_cast<int>(cudaGetLastError());
}

template <typename TV, typename TX, typename TA>
int launch(const void* idx, const void* val, const void* x, void* y,
           int64_t n, int64_t k, int64_t m, int64_t ldx, int64_t ys_row,
           int64_t ys_col, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
    constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
    const bool wide = m % kVec == 0
        && (ldx * static_cast<int64_t>(sizeof(TX))) % 16 == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (wide) {
        return launch_v<TV, TX, TA, kVec>(idx, val, x, y, n, k, m, ldx,
                                          ys_row, ys_col, stream);
    }
    return launch_v<TV, TX, TA, 1>(idx, val, x, y, n, k, m, ldx, ys_row,
                                   ys_col, stream);
}

}  // namespace

// entry points: ell_spmm_<value type>_<operand type>
extern "C" int ell_spmm_f32_f32(const void* idx, const void* val,
                                const void* x, void* y, int64_t n, int64_t k,
                                int64_t m, int64_t ldx, int64_t ys_row,
                                int64_t ys_col, int device, void* stream) {
    return launch<float, float, float>(idx, val, x, y, n, k, m, ldx, ys_row,
                                       ys_col, device, stream);
}

extern "C" int ell_spmm_f32_bf16(const void* idx, const void* val,
                                 const void* x, void* y, int64_t n,
                                 int64_t k, int64_t m, int64_t ldx,
                                 int64_t ys_row, int64_t ys_col, int device,
                                 void* stream) {
    return launch<float, __nv_bfloat16, float>(idx, val, x, y, n, k, m, ldx,
                                               ys_row, ys_col, device,
                                               stream);
}

extern "C" int ell_spmm_f32_f64(const void* idx, const void* val,
                                const void* x, void* y, int64_t n, int64_t k,
                                int64_t m, int64_t ldx, int64_t ys_row,
                                int64_t ys_col, int device, void* stream) {
    return launch<float, double, double>(idx, val, x, y, n, k, m, ldx,
                                         ys_row, ys_col, device, stream);
}

extern "C" int ell_spmm_f64_f64(const void* idx, const void* val,
                                const void* x, void* y, int64_t n, int64_t k,
                                int64_t m, int64_t ldx, int64_t ys_row,
                                int64_t ys_col, int device, void* stream) {
    return launch<double, double, double>(idx, val, x, y, n, k, m, ldx,
                                          ys_row, ys_col, device, stream);
}
