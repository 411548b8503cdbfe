// DIA SpMM on row-layout operand blocks, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_window.py::build_dia_window_ring, the
// sliding-window Pallas kernel that carries every DIA operator apply of the
// device LOBPCG and of the Chebyshev preconditioner.  It computes
//
//     y[r, i] = sum_k val[k, i] * x[r, i + off_k]      (terms with
//               i + off_k outside [0, n) are zero)
//
// with val f32 (noff, n) and x, y (m, n) in f32 or bf16.  For every output
// the products __fmul_rn(val, x) are added with __fadd_rn in diagonal
// order, starting from 0, and the sum is rounded to the operand type once,
// on store: the order of the plain PyTorch version in ops/spmm_window.py,
// so the kernel equals it bit for bit (and the mesh kernel in
// dia_spmm_ext.cu equals this one).
//
// What bounds it, as measured.  One apply must move noff*n*4 + 2*m*n*b
// bytes (b = 4 for f32, 2 for bf16) for 2*noff*m*n flops: 200 MB in f32
// and 118 MB in bf16 at the main path's shape (lap3d 100x100x128:
// n = 1.28e6, m = 16, noff = 7), 0.060 / 0.035 ms at 3.35 TB/s.  The
// previous design (PERF.md; deleted since) took 0.113 ms in
// f32 and 0.105 ms in bf16 on an H100: 41% fewer bytes bought 7% less
// time, so its time followed its load instructions and their round
// trips, not bytes.  Each of its threads owned one lane and walked the
// diagonals in a run-time loop with a range check, so the loads of one
// diagonal waited for the adds of the one before (7 round trips on
// lap3d), and every load was one scalar (2 bytes in bf16): 7 loads a
// lane and row.
//
// What this design does about it: fewer load instructions, with the
// previous design's run-time loop over the diagonals, which keeps a
// thread's registers few and the threads an SM many.
//   * A thread owns kLanes = 4 neighbouring lanes (i .. i + 3, i a multiple
//     of 4) and kRows = 4 operand rows; blocks of 128 threads.
//   * Each row's lanes come as whole aligned vectors: val in one 16-byte
//     load, x in one 16-byte (f32) or 8-byte (bf16) load where the shift
//     keeps them aligned (an offset that is a multiple of 4: on lap3d 0,
//     +-nx and +-nx*ny, five of seven), and in two aligned loads and a
//     register shift where it does not (+-1).  On lap3d that is 9 operand
//     loads for a row and 4 lanes against 28, for the same bytes.  The
//     offset's remainder is the same for every thread, so the branch on it
//     never diverges.
//   * Lane tiles at an edge of [0, n), n not a multiple of 4 and unaligned
//     bases take scalar loads with a range check per lane; a term outside
//     [0, n) is skipped, as the plain version skips it.
//   * Index arithmetic is 64-bit; n, m and noff have no alignment or size
//     limits.
// Designs tried on the way (PERF.md), each slower than the previous
// design at every shape: all rows in one block with the loads of 8
// diagonals issued before the first add, as 16-byte vectors (110-150
// registers, 0.17-0.32 ms at m = 16) or as scalars (62-106 registers,
// 0.14-0.26 ms).  With fewer threads an SM the round trips they saved
// came back as latency: occupancy, not the count of round trips, decides.
//
// The f64 instantiation (dia_spmm_rows_f64_val32 / _val64) serves the core
// Solver's f64 blocks: x and y f64, val f32 (the card's canonical storage)
// or f64, each value widened to f64 on load (exactly), every product and
// sum rounded in f64 (__dmul_rn, __dadd_rn) in diagonal order from 0 — the
// order of the plain version, which promotes val to f64, so the two are
// again equal bit for bit.  It is the design above widened, with no
// redesign: a thread owns kLanes = 2 neighbouring lanes (one 16-byte
// double2 of x, an 8- or 16-byte vector of val) and 4 rows.  One apply
// must move noff*n*sizeof(val) + 2*m*n*8 bytes: at lap3d(100,100,128) and
// m = 16 with f32 values 363.5 MB, 0.1085 ms at 3.35 TB/s.
//
// The complex instantiation (dia_spmm_rows_c128_val32 / _val64 / _val128)
// serves complex blocks on the card: x and y c128, val f32, f64 (a real
// matrix; f32 is the card's canonical storage of real f64 values) or c128
// (a Hermitian one such as the complex shift-invert pencil's B).  Its
// terms are
//
//     y[r, i] = sum_k val[k, i] * x[r, i + off_k]   (zero outside [0, n)),
//
// summed in diagonal order from 0 in f64, the real and imaginary parts by
// fused multiply-adds: for a real value a and x = c + i d,
//     re = fma(a, c, re); im = fma(a, d, im);
// for a complex value a + i b,
//     re = fma(a, c, re); re = fma(-b, d, re);
//     im = fma(a, d, im); im = fma(b, c, im).
// The plain version's PyTorch complex arithmetic may round each product
// before its sum, so the two may differ by the rounding of the products,
// a few units of the last place of the largest term (on an H100 they
// agreed bit for bit on the complex field's B).  It replaces the stacked route of ops/complex_rows.py,
// which for c128 values made two launches of the f64 instantiation over a
// concatenated (2m, n) block, two contiguous copies of the values' real
// and imaginary parts, and the slices, adds and torch.complex that put the
// result together (about eight launches to move the bytes of one apply).
// What bounds it: one apply must move noff*n*sizeof(val) + 2*m*n*16 bytes:
// on the complex field's B (3 diagonals, n = 125,000, c128 values, m = 8)
// 38 MB, 0.0113 ms at 3.35 TB/s.  Design: a simple one that reads the
// tensors' interleaved storage directly, each c128 element one 16-byte
// load or store.  A thread owns one lane i and kRows = 4 rows; neighbouring
// threads own neighbouring lanes, so every load of x and store of y is
// coalesced along i.  For each diagonal it loads its value once and the 4
// rows' x, so each thread has 4 gathers in flight.
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// ---- the kernel on the path ---------------------------------------------

constexpr int kLanes = 4;      // neighbouring lanes a thread
constexpr int kRows = 4;       // operand rows a thread
constexpr int kThreads = 128;  // threads a block

// kLanes neighbouring elements in one load
template <typename T>
struct Vec;
template <>
struct Vec<float> { using type = float4; };
template <>
struct Vec<__nv_bfloat16> { using type = uint2; };
template <typename T>
using VecT = typename Vec<T>::type;

__device__ __forceinline__ void unpack(float4 v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
}
// bf16 to f32 is exact: the 16 bits become the high half of the word
__device__ __forceinline__ void unpack(unsigned int v, float* f) {
    f[0] = __uint_as_float(v << 16);
    f[1] = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint2 v, float* f) {
    unpack(v.x, f);
    unpack(v.y, f + 2);
}

// __float2bfloat16 rounds each value as the scalar store does
__device__ __forceinline__ unsigned int bf16_pair(float a, float b) {
    __nv_bfloat162 h;
    h.x = __float2bfloat16(a);
    h.y = __float2bfloat16(b);
    return *reinterpret_cast<const unsigned int*>(&h);
}
__device__ __forceinline__ void store_lanes(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_lanes(__nv_bfloat16* p,
                                            const float* a) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]));
}

// One diagonal's terms of every row of the group, its kLanes lanes read as
// whole aligned vectors from lane ``base`` on: one vector a row when the
// shift S = off mod kLanes is 0, two and a register shift otherwise.
template <int S, typename T>
__device__ __forceinline__ void add_vectors(
        const T* __restrict__ xr, int64_t n, int64_t base, int rows,
        const float (&v)[kLanes], float (&acc)[kRows][kLanes]) {
    using V = VecT<T>;
    V lo[kRows], hi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            const V* p = reinterpret_cast<const V*>(xr + r * n + base);
            lo[r] = p[0];
            if constexpr (S != 0) hi[r] = p[1];
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            float f[2 * kLanes];
            unpack(lo[r], f);
            if constexpr (S != 0) unpack(hi[r], f + kLanes);
#pragma unroll
            for (int e = 0; e < kLanes; ++e) {
                acc[r][e] = __fadd_rn(acc[r][e], __fmul_rn(v[e], f[S + e]));
            }
        }
    }
}

// Block b covers row group b % groups and lanes i .. i + kLanes - 1 of
// thread t, i = kLanes * ((b / groups) * kThreads + t).  ``aligned``: n a
// multiple of kLanes and 16-byte bases, so that kLanes lanes from a lane
// that is a multiple of kLanes are one aligned load.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_lanes_kernel(const float* __restrict__ val, const T* __restrict__ x,
                 T* __restrict__ y, const int* __restrict__ offsets,
                 int64_t noff, int64_t m, int64_t n, int64_t groups,
                 bool aligned) {
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t i = kLanes * ((b / groups) * kThreads + threadIdx.x);
    if (i >= n) return;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;
    const int lanes = n - i < kLanes ? static_cast<int>(n - i) : kLanes;
    const bool whole = aligned && lanes == kLanes;

    float acc[kRows][kLanes];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int e = 0; e < kLanes; ++e) acc[r][e] = 0.0f;
    }

    const T* xr = x + r0 * n;
    for (int64_t k = 0; k < noff; ++k) {
        const int off = __ldg(offsets + k);
        const int64_t j = i + off;   // the source of the first lane
        if (j + lanes <= 0 || j >= n) continue;   // no lane in range
        float v[kLanes];
        if (whole) {
            unpack(__ldg(reinterpret_cast<const VecT<float>*>(
                       val + k * n + i)),
                   v);
        } else {
#pragma unroll
            for (int e = 0; e < kLanes; ++e) {
                v[e] = e < lanes ? __ldg(val + k * n + i + e) : 0.0f;
            }
        }
        const int s = off & (kLanes - 1);   // the same for every thread
        const int64_t base = j - s;
        if (whole && base >= 0 && base + 2 * kLanes <= n) {
            // every lane in range
            switch (s) {
                case 0: add_vectors<0>(xr, n, base, rows, v, acc); break;
                case 1: add_vectors<1>(xr, n, base, rows, v, acc); break;
                case 2: add_vectors<2>(xr, n, base, rows, v, acc); break;
                default: add_vectors<3>(xr, n, base, rows, v, acc); break;
            }
            continue;
        }
        // a lane tile at an edge of [0, n), or an unaligned operand:
        // scalars, and a term outside [0, n) skipped
        T xs[kRows][kLanes];
        bool in[kLanes];
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            in[e] = e < lanes && j + e >= 0 && j + e < n;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r < rows) xs[r][e] = in[e] ? xr[r * n + j + e] : T();
            }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
#pragma unroll
                for (int e = 0; e < kLanes; ++e) {
                    const float t = __fadd_rn(
                        acc[r][e], __fmul_rn(v[e], to_f32(xs[r][e])));
                    acc[r][e] = in[e] ? t : acc[r][e];
                }
            }
        }
    }

    T* yr = y + r0 * n + i;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            if (whole) {
                store_lanes(yr + r * n, acc[r]);
            } else {
#pragma unroll
                for (int e = 0; e < kLanes; ++e) {
                    if (e < lanes) store(yr + r * n + e, acc[r][e]);
                }
            }
        }
    }
}

template <typename T>
int launch(const void* val, const void* x, void* y, const void* offsets,
           int64_t noff, int64_t m, int64_t n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t tiles = (n + kLanes * kThreads - 1) / (kLanes * kThreads);
    const int64_t blocks = groups * tiles;
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val)
        | reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
    const bool aligned = n % kLanes == 0 && bases % 16 == 0;
    dia_lanes_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(val), static_cast<const T*>(x),
        static_cast<T*>(y), static_cast<const int*>(offsets), noff, m, n,
        groups, aligned);
    return static_cast<int>(cudaGetLastError());
}

// ---- the f64 instantiation ----------------------------------------------

namespace wide {

constexpr int kLanes = 2;      // neighbouring lanes a thread: one double2
constexpr int kRows = 4;       // operand rows a thread
constexpr int kThreads = 128;  // threads a block

// kLanes values of val in one load
template <typename V>
struct ValVec;
template <>
struct ValVec<float> { using type = float2; };
template <>
struct ValVec<double> { using type = double2; };

// f32 to f64 is exact
__device__ __forceinline__ void unpack(float2 v, double* f) {
    f[0] = v.x;
    f[1] = v.y;
}
__device__ __forceinline__ void unpack(double2 v, double* f) {
    f[0] = v.x;
    f[1] = v.y;
}

// One diagonal's terms of every row of the group, its kLanes lanes read as
// whole aligned double2 from lane ``base`` on: one a row when the shift
// S = off mod kLanes is 0, two otherwise.
template <int S>
__device__ __forceinline__ void add_vectors(
        const double* __restrict__ xr, int64_t n, int64_t base, int rows,
        const double (&v)[kLanes], double (&acc)[kRows][kLanes]) {
    double2 lo[kRows], hi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            const double2* p =
                reinterpret_cast<const double2*>(xr + r * n + base);
            lo[r] = p[0];
            if constexpr (S != 0) hi[r] = p[1];
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            double f[2 * kLanes];
            unpack(lo[r], f);
            if constexpr (S != 0) unpack(hi[r], f + kLanes);
#pragma unroll
            for (int e = 0; e < kLanes; ++e) {
                acc[r][e] = __dadd_rn(acc[r][e], __dmul_rn(v[e], f[S + e]));
            }
        }
    }
}

// Block b covers row group b % groups and lanes i, i + 1 of thread t,
// i = kLanes * ((b / groups) * kThreads + t).  ``aligned``: n even and
// 16-byte bases.
template <typename V>
__global__ void __launch_bounds__(kThreads)
dia_lanes_kernel(const V* __restrict__ val, const double* __restrict__ x,
                 double* __restrict__ y, const int* __restrict__ offsets,
                 int64_t noff, int64_t m, int64_t n, int64_t groups,
                 bool aligned) {
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t i = kLanes * ((b / groups) * kThreads + threadIdx.x);
    if (i >= n) return;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;
    const int lanes = n - i < kLanes ? static_cast<int>(n - i) : kLanes;
    const bool whole = aligned && lanes == kLanes;

    double acc[kRows][kLanes];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int e = 0; e < kLanes; ++e) acc[r][e] = 0.0;
    }

    const double* xr = x + r0 * n;
    for (int64_t k = 0; k < noff; ++k) {
        const int off = __ldg(offsets + k);
        const int64_t j = i + off;   // the source of the first lane
        if (j + lanes <= 0 || j >= n) continue;   // no lane in range
        double v[kLanes];
        if (whole) {
            unpack(__ldg(reinterpret_cast<const typename ValVec<V>::type*>(
                       val + k * n + i)),
                   v);
        } else {
#pragma unroll
            for (int e = 0; e < kLanes; ++e) {
                v[e] = e < lanes ? static_cast<double>(__ldg(val + k * n + i
                                                             + e))
                                 : 0.0;
            }
        }
        const int s = off & (kLanes - 1);   // the same for every thread
        const int64_t base = j - s;
        if (whole && base >= 0 && base + 2 * kLanes <= n) {
            if (s == 0) {
                add_vectors<0>(xr, n, base, rows, v, acc);
            } else {
                add_vectors<1>(xr, n, base, rows, v, acc);
            }
            continue;
        }
        // a lane pair at an edge of [0, n), or an unaligned operand:
        // scalars, and a term outside [0, n) skipped
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            const bool in = e < lanes && j + e >= 0 && j + e < n;
            if (!in) continue;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r < rows) {
                    acc[r][e] = __dadd_rn(
                        acc[r][e], __dmul_rn(v[e], xr[r * n + j + e]));
                }
            }
        }
    }

    double* yr = y + r0 * n + i;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
            if (whole) {
                *reinterpret_cast<double2*>(yr + r * n) =
                    make_double2(acc[r][0], acc[r][1]);
            } else {
#pragma unroll
                for (int e = 0; e < kLanes; ++e) {
                    if (e < lanes) yr[r * n + e] = acc[r][e];
                }
            }
        }
    }
}

template <typename V>
int launch(const void* val, const void* x, void* y, const void* offsets,
           int64_t noff, int64_t m, int64_t n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t tiles = (n + kLanes * kThreads - 1) / (kLanes * kThreads);
    const int64_t blocks = groups * tiles;
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val)
        | reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
    const bool aligned = n % kLanes == 0 && bases % 16 == 0;
    dia_lanes_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(val), static_cast<const double*>(x),
        static_cast<double*>(y), static_cast<const int*>(offsets), noff, m,
        n, groups, aligned);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

// ---- the complex instantiation ------------------------------------------

namespace cplx {

constexpr int kRows = 4;       // operand rows a thread
constexpr int kThreads = 128;  // threads a block

// acc += v * x for a real value v, or a complex one (double2: re, im), in
// the order the note states
__device__ __forceinline__ void madd(double v, double2 x, double2& acc) {
    acc.x = __fma_rn(v, x.x, acc.x);
    acc.y = __fma_rn(v, x.y, acc.y);
}
__device__ __forceinline__ void madd(float v, double2 x, double2& acc) {
    madd(static_cast<double>(v), x, acc);
}
__device__ __forceinline__ void madd(double2 v, double2 x, double2& acc) {
    acc.x = __fma_rn(v.x, x.x, acc.x);
    acc.x = __fma_rn(-v.y, x.y, acc.x);
    acc.y = __fma_rn(v.x, x.y, acc.y);
    acc.y = __fma_rn(v.y, x.x, acc.y);
}

// Block b covers row group b % groups and lane i = (b / groups) * kThreads
// + t of thread t.
template <typename V>
__global__ void __launch_bounds__(kThreads)
dia_complex_kernel(const V* __restrict__ val, const double2* __restrict__ x,
                   double2* __restrict__ y, const int* __restrict__ offsets,
                   int64_t noff, int64_t m, int64_t n, int64_t groups) {
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t i = (b / groups) * kThreads + threadIdx.x;
    if (i >= n) return;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;

    double2 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_double2(0.0, 0.0);

    const double2* xr = x + r0 * n;
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t j = i + __ldg(offsets + k);
        if (j < 0 || j >= n) continue;   // the term is zero
        const V v = __ldg(val + k * n + i);
        double2 xs[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) xs[r] = __ldg(xr + r * n + j);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) madd(v, xs[r], acc[r]);
        }
    }
    double2* yr = y + r0 * n + i;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) yr[r * n] = acc[r];
    }
}

template <typename V>
int launch(const void* val, const void* x, void* y, const void* offsets,
           int64_t noff, int64_t m, int64_t n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t blocks = groups * ((n + kThreads - 1) / kThreads);
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    dia_complex_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(val), static_cast<const double2*>(x),
        static_cast<double2*>(y), static_cast<const int*>(offsets), noff, m,
        n, groups);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace cplx

}  // namespace

// entry points
extern "C" int dia_spmm_rows_f32(const void* val, const void* x, void* y,
                                 const void* offsets, int64_t noff,
                                 int64_t m, int64_t n, int device,
                                 void* stream) {
    return launch<float>(val, x, y, offsets, noff, m, n, device, stream);
}

extern "C" int dia_spmm_rows_bf16(const void* val, const void* x, void* y,
                                  const void* offsets, int64_t noff,
                                  int64_t m, int64_t n, int device,
                                  void* stream) {
    return launch<__nv_bfloat16>(val, x, y, offsets, noff, m, n, device,
                                 stream);
}

// the f64 instantiation: f64 operand, f32 or f64 values
extern "C" int dia_spmm_rows_f64_val32(const void* val, const void* x,
                                       void* y, const void* offsets,
                                       int64_t noff, int64_t m, int64_t n,
                                       int device, void* stream) {
    return wide::launch<float>(val, x, y, offsets, noff, m, n, device,
                               stream);
}

extern "C" int dia_spmm_rows_f64_val64(const void* val, const void* x,
                                       void* y, const void* offsets,
                                       int64_t noff, int64_t m, int64_t n,
                                       int device, void* stream) {
    return wide::launch<double>(val, x, y, offsets, noff, m, n, device,
                                stream);
}

// the complex instantiation: c128 operand, f32, f64 or c128 values
extern "C" int dia_spmm_rows_c128_val32(const void* val, const void* x,
                                        void* y, const void* offsets,
                                        int64_t noff, int64_t m, int64_t n,
                                        int device, void* stream) {
    return cplx::launch<float>(val, x, y, offsets, noff, m, n, device,
                               stream);
}

extern "C" int dia_spmm_rows_c128_val64(const void* val, const void* x,
                                        void* y, const void* offsets,
                                        int64_t noff, int64_t m, int64_t n,
                                        int device, void* stream) {
    return cplx::launch<double>(val, x, y, offsets, noff, m, n, device,
                                stream);
}

extern "C" int dia_spmm_rows_c128_val128(const void* val, const void* x,
                                         void* y, const void* offsets,
                                         int64_t noff, int64_t m, int64_t n,
                                         int device, void* stream) {
    return cplx::launch<double2>(val, x, y, offsets, noff, m, n, device,
                                 stream);
}
