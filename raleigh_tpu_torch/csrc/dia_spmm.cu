// DIA SpMM on row-layout operand blocks, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_window.py::build_dia_window_ring, the
// sliding-window Pallas kernel that carries every DIA operator apply of the
// device LOBPCG and of the Chebyshev preconditioner.  It computes
//
//     y[r, i] = sum_k val[k, i] * x[r, i + off_k]      (terms with
//               i + off_k outside [0, n) are zero)
//
// with val f32 (noff, n) and x, y (m, n) in f32 or bf16.  Every product and
// sum is taken in f32; the result is rounded to the operand type once, on
// store.
//
// What bounds it: memory.  One apply moves at least noff*n*4 + 2*m*n*b
// bytes (b = 4 for f32, 2 for bf16) for 2*noff*m*n flops, under half a flop
// per byte.  At the main path's shape (lap3d 100x100x128: n = 1.28e6,
// m = 16, noff = 7) that is 200 MB in f32 and 118 MB in bf16.
//
// What the design does about it:
//   * Threads run along the lane dimension i, so a warp's loads of val[k, :]
//     and of each shifted row x[r, i + off_k] are contiguous and coalesced.
//   * The TPU kernel's DMA ring existed to read x from HBM once through
//     VMEM.  Here the shifted re-reads of x are served by L1 and the 50 MB
//     L2: the blocks in flight cover a lane range wider than the stencil's
//     reach, so each element of x leaves device memory about once.
//   * Each thread keeps kRows f32 accumulators, one per operand row, so one
//     load of val[k, i] serves kRows rows.  The row groups of one lane tile
//     are consecutive blocks and find val and x in L2.
//   * Products and sums are rounded separately (__fmul_rn, __fadd_rn), in
//     the order of the plain PyTorch version in ops/spmm_window.py, so the
//     two can be held together at f32 rounding level.
//   * Index arithmetic is 64-bit; n, m and noff have no alignment or size
//     limits.
// The kernel allocates nothing and does not synchronise.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// Block b covers row group b % groups and lane tile b / groups.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_rows_kernel(const float* __restrict__ val, const T* __restrict__ x,
                T* __restrict__ y, const int* __restrict__ offsets,
                int64_t noff, int64_t m, int64_t n, int64_t groups) {
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t i = (b / groups) * kThreads + threadIdx.x;
    if (i >= n) return;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

    const T* xr = x + r0 * n;
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t j = i + static_cast<int64_t>(offsets[k]);
        if (j < 0 || j >= n) continue;
        const float v = val[k * n + i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
                acc[r] = __fadd_rn(acc[r],
                                   __fmul_rn(v, to_f32(xr[r * n + j])));
            }
        }
    }

    T* yr = y + r0 * n + i;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) store(yr + r * n, acc[r]);
    }
}

template <typename T>
int launch(const void* val, const void* x, void* y, const void* offsets,
           int64_t noff, int64_t m, int64_t n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t blocks = groups * ((n + kThreads - 1) / kThreads);
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    dia_rows_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(val), static_cast<const T*>(x),
        static_cast<T*>(y), static_cast<const int*>(offsets), noff, m, n,
        groups);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
