// DIA SpMM over a pre-extended operand, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_window.py::build_dia_window_ring_ext, the
// per-shard Pallas kernel of the mesh-partitioned DIA SpMM.  A shard owns n
// lanes of the vector dimension and its own diagonal values; the caller
// hands it the operand already extended by its neighbours' edge lanes,
//
//     x_ext (m, halo_lo + n + halo_hi) = [left halo | local lanes | right halo]
//
// and the kernel computes
//
//     y[r, i] = sum_k val[k, i] * x_ext[r, halo_lo + i + off_k],   i < n,
//
// with val f32 (noff, n), passed at run time, and x_ext, y in f32 or bf16.
// There is no range check anywhere: the caller guarantees
// halo_lo >= -min(off) and a row of x_ext at least halo_lo + n + max(off)
// lanes long (the wrapper raises otherwise).  A term that falls outside the
// global matrix is not skipped, as csrc/dia_spmm.cu skips it: the ring of
// shards wraps, x_ext holds a finite wrapped lane there, and the value is
// zero, so the term adds 0 and the sum is the same float.
//
// What bounds it: memory, as its unsharded counterpart, and at a shard's
// size the launch itself (one eighth of lap3d 100x100x128 moves 26 MB).
// What the design does about it: the arithmetic and the thread layout of
// csrc/dia_spmm.cu (threads along the lanes, kRows f32 accumulators per
// thread, products and sums rounded separately in the plain version's order
// of diagonals, 64-bit indices), minus the two compares and the branch per
// (lane, diagonal), plus a row stride of its own for x_ext.  n, m, noff,
// the halos and the row stride have no alignment or size limits.
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
dia_rows_ext_kernel(const float* __restrict__ val, const T* __restrict__ x,
                    T* __restrict__ y, const int* __restrict__ offsets,
                    int64_t noff, int64_t m, int64_t n, int64_t groups,
                    int64_t x_stride, int64_t halo_lo) {
    const int64_t b = blockIdx.x;
    const int64_t r0 = (b % groups) * kRows;
    const int64_t i = (b / groups) * kThreads + threadIdx.x;
    if (i >= n) return;
    const int64_t left = m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

    const T* xr = x + r0 * x_stride + halo_lo + i;
    for (int64_t k = 0; k < noff; ++k) {
        const int64_t off = static_cast<int64_t>(offsets[k]);
        const float v = val[k * n + i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
                acc[r] = __fadd_rn(
                    acc[r], __fmul_rn(v, to_f32(xr[r * x_stride + off])));
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
           int64_t noff, int64_t m, int64_t n, int64_t x_stride,
           int64_t halo_lo, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t groups = (m + kRows - 1) / kRows;
    const int64_t blocks = groups * ((n + kThreads - 1) / kThreads);
    if (blocks <= 0 || blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    dia_rows_ext_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(val), static_cast<const T*>(x),
        static_cast<T*>(y), static_cast<const int*>(offsets), noff, m, n,
        groups, x_stride, halo_lo);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_stride: elements between two rows of x_ext.
extern "C" int dia_spmm_rows_ext_f32(const void* val, const void* x, void* y,
                                     const void* offsets, int64_t noff,
                                     int64_t m, int64_t n, int64_t x_stride,
                                     int64_t halo_lo, int device,
                                     void* stream) {
    return launch<float>(val, x, y, offsets, noff, m, n, x_stride, halo_lo,
                         device, stream);
}

extern "C" int dia_spmm_rows_ext_bf16(const void* val, const void* x, void* y,
                                      const void* offsets, int64_t noff,
                                      int64_t m, int64_t n, int64_t x_stride,
                                      int64_t halo_lo, int device,
                                      void* stream) {
    return launch<__nv_bfloat16>(val, x, y, offsets, noff, m, n, x_stride,
                                 halo_lo, device, stream);
}
