// Gram of two row blocks, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves the device LOBPCG's
// Grams (raleigh_tpu/core/device_solver.py::_gram) to XLA's dot; the port
// left them to torch.matmul, which cuBLAS runs as an M = N <= 48, K = n
// product, at n = 1,280,000 at about a fifth of the card's bandwidth.
// Added for that: for real f32 (ma, n) and (mb, n) row-major blocks A and
// B it computes
//
//     G[i, j] = sum_{k < n} A[i, k] B[j, k]          (G = A Bᵀ, (ma, mb))
//
// and with SELF (A is B) reads the one block once.  Instantiated at the
// LOBPCG's widths: (16, 16), its block m = 16, and (48, 48), its
// Rayleigh-Ritz basis of 3m rows; each with and without SELF.
//
// What bounds it.  Every input byte is read once and G written once: at n
// = 1,280,000 a (16, 16) Gram reads 163.8 MB (81.9 MB for SELF), 0.049 ms
// (0.0245) at 3.35 TB/s, against 0.65 GFLOP, 0.010 ms at 67 TFLOP/s of f32;
// a (48, 48) Gram reads 491.5 MB, 0.147 ms, against 5.9 GFLOP, 0.088 ms.
// Bytes bound both, the wide one at 60% of the f32 rate: its FMAs have to
// run from registers, not from shared memory.
//
// What this design does about it:
//   * The contraction is cut into one contiguous chunk a block, as many
//     blocks as fit the SMs at once (a multiple of 4 values a chunk), so
//     the whole card streams; each block leaves its (ma, mb) partial tile
//     in scratch, and a second launch (gram_gemm_sum_kernel) sums the
//     tiles in a fixed order: no float atomics, the same bits every call.
//   * A block streams its chunk through a ring of shared-memory stages,
//     kSpan contraction values of every row a stage, by cp.async, so that
//     the stages after the one being summed are in flight.  A row whose
//     base is 16-byte aligned is copied 16 bytes a lane; any other row (an
//     odd n puts three rows in four off the 16-byte grid) 4 bytes a lane,
//     into the same layout.  Values at or past the chunk's end are
//     zero-filled by the copy, so the sums read no masks.
//   * The output is split into 4 x 4 register tiles of (ma/4, mb/4), each
//     owned by 16 lanes (half a warp) that split the contraction: a lane
//     reads kPair neighbouring values of each of its ma/4 + mb/4 rows in
//     one load and makes (ma/4)(mb/4) kPair FMAs with them; the 16 lanes'
//     sums are added by shuffles in a fixed order at the end.
//   * The narrow Grams, which bytes bound, read 4 values a load (16-byte
//     loads: 8 loads for 64 FMAs) from spans of 128 in a ring of 4 stages:
//     94-96 registers, 2 blocks an SM.  The (48, 48) Gram keeps its 144
//     sums and 24 operands in registers (254), so 1 block of 8 warps an SM
//     runs it, which hides the loads' latency poorly: spans of 256 in a
//     ring of 2 stages halve its barriers, and 8-byte loads (24 loads for
//     288 FMAs, 0.67 bytes of shared memory an FMA) leave the registers
//     that 16-byte ones would take.  On an H100 (700 W) at n = 1,280,000
//     in CUDA graphs: (16, 16) 0.0705 ms, a self-Gram 0.0387 ms, (48, 48)
//     0.2118 ms, 69%, 63% and 69% of the byte bound; spans of 128 took the
//     wide Gram 0.247 ms, 8-byte loads the narrow ones 0.079 (PERF.md).
// FFMA in f32 only; no TF32, no lower precision.  Index arithmetic on the
// contraction is 64-bit.  The kernels allocate nothing and do not
// synchronise; the entry point returns cudaGetLastError() after each
// launch, so CUDA graph capture takes both launches as they are.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 4;       // G in kSplit x kSplit register tiles
constexpr int kLanes = kThreads / (kSplit * kSplit);   // lanes a tile: 16
// contraction values a lane reads at once (kPair) and a stage holds of
// a row (kSpan): for the narrow Grams, which bytes bound, and for the wide
// one (ma mb > 256), whose FMAs need the registers
constexpr int kNarrowPair = 4;
constexpr int kNarrowSpan = 128;
constexpr int kWidePair = 2;
constexpr int kWideSpan = 256;
constexpr int kMaxStages = 4;         // stages of the ring, at most
constexpr int kSmemBudget = 196608;   // bytes of the ring, at most
constexpr int kSumThreads = 1024;     // threads a block of the sum

template <int MA, int MB, bool SELF>
struct Gram {
    static constexpr int kRows = SELF ? MA : MA + MB;   // rows a stage
    static constexpr int kRa = MA / kSplit;             // register tile
    static constexpr int kRb = MB / kSplit;
    static constexpr bool kWide = MA * MB > 256;
    static constexpr int kPair = kWide ? kWidePair : kNarrowPair;
    static constexpr int kSpan = kWide ? kWideSpan : kNarrowSpan;
    static constexpr int kStageFloats = kRows * kSpan;
    static constexpr int kStages =
        kSmemBudget / (kStageFloats * 4) < kMaxStages
            ? kSmemBudget / (kStageFloats * 4) : kMaxStages;
    static constexpr int kSmem = kStages * kStageFloats * 4;
    static_assert(kStages >= 2, "a ring of two stages or more");
    static_assert(kSpan % 128 == 0, "16-byte copies of whole warps");
    static_assert(kSpan % (kLanes * kPair) == 0, "whole lane groups");
    static_assert(MA % kSplit == 0 && MB % kSplit == 0, "tile widths");
    static_assert(MA * MB % 32 == 0, "the sum kernel's blocks");
    static_assert(!SELF || MA == MB, "a self-Gram is square");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte copies to the shared-memory address dst; src_bytes less
// than the copy fills zeros for the rest (0: reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copies the contraction values [t0, t0 + kSpan) of every row into the
// stage at shared address `stage` (row r at r * kSpan floats; rows of A,
// then of B unless SELF), zeros at and past `end`.  Warp w takes rows w,
// w + kWarps, ...
template <int MA, int MB, bool SELF>
__device__ __forceinline__ void stage_span(uint32_t stage, const float* a,
                                           const float* b, int64_t n,
                                           int64_t t0, int64_t end) {
    constexpr int kSpan = Gram<MA, MB, SELF>::kSpan;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
    for (int r = warp; r < Gram<MA, MB, SELF>::kRows; r += kWarps) {
        const float* row = r < MA ? a + static_cast<int64_t>(r) * n
                                  : b + static_cast<int64_t>(r - MA) * n;
        const uint32_t dst = stage + static_cast<uint32_t>(r * kSpan * 4);
        if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
#pragma unroll
            for (int q = 0; q < kSpan / 128; ++q) {
                const int64_t k = t0 + 4 * (lane + 32 * q);
                const int64_t left = end - k;
                const int bytes = left >= 4 ? 16
                    : (left > 0 ? static_cast<int>(left) * 4 : 0);
                cp_async16(dst + 16 * (lane + 32 * q), bytes ? row + k : row,
                           bytes);
            }
        } else {
#pragma unroll
            for (int q = 0; q < kSpan / 32; ++q) {
                const int64_t k = t0 + lane + 32 * q;
                const bool in = k < end;
                cp_async4(dst + 4 * (lane + 32 * q), in ? row + k : row,
                          in ? 4 : 0);
            }
        }
    }
}

// kPair neighbouring floats from shared memory in one load
template <int P>
__device__ __forceinline__ void load_pair(const float* p, float (&v)[P]) {
    if constexpr (P == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x;
        v[1] = t.y;
    } else {
        static_assert(P == 4, "2 or 4 floats a load");
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
    }
}

// Adds one stage to a lane's register tile: rows ta * kRa.. of A against
// rows tb * kRb.. of B, the lane's values kPair at a time, in order.
template <int MA, int MB, bool SELF>
__device__ __forceinline__ void accumulate(
        const float* stage, int ta, int tb, int lane,
        float (&acc)[Gram<MA, MB, SELF>::kRa][Gram<MA, MB, SELF>::kRb]) {
    constexpr int kRa = Gram<MA, MB, SELF>::kRa;
    constexpr int kRb = Gram<MA, MB, SELF>::kRb;
    constexpr int kPair = Gram<MA, MB, SELF>::kPair;
    constexpr int kSpan = Gram<MA, MB, SELF>::kSpan;
    const float* sa = stage + ta * kRa * kSpan;
    const float* sb = stage + ((SELF ? 0 : MA) + tb * kRb) * kSpan;
#pragma unroll
    for (int g = 0; g < kSpan / (kLanes * kPair); ++g) {
        const int kk = (g * kLanes + lane) * kPair;
        float av[kRa][kPair];
#pragma unroll
        for (int i = 0; i < kRa; ++i) load_pair(sa + i * kSpan + kk, av[i]);
#pragma unroll
        for (int j = 0; j < kRb; ++j) {
            float bv[kPair];
            load_pair(sb + j * kSpan + kk, bv);
#pragma unroll
            for (int q = 0; q < kPair; ++q) {
#pragma unroll
                for (int i = 0; i < kRa; ++i) {
                    acc[i][j] = __fmaf_rn(av[i][q], bv[q], acc[i][j]);
                }
            }
        }
    }
}

// Block c's partial tile of G over the contraction values [c * chunk,
// min((c + 1) * chunk, n)), written to partial[c] ((MA, MB) row-major).
// T is float; it names the type in the profiler's kernel name.
template <typename T, int MA, int MB, bool SELF>
__global__ void __launch_bounds__(kThreads, 1)
gram_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ partial, int64_t n, int64_t chunk) {
    static_assert(sizeof(T) == 4, "f32 blocks");
    using G = Gram<MA, MB, SELF>;
    extern __shared__ __align__(16) float smem[];
    const int tile = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    const int ta = tile / kSplit, tb = tile % kSplit;
    const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
    const int64_t end = begin + chunk < n ? begin + chunk : n;
    const int spans =
        static_cast<int>((end - begin + G::kSpan - 1) / G::kSpan);
    const uint32_t base = smem_addr(smem);
    const float* fa = reinterpret_cast<const float*>(a);
    const float* fb = reinterpret_cast<const float*>(SELF ? a : b);

    float acc[G::kRa][G::kRb];
#pragma unroll
    for (int i = 0; i < G::kRa; ++i) {
#pragma unroll
        for (int j = 0; j < G::kRb; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll 1
    for (int s = 0; s < G::kStages - 1; ++s) {
        if (s < spans) {
            stage_span<MA, MB, SELF>(base + s * G::kStageFloats * 4, fa, fb,
                                     n, begin + int64_t{s} * G::kSpan, end);
        }
        cp_async_commit();
    }
#pragma unroll 1
    for (int t = 0; t < spans; ++t) {
        cp_async_wait<G::kStages - 2>();
        __syncthreads();
        // the stage this refills was summed in the previous round, which
        // every thread has left at the barrier above
        const int next = t + G::kStages - 1;
        if (next < spans) {
            stage_span<MA, MB, SELF>(
                base + (next % G::kStages) * G::kStageFloats * 4, fa, fb, n,
                begin + int64_t{next} * G::kSpan, end);
        }
        cp_async_commit();
        accumulate<MA, MB, SELF>(smem + (t % G::kStages) * G::kStageFloats, ta,
                                 tb, lane, acc);
    }
    cp_async_wait<0>();

    float* out = reinterpret_cast<float*>(partial)
        + static_cast<int64_t>(blockIdx.x) * MA * MB;
#pragma unroll
    for (int i = 0; i < G::kRa; ++i) {
#pragma unroll
        for (int j = 0; j < G::kRb; ++j) {
            float v = acc[i][j];
#pragma unroll
            for (int off = kLanes / 2; off > 0; off >>= 1) {
                v += __shfl_xor_sync(0xffffffffu, v, off);
            }
            if (lane == 0) out[(ta * G::kRa + i) * MB + tb * G::kRb + j] = v;
        }
    }
}

// G[e] = the sum over p < parts of partial[p][e], p in order within each
// of kSumWarps slices (p = w, w + kSumWarps, ...), then the slices in
// order.  Block c sums the entries [32 c, 32 c + 32).
constexpr int kSumWarps = kSumThreads / 32;

template <typename T, int MA, int MB>
__global__ void __launch_bounds__(kSumThreads)
gram_gemm_sum_kernel(const T* __restrict__ partial, T* __restrict__ g,
                     int parts) {
    __shared__ float sums[kSumWarps][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * 32 + lane;
    float s = 0.0f;
#pragma unroll 8
    for (int p = warp; p < parts; p += kSumWarps) {
        s += static_cast<float>(
            partial[static_cast<int64_t>(p) * MA * MB + e]);
    }
    sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
        float t = sums[0][lane];
#pragma unroll
        for (int w = 1; w < kSumWarps; ++w) t += sums[w][lane];
        g[e] = static_cast<T>(t);
    }
}

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return err;
    return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Resident blocks an SM of an instantiation with its shared memory, and
// the device's SMs; the first call for a kernel and device also raises
// its limit of dynamic shared memory.  Cached, so that a launch asks the
// runtime once per kernel and device.
constexpr int kMaxDevices = 64;

struct Fit {
    int per_sm, sms;
};

template <int MA, int MB, bool SELF>
cudaError_t fit(int device, Fit* out) {
    static Fit fits[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    Fit& f = fits[device];
    if (f.per_sm == 0) {
        auto kernel = gram_gemm_kernel<float, MA, MB, SELF>;
        constexpr int smem = Gram<MA, MB, SELF>::kSmem;
        cudaError_t err = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(kernel),
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err != cudaSuccess) return err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, reinterpret_cast<const void*>(kernel), kThreads, smem);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        f.per_sm = per_sm;
    }
    *out = f;
    return cudaSuccess;
}

template <int MA, int MB, bool SELF>
int launch(const void* a, const void* b, void* partial, void* g, int64_t n,
           int device, void* stream) {
    Fit f{};
    cudaError_t err = fit<MA, MB, SELF>(device, &f);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t most = static_cast<int64_t>(f.per_sm) * f.sms;
    const int64_t chunk = ((n + most - 1) / most + 3) / 4 * 4;
    const int64_t blocks = (n + chunk - 1) / chunk;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    gram_gemm_kernel<float, MA, MB, SELF>
        <<<static_cast<unsigned int>(blocks), kThreads,
           Gram<MA, MB, SELF>::kSmem, s>>>(
            static_cast<const float*>(a), static_cast<const float*>(b),
            static_cast<float*>(partial), n, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_gemm_sum_kernel<float, MA, MB><<<MA * MB / 32, kSumThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(g),
        static_cast<int>(blocks));
    return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, resident blocks an SM, the partial tiles a
// launch can leave (blocks an SM times SMs: the scratch it needs), local
// (spill) bytes a thread.
template <int MA, int MB, bool SELF>
cudaError_t occupancy(int device, int64_t* out) {
    Fit f{};
    cudaError_t err = fit<MA, MB, SELF>(device, &f);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(
        &attr, reinterpret_cast<const void*>(
                   gram_gemm_kernel<float, MA, MB, SELF>));
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = f.per_sm;
    out[2] = static_cast<int64_t>(f.per_sm) * f.sms;
    out[3] = static_cast<int64_t>(attr.localSizeBytes);
    return cudaSuccess;
}

}  // namespace

// G (ma, mb) = A Bᵀ for f32 row blocks A (ma, n) and B (mb, n), row-major
// and contiguous; own = 1: B is A, read once (b is ignored).  `partial`
// holds gram_f32_occupancy's out[2] tiles of (ma, mb).  Widths other than
// (16, 16) and (48, 48), or n < 1, return cudaErrorInvalidValue.
extern "C" int gram_f32(const void* a, const void* b, void* partial,
                        void* g, int64_t ma, int64_t mb, int64_t n, int own,
                        int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (ma == 16 && mb == 16) {
        return own ? launch<16, 16, true>(a, a, partial, g, n, device, stream)
                   : launch<16, 16, false>(a, b, partial, g, n, device,
                                           stream);
    }
    if (ma == 48 && mb == 48) {
        return own ? launch<48, 48, true>(a, a, partial, g, n, device, stream)
                   : launch<48, 48, false>(a, b, partial, g, n, device,
                                           stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// Fills out[4] as ``occupancy`` says for the instantiation (ma, mb, own);
// nothing is launched.
extern "C" int gram_f32_occupancy(int64_t ma, int64_t mb, int own,
                                  int device, int64_t* out) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (ma == 16 && mb == 16) {
        err = own ? occupancy<16, 16, true>(device, out)
                  : occupancy<16, 16, false>(device, out);
    } else if (ma == 48 && mb == 48) {
        err = own ? occupancy<48, 48, true>(device, out)
                  : occupancy<48, 48, false>(device, out);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
