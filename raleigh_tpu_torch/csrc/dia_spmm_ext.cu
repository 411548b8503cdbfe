// DIA SpMM of a mesh-partitioned operator, every shard of a device in one
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces raleigh_tpu/ops/spmm_window.py::build_dia_window_ring_ext, the
// per-shard Pallas kernel of the mesh-partitioned DIA SpMM.  The reference
// launches it once per shard on an operand that XLA has concatenated from
// the shard's lanes and its neighbours' edge lanes.  Here one launch covers
// every shard that lives on one device, and reads the lanes where they lie.
//
// Shard s owns n_s lanes of the vector dimension and its own diagonal values
// val_s f32 (noff, n_s).  Its operand is the shard-relative range
// [-lo, n_s + hi) of lanes, where relative lane p is global lane
// (start_s + p) mod n: the ring of shards wraps.  That range is cut into
// pieces, each a run of lanes that lie side by side in one source tensor:
// the shard's own part, a neighbour's part, or a staging copy of lanes that
// lie on another device.  A piece is (start, shift, source): relative lanes
// from `start` up to the next piece's start read source lane p + shift.  The
// kernel computes
//
//     y_s[r, i] = sum_k val_s[k, i] * X_s[r, i + off_k],   i < n_s,
//
// with X_s the operand the pieces describe, x and y f32 or bf16.  There is
// no range check: a term outside the global matrix meets a zero value and a
// finite wrapped lane, so it adds 0 and the sum is the one csrc/dia_spmm.cu
// gives (bit for bit: same products, same order, same rounding).
//
// The f64 instantiations (dia_spmm_mesh_f64_val32 / _val64 and the
// one-piece dia_spmm_rows_ext_f64_val32 / _val64) serve the core Solver's
// f64 blocks on a mesh: x and y f64, val_s f32 (the Chebyshev's canonical
// values) or f64 (A's exact values), each value widened to f64 on load
// (exactly), every product and sum rounded in f64 (__dmul_rn, __dadd_rn)
// in diagonal order from 0.  That is the order of the plain version, which
// promotes val to f64, so the two are equal bit for bit.  The thread layout
// and the piece look-up are the f32 kernel's: a simple widening, no
// redesign (8 f64 accumulators a thread).
//
// The piece table, the shards and their sources travel by value as one
// __grid_constant__ parameter block (Params, under the 4 KB parameter
// limit): no upload, no extra launch.  The one-piece case, a single shard
// over a pre-extended operand [halo_lo | n | halo_hi], is the entry point
// dia_spmm_rows_ext_*.
//
// What bounds it: memory, as csrc/dia_spmm.cu (the whole matrix moves
// noff*n*4 + 2*m*n*b bytes, plus the halo lanes each shard reads again).
// What the design does about it:
//   * K1's arithmetic and thread layout: threads along the lanes, kRows f32
//     accumulators per thread, products and sums rounded separately
//     (__fmul_rn, __fadd_rn) in the order of the diagonals, 64-bit indices.
//   * One grid for all shards of a device: blocks enumerate (shard, row
//     group of kRows, lane tile of kThreads) from a per-shard prefix of block
//     counts, so eight shards of lap3d(100,100,128) are one grid of 10,000
//     blocks, K1's shape, instead of eight grids that each leave a second,
//     nearly empty wave on the card's resident slots.
//   * Pieces are looked up only near a shard's edges.  Source i of a launch
//     is the operand part of its shard i, which holds the shard's own lanes
//     [0, n_s).  Per diagonal, a block whose source lanes all lie there
//     (one block-uniform test, K1's range check moved from the lane to the
//     block) reads that part as K1 reads x, with no compare per lane and no
//     look-up; only blocks within the reach of a shard's edges (13% of them
//     for the +-10,000-lane diagonals of lap3d(100,100,128) on 8 shards)
//     let each thread scan the shard's few pieces in the table.
// The kernel allocates nothing and does not synchronise.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kMaxShards = 16;
constexpr int kMaxSources = 32;
constexpr int kMaxPieces = 96;

// Every field is 64 bits wide, pointers included, so that the host fills
// the block as an array of int64 (ops/spmm_window.py, _MESH_* constants).
struct Shard {
    int64_t val;          // const float* (noff, n), contiguous
    int64_t n;            // the shard's lanes
    int64_t col0;         // lanes of the launch's earlier shards: y offset
    int64_t block_begin;  // set by the entry point
    int64_t piece_begin;  // its pieces: [piece_begin, piece_end)
    int64_t piece_end;
    int64_t own_shift;    // source lane of its own lane 0 in sources[s]
};

struct Source {
    int64_t base;         // const T*, unit stride along the lanes
    int64_t stride;       // elements between two rows
};

struct Piece {
    int64_t start;        // first shard-relative lane
    int64_t shift;        // source lane = relative lane + shift
    int64_t source;       // index into Params::sources
};

struct Params {
    int64_t m;            // operand rows
    int64_t noff;
    int64_t offsets;      // const int* (noff,) on the device
    int64_t y;            // T*: the shards' (m, n_s) outputs back to back
    int64_t nshards;
    int64_t groups;       // set by the entry point
    int64_t blocks;       // set by the entry point
    int64_t reserved;
    Shard shards[kMaxShards];
    Source sources[kMaxSources];
    Piece pieces[kMaxPieces];
};

static_assert(sizeof(Params) == 8 * (8 + 7 * kMaxShards + 2 * kMaxSources
                                     + 3 * kMaxPieces),
              "Params must be an array of int64 slots");
static_assert(sizeof(Params) <= 4096, "Params exceeds the parameter limit");

// the accumulator type of an operand type: f32 for f32 and bf16, f64 for
// f64
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// a value or an operand element in the accumulator type (exact)
__device__ __forceinline__ float as_acc(float v, float) { return v; }
__device__ __forceinline__ float as_acc(__nv_bfloat16 v, float) {
    return __bfloat162float(v);
}
__device__ __forceinline__ double as_acc(float v, double) {
    return static_cast<double>(v);
}
__device__ __forceinline__ double as_acc(double v, double) { return v; }

// products and sums rounded separately, never fused
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// T: the operand's type; V: the values' (f32, or f64 with an f64 operand)
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
dia_mesh_kernel(const __grid_constant__ Params p) {
    using A = typename AccOf<T>::type;
    // the launch's shard that owns block b: the last whose blocks begin at
    // or before it
    const int64_t b = blockIdx.x;
    int s = 0;
    int hi = static_cast<int>(p.nshards) - 1;
    while (s < hi) {
        const int mid = (s + hi + 1) >> 1;
        if (p.shards[mid].block_begin <= b) {
            s = mid;
        } else {
            hi = mid - 1;
        }
    }
    const Shard sh = p.shards[s];
    const Source own = p.sources[s];
    const int64_t n = sh.n;
    const int64_t local = b - sh.block_begin;
    const int64_t r0 = (local % p.groups) * kRows;
    const int64_t tile0 = (local / p.groups) * kThreads;
    const int64_t i = tile0 + threadIdx.x;
    if (i >= n) return;
    const int64_t last = (tile0 + kThreads < n ? tile0 + kThreads : n) - 1;
    const int64_t left = p.m - r0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;
    const V* val = reinterpret_cast<const V*>(sh.val);
    const int* offsets = reinterpret_cast<const int*>(p.offsets);
    const T* xown = reinterpret_cast<const T*>(own.base) + r0 * own.stride
        + sh.own_shift + i;

    A acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = A(0);

    for (int64_t k = 0; k < p.noff; ++k) {
        const int64_t off = static_cast<int64_t>(offsets[k]);
        const T* xr;
        int64_t stride;
        if (tile0 + off >= 0 && last + off < n) {
            // the block's source lanes are the shard's own
            xr = xown + off;
            stride = own.stride;
        } else {
            // near the shard's edges: each thread finds its piece
            int j = static_cast<int>(sh.piece_begin);
            while (j + 1 < sh.piece_end && p.pieces[j + 1].start <= i + off) {
                ++j;
            }
            const Source src = p.sources[p.pieces[j].source];
            xr = reinterpret_cast<const T*>(src.base) + r0 * src.stride
                + p.pieces[j].shift + i + off;
            stride = src.stride;
        }
        const A v = as_acc(val[k * n + i], A(0));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
                acc[r] = add_rn(acc[r],
                                mul_rn(v, as_acc(xr[r * stride], A(0))));
            }
        }
    }

    T* yr = reinterpret_cast<T*>(p.y) + p.m * sh.col0 + r0 * n + i;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (r < rows) store(yr + r * n, acc[r]);
    }
}

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return err;
    return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Checks the table, fills in the block prefix and launches.
template <typename T, typename V>
int launch(Params& p, int device, void* stream) {
    if (p.m <= 0) return 0;
    if (p.nshards < 1 || p.nshards > kMaxShards || p.noff < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    p.groups = (p.m + kRows - 1) / kRows;
    int64_t blocks = 0;
    for (int64_t s = 0; s < p.nshards; ++s) {
        Shard& sh = p.shards[s];
        if (sh.n <= 0 || sh.piece_begin < 0 || sh.piece_end > kMaxPieces
            || sh.piece_begin >= sh.piece_end) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        for (int64_t j = sh.piece_begin; j < sh.piece_end; ++j) {
            if (p.pieces[j].source < 0 || p.pieces[j].source >= kMaxSources) {
                return static_cast<int>(cudaErrorInvalidValue);
            }
        }
        sh.block_begin = blocks;
        blocks += p.groups * ((sh.n + kThreads - 1) / kThreads);
        if (blocks > 0x7fffffffLL) {
            return static_cast<int>(cudaErrorInvalidConfiguration);
        }
    }
    p.blocks = blocks;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    dia_mesh_kernel<T, V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

int64_t as_slot(const void* ptr) {
    return static_cast<int64_t>(reinterpret_cast<uintptr_t>(ptr));
}

// One shard over a pre-extended operand x_ext (m, halo_lo + n + halo_hi)
// with row stride x_stride: one piece from relative lane -halo_lo.
Params one_piece(const void* val, const void* x, void* y,
                 const void* offsets, int64_t noff, int64_t m, int64_t n,
                 int64_t x_stride, int64_t halo_lo) {
    Params p;
    std::memset(&p, 0, sizeof(p));
    p.m = m;
    p.noff = noff;
    p.offsets = as_slot(offsets);
    p.y = as_slot(y);
    p.nshards = 1;
    p.shards[0].val = as_slot(val);
    p.shards[0].n = n;
    p.shards[0].piece_end = 1;
    p.shards[0].own_shift = halo_lo;
    p.sources[0].base = as_slot(x);
    p.sources[0].stride = x_stride;
    p.pieces[0].start = -halo_lo;
    p.pieces[0].shift = halo_lo;
    return p;
}

template <typename T, typename V>
int launch_table(const void* params, int64_t nbytes, int device,
                 void* stream) {
    if (nbytes != static_cast<int64_t>(sizeof(Params))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p;
    std::memcpy(&p, params, sizeof(Params));
    return launch<T, V>(p, device, stream);
}

template <typename T, typename V>
int launch_one_piece(const void* val, const void* x, void* y,
                     const void* offsets, int64_t noff, int64_t m, int64_t n,
                     int64_t x_stride, int64_t halo_lo, int device,
                     void* stream) {
    if (n <= 0) return 0;
    Params p = one_piece(val, x, y, offsets, noff, m, n, x_stride, halo_lo);
    return launch<T, V>(p, device, stream);
}

}  // namespace

// params: a host block of sizeof(Params) bytes laid out as Params; the
// entry point copies it and fills in the block prefix.
extern "C" int dia_spmm_mesh_f32(const void* params, int64_t nbytes,
                                 int device, void* stream) {
    return launch_table<float, float>(params, nbytes, device, stream);
}

extern "C" int dia_spmm_mesh_bf16(const void* params, int64_t nbytes,
                                  int device, void* stream) {
    return launch_table<__nv_bfloat16, float>(params, nbytes, device,
                                              stream);
}

// the f64 instantiation: f64 operand, f32 or f64 values
extern "C" int dia_spmm_mesh_f64_val32(const void* params, int64_t nbytes,
                                       int device, void* stream) {
    return launch_table<double, float>(params, nbytes, device, stream);
}

extern "C" int dia_spmm_mesh_f64_val64(const void* params, int64_t nbytes,
                                       int device, void* stream) {
    return launch_table<double, double>(params, nbytes, device, stream);
}

// x_stride: elements between two rows of x_ext.
extern "C" int dia_spmm_rows_ext_f32(const void* val, const void* x, void* y,
                                     const void* offsets, int64_t noff,
                                     int64_t m, int64_t n, int64_t x_stride,
                                     int64_t halo_lo, int device,
                                     void* stream) {
    return launch_one_piece<float, float>(val, x, y, offsets, noff, m, n,
                                          x_stride, halo_lo, device, stream);
}

extern "C" int dia_spmm_rows_ext_bf16(const void* val, const void* x, void* y,
                                      const void* offsets, int64_t noff,
                                      int64_t m, int64_t n, int64_t x_stride,
                                      int64_t halo_lo, int device,
                                      void* stream) {
    return launch_one_piece<__nv_bfloat16, float>(
        val, x, y, offsets, noff, m, n, x_stride, halo_lo, device, stream);
}

extern "C" int dia_spmm_rows_ext_f64_val32(
        const void* val, const void* x, void* y, const void* offsets,
        int64_t noff, int64_t m, int64_t n, int64_t x_stride,
        int64_t halo_lo, int device, void* stream) {
    return launch_one_piece<double, float>(val, x, y, offsets, noff, m, n,
                                           x_stride, halo_lo, device, stream);
}

extern "C" int dia_spmm_rows_ext_f64_val64(
        const void* val, const void* x, void* y, const void* offsets,
        int64_t noff, int64_t m, int64_t n, int64_t x_stride,
        int64_t halo_lo, int device, void* stream) {
    return launch_one_piece<double, double>(val, x, y, offsets, noff, m, n,
                                            x_stride, halo_lo, device,
                                            stream);
}
