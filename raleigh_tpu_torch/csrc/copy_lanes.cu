// Batched strided 2-D copies dst[r, :] = src[r, :] with no arithmetic, all
// of one device's copies in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces benches/bench_grid_shapes.py::build_hbm2hbm, the Pallas kernel
// that copies an (m, n) array in (m, tile) column tiles from device memory
// to device memory with four DMAs in flight and no on-chip buffer.  In the
// port it is also the copy that assembles extended operands where bytes
// really have to move: the halo rows of a row-partitioned ELL product
// (parallel/spmm_sharded.py), a shard's neighbours' edge lanes and its own
// lanes side by side.  The mesh-partitioned DIA apply needs none of it: it
// reads its halos in place (csrc/dia_spmm_ext.cu).
//
// Each copy is a pair of (rows, width) views with unit stride along the
// lanes and any row stride, given in bytes: the kernel moves bytes and knows
// no element type beyond the unit it loads.  Up to kMaxCopies copies travel
// by value as one __grid_constant__ parameter block (Params, under the 4 KB
// parameter limit): no upload, no extra launch.
//
// What bounds it: memory, and for halo-sized copies the launch itself.
// What the design does about it:
//   * One launch for a list of copies: a halo assembly of 8 shards is 24
//     copies and one launch, not 24.  Blocks are assigned to copies by a
//     prefix of each copy's rows x tiles x chunks, so a block serves one
//     copy, and the access width is chosen per copy (16 bytes where both
//     base pointers, both row strides, the width and the tile allow, else
//     one element of 8, 4, 2 or 1 bytes) with no divergence inside a block.
//   * Hopper has no device-to-device DMA that a kernel can issue without
//     passing an SM, so "four copies in flight" becomes "enough bytes in
//     flight per SM": every thread issues kUnroll independent loads before
//     its first store, neighbouring threads on neighbouring addresses, and
//     the data passes through registers only (no shared memory).
//   * The tile only shapes the walk (a copy of whole rows passes the width
//     as one tile; the sweep's hbm2hbm passes its tile): a launch per tile
//     would put a launch gap between tiles that the stream runs in order.
// The kernel allocates nothing and does not synchronise.  The entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxCopies = 56;
constexpr int64_t kChunk = kThreads * kUnroll;
constexpr int64_t kMaxGrid = 0x7fffffffLL;

// Every field is 64 bits wide, pointers included, so that the host fills
// the block as an array of int64 (ops/stream.py, _COPY_* constants).
struct Copy {
    int64_t dst;          // char*
    int64_t src;          // const char*
    int64_t rows;
    int64_t width;        // bytes from the host; units after prepare()
    int64_t tile;         // bytes from the host; units after prepare()
    int64_t dst_stride;   // bytes between two rows
    int64_t src_stride;
    int64_t unit;         // element size from the host; access width after
    int64_t block_begin;  // set by the entry point
};

struct Params {
    int64_t ncopies;
    int64_t blocks;       // set by the entry point
    Copy copies[kMaxCopies];
};

static_assert(sizeof(Params) == 8 * (2 + 9 * kMaxCopies),
              "Params must be an array of int64 slots");
static_assert(sizeof(Params) <= 4096, "Params exceeds the parameter limit");

// Block-local index `local` of copy c: row, tile and chunk of the tile;
// the chunk's kThreads * kUnroll units.
template <typename V>
__device__ __forceinline__ void copy_block(const Copy& c, int64_t local) {
    const int64_t per_tile = (c.tile + kChunk - 1) / kChunk;
    const int64_t ntiles = (c.width + c.tile - 1) / c.tile;
    const int64_t part = local % per_tile;
    const int64_t t = (local / per_tile) % ntiles;
    const int64_t r = local / (per_tile * ntiles);
    const V* s = reinterpret_cast<const V*>(
        reinterpret_cast<const char*>(c.src) + r * c.src_stride);
    V* d = reinterpret_cast<V*>(reinterpret_cast<char*>(c.dst)
                                + r * c.dst_stride);
    const int64_t base = t * c.tile;
    const int64_t end = base + c.tile < c.width ? base + c.tile : c.width;
    const int64_t i0 = base + part * kChunk + threadIdx.x;
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = i0 + k * kThreads;
        if (i < end) v[k] = s[i];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = i0 + k * kThreads;
        if (i < end) d[i] = v[k];
    }
}

__global__ void __launch_bounds__(kThreads)
copy_many_kernel(const __grid_constant__ Params p) {
    for (int64_t b = blockIdx.x; b < p.blocks; b += gridDim.x) {
        // the last copy whose blocks begin at or before b
        int lo = 0;
        int hi = static_cast<int>(p.ncopies) - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (p.copies[mid].block_begin <= b) {
                lo = mid;
            } else {
                hi = mid - 1;
            }
        }
        const Copy c = p.copies[lo];
        const int64_t local = b - c.block_begin;
        switch (c.unit) {
        case 16: copy_block<uint4>(c, local); break;
        case 8: copy_block<uint64_t>(c, local); break;
        case 4: copy_block<uint32_t>(c, local); break;
        case 2: copy_block<uint16_t>(c, local); break;
        default: copy_block<uint8_t>(c, local); break;
        }
    }
}

bool multiple_of_16(int64_t v) { return v % 16 == 0; }

// Picks the access width of copy c and turns its sizes into units; returns
// its number of blocks, or -1 for a copy the kernel cannot take.
int64_t prepare(Copy& c) {
    const int64_t elem = c.unit;
    if (c.rows <= 0 || c.width <= 0 || c.tile <= 0
        || !(elem == 1 || elem == 2 || elem == 4 || elem == 8)
        || c.width % elem || c.tile % elem) {
        return -1;
    }
    const bool wide = multiple_of_16(c.dst) && multiple_of_16(c.src)
        && multiple_of_16(c.width) && multiple_of_16(c.tile)
        && (c.rows == 1
            || (multiple_of_16(c.dst_stride) && multiple_of_16(c.src_stride)));
    c.unit = wide ? 16 : elem;
    c.width /= c.unit;
    c.tile /= c.unit;
    const int64_t per_tile = (c.tile + kChunk - 1) / kChunk;
    const int64_t ntiles = (c.width + c.tile - 1) / c.tile;
    if (ntiles > kMaxGrid / per_tile
        || c.rows > kMaxGrid / (ntiles * per_tile)) {
        return -1;
    }
    return c.rows * ntiles * per_tile;
}

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return err;
    return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// params: a host block of sizeof(Params) bytes laid out as Params, with
// ncopies copies (rows, width, tile and strides in bytes; unit the element
// size 1, 2, 4 or 8, of which every pointer, stride, width and tile is a
// multiple).  The entry point copies it, picks each copy's access width and
// fills in the block prefix.
extern "C" int copy_lanes_many(const void* params, int64_t nbytes, int device,
                               void* stream) {
    if (nbytes != static_cast<int64_t>(sizeof(Params))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p;
    std::memcpy(&p, params, sizeof(Params));
    if (p.ncopies < 1 || p.ncopies > kMaxCopies) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int64_t blocks = 0;
    for (int64_t i = 0; i < p.ncopies; ++i) {
        const int64_t own = prepare(p.copies[i]);
        if (own < 0 || blocks > INT64_MAX - own) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        p.copies[i].block_begin = blocks;
        blocks += own;
    }
    p.blocks = blocks;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t grid = blocks < kMaxGrid ? blocks : kMaxGrid;
    copy_many_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
