// Strided 2-D copy dst[r, :] = src[r, :] with no arithmetic, for NVIDIA
// Hopper (sm_90a).
//
// Replaces benches/bench_grid_shapes.py::build_hbm2hbm, the Pallas kernel
// that copies an (m, n) array in (m, tile) column tiles from device memory
// to device memory with four DMAs in flight and no on-chip buffer.  In the
// port it is also the copy every halo exchange rides on: the edge lanes of
// a neighbouring shard, and the shard's own lanes, into the slots of an
// extended operand [left halo | local lanes | right halo].
//
// dst and src are (rows, width) views with unit stride along the lanes and
// any row stride, given in bytes: the kernel moves bytes and knows no
// element type beyond the unit it loads.
//
// What bounds it: memory, and for a halo-sized copy the launch itself.
// What the design does about it:
//   * Hopper has no device-to-device DMA that a kernel can issue without
//     passing an SM, so "four copies in flight" becomes "enough bytes in
//     flight per SM": every thread issues kUnroll independent loads before
//     its first store, neighbouring threads on neighbouring addresses, and
//     the data passes through registers only (no shared memory).
//   * 16-byte loads and stores where both base pointers, both row strides,
//     the width and the tile allow; else one element (8, 4, 2 or 1 bytes)
//     per access.  A halo cut at an arbitrary lane is not 16-byte aligned,
//     so both paths carry real traffic.
//   * One launch covers the whole array: grid.y walks the rows, grid.x the
//     column tiles, each tile cut into blocks of kThreads * kUnroll units.
//     The tile only shapes the walk (copy_lanes passes the whole width as
//     one tile; hbm2hbm passes the sweep's tile): a launch per tile would
//     put a launch gap between tiles that the stream runs in order.
// The kernel allocates nothing and does not synchronise.  The entry point
// returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kMaxGridX = 0x7fffffffLL;

// Block (bx, by): rows by, by + gridDim.y, ...; of each row the tiles
// bx / per_tile, bx / per_tile + gridDim.x / per_tile, ...; of each tile the
// kThreads * kUnroll units starting at (bx % per_tile) * kThreads * kUnroll.
// Sizes and strides: width, tile in units of V; strides in bytes.
template <typename V>
__global__ void __launch_bounds__(kThreads)
copy_kernel(char* __restrict__ dst, const char* __restrict__ src,
            int64_t rows, int64_t width, int64_t tile, int64_t per_tile,
            int64_t dst_stride, int64_t src_stride) {
    const int64_t ntiles = (width + tile - 1) / tile;
    const int64_t part = blockIdx.x % per_tile;
    const int64_t tile_step = gridDim.x / per_tile;
    for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
        const V* s = reinterpret_cast<const V*>(src + r * src_stride);
        V* d = reinterpret_cast<V*>(dst + r * dst_stride);
        for (int64_t t = blockIdx.x / per_tile; t < ntiles; t += tile_step) {
            const int64_t base = t * tile;
            const int64_t end = base + tile < width ? base + tile : width;
            const int64_t i0 = base + part * (kThreads * kUnroll)
                + threadIdx.x;
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
    }
}

template <typename V>
cudaError_t launch(char* dst, const char* src, int64_t rows,
                   int64_t width_bytes, int64_t tile_bytes,
                   int64_t dst_stride, int64_t src_stride,
                   cudaStream_t stream) {
    const int64_t unit = static_cast<int64_t>(sizeof(V));
    const int64_t width = width_bytes / unit;
    const int64_t tile = tile_bytes / unit;
    const int64_t per_tile = (tile + kThreads * kUnroll - 1)
        / (kThreads * kUnroll);
    int64_t ntiles = (width + tile - 1) / tile;
    if (ntiles > kMaxGridX / per_tile) ntiles = kMaxGridX / per_tile;
    if (ntiles < 1) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned int>(ntiles * per_tile),
                    static_cast<unsigned int>(rows < kMaxGridY ? rows
                                              : kMaxGridY));
    copy_kernel<V><<<grid, kThreads, 0, stream>>>(
        dst, src, rows, width, tile, per_tile, dst_stride, src_stride);
    return cudaGetLastError();
}

bool multiple_of_16(int64_t v) { return v % 16 == 0; }

}  // namespace

// dst[r, :width_bytes] = src[r, :width_bytes] for r < rows, walked in
// column tiles of tile_bytes.  elem_size (1, 2, 4 or 8) is the unit of the
// narrow path: every pointer, stride, width and tile is a multiple of it.
extern "C" int copy_lanes(void* dst, const void* src, int64_t rows,
                          int64_t width_bytes, int64_t tile_bytes,
                          int64_t dst_stride, int64_t src_stride,
                          int elem_size, int device, void* stream) {
    if (rows <= 0 || width_bytes <= 0) return 0;
    if (tile_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    char* d = static_cast<char*>(dst);
    const char* c = static_cast<const char*>(src);
    const bool wide =
        multiple_of_16(static_cast<int64_t>(reinterpret_cast<uintptr_t>(dst)))
        && multiple_of_16(
            static_cast<int64_t>(reinterpret_cast<uintptr_t>(src)))
        && multiple_of_16(width_bytes) && multiple_of_16(tile_bytes)
        && (rows == 1
            || (multiple_of_16(dst_stride) && multiple_of_16(src_stride)));
    if (wide) {
        return static_cast<int>(launch<uint4>(
            d, c, rows, width_bytes, tile_bytes, dst_stride, src_stride, s));
    }
    switch (elem_size) {
    case 8:
        return static_cast<int>(launch<uint64_t>(
            d, c, rows, width_bytes, tile_bytes, dst_stride, src_stride, s));
    case 4:
        return static_cast<int>(launch<uint32_t>(
            d, c, rows, width_bytes, tile_bytes, dst_stride, src_stride, s));
    case 2:
        return static_cast<int>(launch<uint16_t>(
            d, c, rows, width_bytes, tile_bytes, dst_stride, src_stride, s));
    case 1:
        return static_cast<int>(launch<uint8_t>(
            d, c, rows, width_bytes, tile_bytes, dst_stride, src_stride, s));
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}
