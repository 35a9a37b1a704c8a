// Native host-side tile builder: this framework's analog of the
// reference's IndexGridBuilder (/root/reference/src/Utils/GridBuilder.hpp:21-250)
// — encode sparse voxel data (coordinate list + per-field values) into the
// dense-per-tile SoA layout the device kernels consume, and decode back.
//
// Where the reference memcpy's OpenVDB leaf buffers per-leaf under TBB, this
// builder works from flat coordinate lists (the interchange format of our
// I/O layer) and parallelizes with OpenMP. Exposed as a C ABI for ctypes.
//
// Layout contract (must match hnanosolver_tpu/core/coords.py):
//   tile coord   t  = voxel >> 3 (arithmetic)
//   packed key      = ((tx+512)<<20) | ((ty+512)<<10) | (tz+512), int32
//   local offset    = ((x&7)*8 + (y&7))*8 + (z&7)
//   table row 0     = null tile (all zeros); active rows 1..M sorted by key.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int32_t kTileOffset = 512;
constexpr int kLeaf = 8;
constexpr int kTileVoxels = kLeaf * kLeaf * kLeaf;

inline int32_t pack_key(int32_t tx, int32_t ty, int32_t tz) {
    return ((tx + kTileOffset) << 20) | ((ty + kTileOffset) << 10) |
           (tz + kTileOffset);
}

inline int32_t floor_shift3(int32_t v) { return v >> 3; }

}  // namespace

extern "C" {

// Pass 1: count unique tiles for a coordinate list (so the caller can size
// output buffers). Returns the number of unique tiles M (>= 0), or -1 on
// out-of-range coordinates.
int64_t hns_count_tiles(const int32_t* coords, int64_t n) {
    std::vector<int32_t> keys(static_cast<size_t>(n));
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const int32_t tx = floor_shift3(coords[3 * i + 0]);
        const int32_t ty = floor_shift3(coords[3 * i + 1]);
        const int32_t tz = floor_shift3(coords[3 * i + 2]);
        keys[static_cast<size_t>(i)] = pack_key(tx, ty, tz);
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t t[3] = {floor_shift3(coords[3 * i]),
                              floor_shift3(coords[3 * i + 1]),
                              floor_shift3(coords[3 * i + 2])};
        for (int a = 0; a < 3; ++a)
            if (t[a] < -kTileOffset || t[a] >= kTileOffset) return -1;
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    return static_cast<int64_t>(keys.size());
}

// Pass 2: build the index. Outputs:
//   keys_out    [m]  sorted unique packed keys (caller sized via pass 1)
//   origins_out [m*3] tile coords
//   row_out     [n]  1-based table row of each coordinate
//   local_out   [n]  flat in-tile offset of each coordinate
// Returns 0 on success.
int32_t hns_build_index(const int32_t* coords, int64_t n, int32_t* keys_out,
                        int32_t* origins_out, int64_t m, int32_t* row_out,
                        int32_t* local_out) {
    std::vector<int32_t> keys(static_cast<size_t>(n));
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        keys[static_cast<size_t>(i)] = pack_key(floor_shift3(coords[3 * i]),
                                                floor_shift3(coords[3 * i + 1]),
                                                floor_shift3(coords[3 * i + 2]));
    }
    std::vector<int32_t> uniq(keys);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    if (static_cast<int64_t>(uniq.size()) != m) return 1;
    std::memcpy(keys_out, uniq.data(), uniq.size() * sizeof(int32_t));
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < m; ++t) {
        const int32_t k = uniq[static_cast<size_t>(t)];
        origins_out[3 * t + 0] = ((k >> 20) & 0x3FF) - kTileOffset;
        origins_out[3 * t + 1] = ((k >> 10) & 0x3FF) - kTileOffset;
        origins_out[3 * t + 2] = (k & 0x3FF) - kTileOffset;
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const int32_t k = keys[static_cast<size_t>(i)];
        const auto it = std::lower_bound(uniq.begin(), uniq.end(), k);
        row_out[i] = static_cast<int32_t>(it - uniq.begin()) + 1;  // 1-based
        const int32_t lx = coords[3 * i + 0] & 7;
        const int32_t ly = coords[3 * i + 1] & 7;
        const int32_t lz = coords[3 * i + 2] & 7;
        local_out[i] = (lx * kLeaf + ly) * kLeaf + lz;
    }
    return 0;
}

// Scatter per-coordinate float values into tile layout [rows, 512] (row 0 =
// null tile; caller allocates (m+1)*512*channels floats, zero-initialized).
void hns_scatter(const int32_t* row, const int32_t* local, const float* values,
                 int64_t n, int32_t channels, float* tiles_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const int64_t base =
            (static_cast<int64_t>(row[i]) * kTileVoxels + local[i]) * channels;
        for (int32_t c = 0; c < channels; ++c)
            tiles_out[base + c] = values[i * channels + c];
    }
}

// Gather per-coordinate values back out of tile layout (decode path — the
// analog of IndexGridBuilder::writeIndexGrid, GridBuilder.hpp:169-216).
void hns_gather(const int32_t* row, const int32_t* local, const float* tiles,
                int64_t n, int32_t channels, float* values_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const int64_t base =
            (static_cast<int64_t>(row[i]) * kTileVoxels + local[i]) * channels;
        for (int32_t c = 0; c < channels; ++c)
            values_out[i * channels + c] = tiles[base + c];
    }
}

// Emit the coordinate list of every voxel of the active tiles (dense per
// leaf, like the reference's flattened coords array, GridBuilder.hpp:87-167).
void hns_tile_coords(const int32_t* origins, int64_t m, int32_t* coords_out) {
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < m; ++t) {
        const int32_t ox = origins[3 * t] * kLeaf;
        const int32_t oy = origins[3 * t + 1] * kLeaf;
        const int32_t oz = origins[3 * t + 2] * kLeaf;
        int64_t w = t * kTileVoxels * 3;
        for (int x = 0; x < kLeaf; ++x)
            for (int y = 0; y < kLeaf; ++y)
                for (int z = 0; z < kLeaf; ++z) {
                    coords_out[w++] = ox + x;
                    coords_out[w++] = oy + y;
                    coords_out[w++] = oz + z;
                }
    }
}

}  // extern "C"
