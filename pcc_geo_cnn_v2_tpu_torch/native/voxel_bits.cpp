// Packed occupancy-mask bit unpack -> voxel coordinate lists (copy of
// pcc_geo_cnn_v2_tpu/native/voxel_bits.cpp).
//
// The codec's device passes return per-block occupancy as 1-bit masks
// (block_size^3 / 8 bytes, bitorder "big": byte b bit 7 is flat voxel
// b*8). Blocks denser than the compact position budget decode their
// coordinates on the host from these rows; the numpy route
// (np.unpackbits -> np.nonzero -> div/mod arithmetic) materialises an
// 8x-inflated bit array and three index arrays and measured 1.6-5.6 s
// per cloud on the single-core bench host. This single pass emits
// float32 coords straight from the bytes (~50 ms for the same work).
//
// Replaces host-side work the reference does with np.argwhere over
// dense volumes (reference decompress_octree.py x_hat thresholding).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (see ops/bitunpack.py).

#include <cstdint>

extern "C" {

// Total set bits over the whole buffer.
int64_t pcc_popcount(const uint8_t* rows, int64_t nbytes) {
    int64_t total = 0;
    int64_t i = 0;
    for (; i + 8 <= nbytes; i += 8) {
        uint64_t w;
        __builtin_memcpy(&w, rows + i, 8);
        total += __builtin_popcountll(w);
    }
    for (; i < nbytes; ++i) total += __builtin_popcount(rows[i]);
    return total;
}

// rows: [n, fbytes] packed masks. out: [cap, 3] float32. counts: [n].
// Returns total points written, or -1 if cap would overflow (nothing
// is written past cap).
int64_t pcc_unpack_mask_coords(const uint8_t* rows, int64_t n,
                               int64_t fbytes, int32_t bsz, float* out,
                               int64_t cap, int64_t* counts) {
    const int64_t plane = (int64_t)bsz * bsz;
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = rows + i * fbytes;
        int64_t cnt = 0;
        for (int64_t b = 0; b < fbytes; ++b) {
            uint8_t v = row[b];
            if (!v) continue;
            const int64_t f0 = b * 8;
            while (v) {
                // bitorder "big": bit 7 (0x80) is flat offset f0 + 0
                const int j = __builtin_clz((uint32_t)v << 24);
                const int64_t f = f0 + j;
                if (total + cnt >= cap) return -1;
                float* o = out + (total + cnt) * 3;
                o[0] = (float)(f / plane);
                o[1] = (float)((f / bsz) % bsz);
                o[2] = (float)(f % bsz);
                ++cnt;
                v = (uint8_t)(v & ~(0x80u >> j));
            }
        }
        counts[i] = cnt;
        total += cnt;
    }
    return total;
}

}  // extern "C"
