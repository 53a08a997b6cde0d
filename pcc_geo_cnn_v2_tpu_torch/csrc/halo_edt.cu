// K2: bounded halo EDT with the encoder-side full-cloud D1 partial sums.
//
// Replaces the Pallas TPU kernel `_halo_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_halo.py:43, launched by
// `halo_d1_dir_pallas`). Per block b of a batch: the squared Euclidean
// distance transform of the target occupancy over the block's
// 27-neighbourhood halo volume (H = size + 2 halo per axis), evaluated at
// the block's query voxels (a size^3 core grid), then
//
//   sum[b]       = sum of dt over core query voxels with dt <= halo^2
//   n[b]         = number of core query voxels
//   unres_cnt[b] = number of core query voxels with dt > halo^2
//   unres[b]     = those voxels as packed bits (big bit order, core flat)
//
// Every pass is bounded by the per-block shift bound kmax[b] (coarse-grid
// bound, computed by the wrapper): distances <= halo are then exact and
// larger ones can only be overestimated, i.e. flagged — the semantics of
// the TPU kernel, whose sums/counts/masks this kernel reproduces exactly.
//
// Design (a first, simple, exact kernel): a 88^3 halo volume does not fit
// a CTA's shared memory, so the separable EDT is split in two launches.
//  1. z pass: one thread per (b, y, x) column scans the target column
//     forward and backward and stores, for the `size` core z planes only,
//     the 1-D distance to the nearest target (255 = none within kmax) as
//     uint8 into a [bs, size, H, H] scratch the wrapper allocates.
//  2. plane pass: one CTA per (core z plane, block) stages the plane's
//     column distances in shared memory, runs the y min-plus pass over
//     the core rows into shared memory, then the x min-plus pass only at
//     the plane's core query voxels, and reduces sum / n / unres_cnt with
//     warp reductions and one atomic per warp; each thread writes whole
//     bytes of the packed outlier mask.
// Integer arithmetic throughout (d2 <= 3 halo^2, INF = 2^24): exact sums.
//
// Bound: the target halo volume and the query core are read once
// (~60 MB of int8 at bs = 64, H = 88, size = 64); the min-plus work is
// ~bs * size^2 * H * (2 kmax + 1) integer min/add pairs for the y pass plus
// the sparse x pass. Whether bytes or operations bound it depends on kmax.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NONE = 255;        // no target within kmax along the column
constexpr int INF_I = 1 << 24;   // squared distance of NONE
constexpr int ZPASS_THREADS = 256;
constexpr int PLANE_THREADS = 256;

__device__ __forceinline__ int sq(int d) { return d == NONE ? INF_I : d * d; }

__global__ void halo_zpass_kernel(const uint8_t* __restrict__ tgt,
                                  const int32_t* __restrict__ kmax,
                                  uint8_t* __restrict__ dz,
                                  int bs, int H, int size, int halo) {
    const int64_t plane = (int64_t)H * H;
    const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= bs * plane) return;
    const int b = (int)(col / plane);
    const int64_t yx = col % plane;
    const uint8_t* t = tgt + (int64_t)b * H * plane + yx;
    uint8_t* out = dz + (int64_t)b * size * plane + yx;
    const int km = kmax[b];
    int last = -(1 << 20);
    for (int z = 0; z < halo + size; ++z) {
        if (t[z * plane]) last = z;
        if (z >= halo) {
            const int d = z - last;
            out[(z - halo) * plane] = (uint8_t)(d <= km ? d : NONE);
        }
    }
    int next = 1 << 20;
    for (int z = H - 1; z >= halo; --z) {
        if (t[z * plane]) next = z;
        if (z < halo + size) {
            const int d = next - z;
            uint8_t* o = out + (z - halo) * plane;
            if (d <= km && d < *o) *o = (uint8_t)d;
        }
    }
}

__global__ void __launch_bounds__(PLANE_THREADS)
halo_plane_kernel(const uint8_t* __restrict__ dz,
                  const uint8_t* __restrict__ qry,
                  const int32_t* __restrict__ kmax,
                  unsigned long long* __restrict__ sum,
                  int32_t* __restrict__ n_out,
                  int32_t* __restrict__ unres_cnt,
                  uint8_t* __restrict__ unres,
                  int H, int size, int halo) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int zc = blockIdx.x, b = blockIdx.y;
    const int HH = H * H;
    uint8_t* d = smem;                                       // [H][H]
    int* gy = reinterpret_cast<int*>(smem + ((HH + 15) & ~15));  // [size][H]
    const int km = kmax[b];
    const uint8_t* src = dz + ((int64_t)b * size + zc) * HH;
    for (int i = threadIdx.x; i < HH; i += PLANE_THREADS) d[i] = src[i];
    __syncthreads();

    // y pass over the core rows, all columns
    for (int i = threadIdx.x; i < size * H; i += PLANE_THREADS) {
        const int y = i / H + halo, x = i % H;
        int best = sq(d[y * H + x]);
        for (int k = 1; k <= km; ++k) {
            const int k2 = k * k;
            if (y + k < H) best = min(best, sq(d[(y + k) * H + x]) + k2);
            if (y - k >= 0) best = min(best, sq(d[(y - k) * H + x]) + k2);
        }
        gy[i] = best;
    }
    __syncthreads();

    // x pass at core query voxels; one packed output byte per item
    const int cap = halo * halo;
    const int row_bytes = size / 8;
    const uint8_t* qplane = qry + ((int64_t)b * size + zc) * size * size;
    uint8_t* ub = unres + (int64_t)b * size * size * row_bytes
                  + (int64_t)zc * size * row_bytes;
    unsigned long long s = 0;
    int cn = 0, cu = 0;
    for (int i = threadIdx.x; i < size * row_bytes; i += PLANE_THREADS) {
        const int yc = i / row_bytes, j = i % row_bytes;
        const uint8_t* qrow = qplane + yc * size + 8 * j;
        const int* row = gy + yc * H;
        uint8_t bits = 0;
        for (int u = 0; u < 8; ++u) {
            if (!qrow[u]) continue;
            const int x = halo + 8 * j + u;
            int best = row[x];
            for (int k = 1; k <= km; ++k) {
                const int k2 = k * k;
                if (x + k < H) best = min(best, row[x + k] + k2);
                if (x - k >= 0) best = min(best, row[x - k] + k2);
            }
            ++cn;
            if (best <= cap) {
                s += (unsigned long long)best;
            } else {
                ++cu;
                bits |= (uint8_t)(0x80u >> u);
            }
        }
        ub[i] = bits;
    }
    // warp reductions, one atomic per warp and output
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    cn = __reduce_add_sync(0xffffffffu, cn);
    cu = __reduce_add_sync(0xffffffffu, cu);
    if ((threadIdx.x & 31) == 0) {
        if (s) atomicAdd(sum + b, s);
        if (cn) atomicAdd(n_out + b, cn);
        if (cu) atomicAdd(unres_cnt + b, cu);
    }
}

}  // namespace

extern "C" {

// qry [bs, size, size, size] / tgt [bs, H, H, H] uint8 occupancy;
// kmax [bs] int32 (<= halo);
// scratch [bs, size, H, H] uint8; sum [bs] int64, n/unres_cnt [bs] int32
// (all three zeroed by the caller); unres [bs, size^3 / 8] uint8.
// Returns cudaGetLastError.
int pcc_halo_edt(const uint8_t* qry, const uint8_t* tgt, const int32_t* kmax,
                 uint8_t* scratch, int64_t* sum, int32_t* n_out,
                 int32_t* unres_cnt, uint8_t* unres, int bs, int H, int size,
                 int halo, void* stream) {
    if (bs <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t cols = (int64_t)bs * H * H;
    halo_zpass_kernel<<<(unsigned)((cols + ZPASS_THREADS - 1) / ZPASS_THREADS),
                        ZPASS_THREADS, 0, st>>>(tgt, kmax, scratch, bs, H,
                                                size, halo);
    const size_t smem = ((H * H + 15) & ~15) + (size_t)size * H * sizeof(int);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(halo_plane_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    }
    halo_plane_kernel<<<dim3(size, bs), PLANE_THREADS, smem, st>>>(
        scratch, qry, kmax, reinterpret_cast<unsigned long long*>(sum),
        n_out, unres_cnt, unres, H, size, halo);
    return (int)cudaGetLastError();
}

}  // extern "C"
