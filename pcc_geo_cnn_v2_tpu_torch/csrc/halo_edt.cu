// K2: full-cloud D1 partial sums from packed neighbour grids.
//
// Replaces the Pallas TPU kernel `_halo_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_halo.py:43, launched by
// `halo_d1_dir_pallas`), with the volume assembly around it
// (`_halo_dir_chunk_pallas`, pcc_geo_cnn_v2_tpu/ops/cloud_metrics.py:148).
// For every block i of a cloud and both directions d (0: queries are cloud
// A's voxels, targets cloud B's; 1: the reverse), with the query block's
// voxels v and the target voxels of its 27-neighbourhood:
//
//   sum[d, i]       = sum of D(v) over the query voxels with D(v) <= halo^2
//   n[d, i]         = number of query voxels
//   unres_cnt[d, i] = number of query voxels with D(v) > halo^2
//   unres[d, i]     = those voxels as packed bits (big bit order, core flat)
//
// D(v) = squared distance from v to its nearest target voxel. A ball of
// radius halo around a voxel of the block lies inside the 27-neighbourhood
// (halo <= size), so D <= halo^2 is exact; beyond it the voxel is flagged.
// This is the TPU kernel's function. Its coarse-grid bound `kmax` and its
// separable passes over an assembled [H, H, H] halo volume are cost controls
// that never change a value; this kernel carries over the function, not
// them.
//
// Inputs are the packed grids [rows, size^3 / 8] of both clouds (voxel
// (x, y, z) of a block is bit 7 - z % 8 of byte ((x size + y) size + z) / 8)
// and the neighbour table idx [n, 27] ((dx, dy, dz) row-major, the block
// itself at 13; an index outside [0, rows) is an absent neighbour).
//
// Design: two launches a call, nothing assembled in global memory.
//  1. halo_edt_kernel, one CTA of THREADS threads per (block, slab of SLAB
//     core x-planes, direction). A CTA whose query slab is empty writes its
//     zero mask rows and partials and stops. Else it builds the target's
//     bit rows in shared memory: row (x, y), for x in [x0 - halo,
//     x0 + SLAB + halo) and y in [-halo, size + halo), holds the bits z in
//     [-halo, size + halo) as one 128-bit word (bit z + halo), put together
//     from the (dx, dy) neighbour column's three z-neighbours: a byte's
//     bits reversed (`__brevll` and `__byte_perm`) turn a little-endian
//     64-bit load of a packed row into a word with voxel z at bit z, and
//     shifts place the dz = -1 / 0 / +1 parts. 40 x 88 rows x 16 B = 55 KB
//     at size 64, halo 12, plus 10.4 KB of round arrays: 2 CTAs of 512
//     threads an SM (64 registers). The queries go THREADS rows a round:
//     each thread loads one row of the query block, a block scan numbers
//     the round's voxels and thread j takes voxels j, j + THREADS, ... (a
//     thread a row held a warp as long as its fullest row: a surface along
//     z fills rows). A voxel walks the spiral table of (|dx|, |dy|) in
//     increasing dx^2 + dy^2 (ops/halo.py `halo_spiral_table`), takes each
//     row's nearest set bit by a shift and `__ffsll` / `__clzll`, and stops
//     at the first entry whose dx^2 + dy^2 is not below its best value,
//     which starts at halo^2 + 1: exact without any external bound. A slab
//     without any target bit flags its queries without a search. Flags go
//     into the round's rows by shared 32-bit `atomicOr` and are written as
//     whole mask rows in the packed byte order; sum, n and unres_cnt go
//     through warp reductions into one partial per CTA (no global atomics).
//  2. halo_edt_finish_kernel, a thread per (direction, block), adds the
//     slabs' partials.
// Integer arithmetic throughout: the sums are exact whatever the order.
//
// Bound (per call): both clouds' packed grids read once, the masks written
// once, the per-block scalars; operations, one per query voxel and the disc
// search (~pi D rows for a voxel whose result is D, capped at halo^2, 2
// operations each: 2 pi sum D). The CTAs reread the slab halo (2.5x at
// SLAB 16) from L2, where a cloud's packed grids (6.7 MB for 205 blocks of
// 64^3) stay.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
typedef unsigned __int128 u128;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLAB = 16;             // core x-planes a CTA
constexpr int MAX_SIZE = 64;         // a block row is one 64-bit word
constexpr int ROW_BITS = 128;        // a halo row: size + 2 halo bits
constexpr int FINISH_THREADS = 256;
constexpr int FAR = 1 << 10;         // no set bit along a row

// bit 7 - b of byte k -> bit 8 k + b: a little-endian load of a packed row
// becomes a word with voxel z at bit z (an involution)
__device__ __forceinline__ u64 zorder(u64 w) {
    const u64 r = __brevll(w);
    const unsigned lo = (unsigned)r, hi = (unsigned)(r >> 32);
    return ((u64)__byte_perm(lo, 0, 0x0123) << 32) | __byte_perm(hi, 0, 0x0123);
}

__device__ __forceinline__ u64 load_row(const uint8_t* __restrict__ p,
                                        int rb) {
    if (rb == 8) return __ldg(reinterpret_cast<const u64*>(p));
    u64 w = 0;
    for (int k = 0; k < rb; ++k) w |= (u64)__ldg(p + k) << (8 * k);
    return w;
}

__device__ __forceinline__ void store_row(uint8_t* __restrict__ p, int rb,
                                          u64 w) {
    if (rb == 8) {
        *reinterpret_cast<u64*>(p) = w;
        return;
    }
    for (int k = 0; k < rb; ++k) p[k] = (uint8_t)(w >> (8 * k));
}

// |dz| to the set bit of `row` nearest to bit pz (FAR if the row is empty)
__device__ __forceinline__ int nearest_dz(u128 row, int pz) {
    const u128 up = row >> pz;
    const u64 ul = (u64)up, uh = (u64)(up >> 64);
    const int du = ul ? __ffsll((long long)ul) - 1
                      : (uh ? 63 + __ffsll((long long)uh) : FAR);
    const u128 dn = row << (127 - pz);
    const u64 dl = (u64)dn, dh = (u64)(dn >> 64);
    const int dd = dh ? __clzll((long long)dh)
                      : (dl ? 64 + __clzll((long long)dl) : FAR);
    return min(du, dd);
}

// squared distance from bit pz of row c0[0] to the nearest set bit of the
// rows c0[+-dx H +- dy], searched in spiral order and stopped at the first
// entry not below the best value; cap + 1 if none is within cap
__device__ __forceinline__ int search(const u128* __restrict__ c0, int H,
                                      int pz,
                                      const int32_t* __restrict__ spiral,
                                      int n_spiral, int cap) {
    int best = cap + 1;
    for (int e = 0; e < n_spiral; ++e) {
        const int pe = __ldg(spiral + e);
        const int r2 = pe >> 14;
        if (r2 >= best) break;
        const int ex = (pe >> 7) & 127, ey = pe & 127;
        for (int sx = 0; sx < (ex ? 2 : 1); ++sx)
            for (int sy = 0; sy < (ey ? 2 : 1); ++sy) {
                const u128 row = c0[(sx ? -ex : ex) * H + (sy ? -ey : ey)];
                if (row) {
                    const int dz = nearest_dz(row, pz);
                    best = min(best, r2 + dz * dz);
                }
            }
    }
    return best;
}

__global__ void __launch_bounds__(THREADS)
halo_edt_kernel(const uint8_t* __restrict__ a_ext,
                const uint8_t* __restrict__ b_ext, int rows_ext,
                const int32_t* __restrict__ idx,
                const int32_t* __restrict__ spiral, int n_spiral,
                int64_t* __restrict__ part, uint8_t* __restrict__ unres,
                int n, int size, int halo, int slabs) {
    extern __shared__ __align__(16) unsigned char smem[];
    u128* tgt = reinterpret_cast<u128*>(smem);  // [SLAB + 2 halo][H]
    __shared__ int nb[27];
    __shared__ u64 qbits[THREADS];       // a round's query rows
    __shared__ int qoff[THREADS];        // their first voxel's number
    __shared__ unsigned qflag[THREADS][2];  // their outlier bits
    __shared__ int wsum[WARPS];
    __shared__ u64 red_s[WARPS];
    __shared__ int red_n[WARPS], red_c[WARPS];
    const int s = blockIdx.x % slabs, i = blockIdx.x / slabs, d = blockIdx.y;
    const uint8_t* qsrc = d ? b_ext : a_ext;
    const uint8_t* tsrc = d ? a_ext : b_ext;
    const int rb = size >> 3;  // bytes a packed row
    const int64_t blk = (int64_t)size * size * rb;
    const int x0 = s * SLAB, xs = min(SLAB, size - x0);
    const int H = size + 2 * halo;
    if (threadIdx.x < 27) {
        const int k = idx[(int64_t)i * 27 + threadIdx.x];
        nb[threadIdx.x] = (k >= 0 && k < rows_ext) ? k : -1;
    }
    __syncthreads();
    const int qb = nb[13];
    const uint8_t* q = qsrc + (int64_t)max(qb, 0) * blk;
    uint8_t* u = unres + ((int64_t)d * n + i) * blk;
    const int qrows = xs * size;
    const int64_t q0 = (int64_t)x0 * size * rb;  // the slab's first row
    bool any = false;
    if (qb >= 0)
        for (int r = threadIdx.x; r < qrows; r += THREADS)
            any |= load_row(q + q0 + (int64_t)r * rb, rb) != 0;
    u64 sum = 0;
    int nq = 0, nu = 0;
    if (__syncthreads_or(any)) {
        // the target's bit rows of the slab and its halo
        bool t_any = false;
        const int X = xs + 2 * halo;
        const u64 low = (1ull << halo) - 1;
        for (int t = threadIdx.x; t < X * H; t += THREADS) {
            const int xx = t / H, yy = t - xx * H;
            const int x = x0 - halo + xx, y = yy - halo;
            const int cx = x < 0 ? 0 : (x < size ? 1 : 2);
            const int cy = y < 0 ? 0 : (y < size ? 1 : 2);
            const int64_t off =
                ((int64_t)(x - (cx - 1) * size) * size + (y - (cy - 1) * size))
                * rb;
            const int* col = nb + cx * 9 + cy * 3;
            u64 w[3];
#pragma unroll
            for (int k = 0; k < 3; ++k)
                w[k] = col[k] >= 0
                    ? load_row(tsrc + (int64_t)col[k] * blk + off, rb) : 0;
            const u128 row = ((u128)zorder(w[1]) << halo)
                | (u128)(zorder(w[0]) >> (size - halo))
                | ((u128)(zorder(w[2]) & low) << (size + halo));
            tgt[t] = row;
            t_any |= row != 0;
        }
        const bool t_live = __syncthreads_or(t_any);
        // the queries, THREADS rows a round: each thread loads one row, a
        // block scan numbers the round's voxels, and thread j takes voxels
        // j, j + THREADS, ... (a row's voxels go to neighbouring lanes)
        const int cap = halo * halo, lane = threadIdx.x & 31;
        for (int r0 = 0; r0 < qrows; r0 += THREADS) {
            const int r = r0 + threadIdx.x;
            const u64 bits = r < qrows
                ? zorder(load_row(q + q0 + (int64_t)r * rb, rb)) : 0;
            const int c = __popcll(bits);
            int incl = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += v;
            }
            if (lane == 31) wsum[threadIdx.x >> 5] = incl;
            qbits[threadIdx.x] = bits;
            qflag[threadIdx.x][0] = qflag[threadIdx.x][1] = 0;
            nq += c;
            __syncthreads();
            int base = 0, total = 0;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                base += w < (threadIdx.x >> 5) ? wsum[w] : 0;
                total += wsum[w];
            }
            qoff[threadIdx.x] = base + incl - c;
            __syncthreads();
            for (int j = threadIdx.x; j < total; j += THREADS) {
                // the row: the last k with qoff[k] <= j (it holds voxels)
                int lo = 0, hi = THREADS - 1;
                while (lo < hi) {
                    const int mid = (lo + hi + 1) >> 1;
                    if (qoff[mid] <= j) lo = mid;
                    else hi = mid - 1;
                }
                const u64 w = qbits[lo];
                const int m = j - qoff[lo], pl = __popc((unsigned)w);
                const int z = m < pl
                    ? (int)__fns((unsigned)w, 0, m + 1)
                    : 32 + (int)__fns((unsigned)(w >> 32), 0, m - pl + 1);
                const int rr = r0 + lo, xr = rr / size, y = rr - xr * size;
                const int best = t_live
                    ? search(tgt + (xr + halo) * H + (y + halo), H, z + halo,
                             spiral, n_spiral, cap)
                    : cap + 1;
                if (best <= cap) {
                    sum += (u64)best;
                } else {
                    ++nu;
                    atomicOr(&qflag[lo][z >> 5], 1u << (z & 31));
                }
            }
            __syncthreads();
            if (r < qrows)
                store_row(u + q0 + (int64_t)r * rb, rb,
                          zorder(((u64)qflag[threadIdx.x][1] << 32) |
                                 qflag[threadIdx.x][0]));
            __syncthreads();  // the next round rewrites the arrays
        }
    } else {
        for (int r = threadIdx.x; r < qrows; r += THREADS)
            store_row(u + q0 + (int64_t)r * rb, rb, 0);
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    nq = __reduce_add_sync(FULL, nq);
    nu = __reduce_add_sync(FULL, nu);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red_s[warp] = sum;
        red_n[warp] = nq;
        red_c[warp] = nu;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        u64 ts = 0;
        int64_t tn = 0, tc = 0;
        for (int w = 0; w < WARPS; ++w) {
            ts += red_s[w];
            tn += red_n[w];
            tc += red_c[w];
        }
        int64_t* o = part + (((int64_t)d * n + i) * slabs + s) * 3;
        o[0] = (int64_t)ts;
        o[1] = tn;
        o[2] = tc;
    }
}

__global__ void __launch_bounds__(FINISH_THREADS)
halo_edt_finish_kernel(const int64_t* __restrict__ part,
                       int64_t* __restrict__ stats, int n, int slabs) {
    const int t = blockIdx.x * FINISH_THREADS + threadIdx.x;
    if (t >= 2 * n) return;
    const int d = t / n, i = t - d * n;
    const int64_t* p = part + (int64_t)t * slabs * 3;
    int64_t v[3] = {0, 0, 0};
    for (int s = 0; s < slabs; ++s)
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] += p[s * 3 + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) stats[((int64_t)d * 3 + k) * n + i] = v[k];
}

}  // namespace

extern "C" {

// a_ext / b_ext [rows, size^3 / 8] uint8 packed grids (16-byte aligned);
// idx [n, 27] int32 neighbour table; spiral [n_spiral] int32
// (ops/halo.py halo_spiral_table(halo)). Scratch: part [2, n, slabs, 3]
// int64, slabs = ceil(size / 16) (written before it is read). Out: stats
// [2, 3, n] int64 (sum, n, unres_cnt per direction), unres [2, n,
// size^3 / 8] uint8. Needs size a multiple of 8, size <= 64,
// 1 <= halo <= size, size + 2 halo <= 128. Returns cudaGetLastError (or
// the first failing call's error).
int pcc_halo_edt(const uint8_t* a_ext, const uint8_t* b_ext, int rows_ext,
                 const int32_t* idx, const int32_t* spiral, int n_spiral,
                 int64_t* part, int64_t* stats, uint8_t* unres, int n,
                 int size, int halo, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    if (size <= 0 || size > MAX_SIZE || size % 8 || halo < 1 || halo > size
        || size + 2 * halo > ROW_BITS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int slabs = (size + SLAB - 1) / SLAB;
    const size_t smem = (size_t)(min(SLAB, size) + 2 * halo) *
                        (size + 2 * halo) * sizeof(u128);
    cudaError_t e = cudaFuncSetAttribute(
        halo_edt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    halo_edt_kernel<<<dim3(n * slabs, 2), THREADS, smem, st>>>(
        a_ext, b_ext, rows_ext, idx, spiral, n_spiral, part, unres, n, size,
        halo, slabs);
    halo_edt_finish_kernel<<<(2 * n + FINISH_THREADS - 1) / FINISH_THREADS,
                             FINISH_THREADS, 0, st>>>(part, stats, n, slabs);
    return (int)cudaGetLastError();
}

}  // extern "C"
