// K5: exact-EDT adaptive-threshold D1 sweep sums.
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_sweep.py:156, launched by
// `d1_sweep_sums_pallas`). Per block n and threshold t, with the candidate
// set S_t = {v : x_hat[n, v] > thr[t]}:
//
//   cnt[n, t] = |S_t|
//   ba[n, t]  = sum_{v in S_t} dt_orig[n, v]
//   ab[n, t]  = sum_{v occupied} min_{c in S_t} |v - c|^2    (t < t_end[n])
//
// for t < first_empty[n] (the first threshold whose set is empty); later
// thresholds keep the zeros the wrapper filled in. `t_end <= first_empty`
// lets the wrapper keep the sparse-tail thresholds off the EDT (it computes
// their AB sums from the point lists), as the TPU wrapper does.
//
// The TPU kernel's coarse-grid bound, axis-ray bound and threshold
// chunking are cost controls that never change a value; this kernel
// carries over the function, not them.
//
// Design (a first, simple, exact kernel). A 64^3 volume does not fit a
// CTA's shared memory, so the separable EDT is split as in K2, and the
// thresholds are processed in groups of TG = 4 (two launches per group):
//  1. z pass: one thread per (block, y, x) column reads x_hat once per
//     group, keeps the last / next candidate position of each of the TG
//     thresholds in registers, and writes the 1-D distance (uint8, 255 =
//     no candidate in the column) into a [N, TG, size, size, size] scratch.
//     The same read gives cnt and ba: per-thread integer partial sums, a
//     warp reduction and one atomic per warp.
//  2. plane pass: one CTA per (z plane, threshold of the group, block)
//     lists the plane's occupied voxels, stages the plane's squared column
//     distances in shared memory and, for each occupied voxel, searches
//     the (dy, dx) disc around it, rows outward, while dy^2 + dx^2 is
//     below the best value so far. The search is exact without any
//     external bound (every term is >= 0) and costs ~pi D lattice points
//     for a voxel whose result is D, so voxels near the candidate set
//     (the common case) are cheap. Planes without occupied voxels, and
//     thresholds at or past t_end, exit at once.
// TG = 4 keeps the scratch of a 32-block batch at 32 MB, inside the 50 MB
// L2, between the two passes, and lets the z pass read x_hat once for 4
// thresholds.
//
// Exactness: squared distances are integers <= 3 (size-1)^2 and dt_orig
// comes in as int32, so cnt, ba and ab are exact integers (64-bit
// accumulators) whatever the order of the atomics.
//
// Bound: x_hat (f32), dt_orig (int32) and occ (uint8) are read once, 75 MB
// for 32 blocks. The function needs, in integer operations: one pass over
// the voxels for cnt and ba of every threshold (bin, count, BA add: 3 per
// voxel), and per voxel and threshold below t_end the compare and two
// scans (5) plus the disc searches. This kernel does more than that: it
// compares, counts and adds BA per voxel for every threshold below
// first_empty. With EDTs on a hundred thresholds the operations dominate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TG = 4;            // thresholds per group
constexpr int NONE = 255;        // no candidate along the column
constexpr int INF_I = 1 << 24;   // squared distance of NONE
constexpr int ZPASS_THREADS = 128;
constexpr int PLANE_THREADS = 128;

typedef unsigned long long u64;

__global__ void __launch_bounds__(ZPASS_THREADS)
sweep_zpass_kernel(const float* __restrict__ x_hat,
                   const int32_t* __restrict__ dt,
                   const float* __restrict__ thr,
                   const int32_t* __restrict__ first_empty,
                   const int32_t* __restrict__ t_end,
                   uint8_t* __restrict__ dz, int32_t* __restrict__ cnt,
                   u64* __restrict__ ba, int size, int T, int t0) {
    const int n = blockIdx.y;
    const int fe = first_empty[n];
    if (t0 >= fe) return;  // the whole group is past the first empty set
    const int plane = size * size;
    const int col = blockIdx.x * ZPASS_THREADS + threadIdx.x;
    const bool live = col < plane;
    const bool need_dz = t0 < t_end[n];
    float th[TG];
    int c[TG], last[TG];
    u64 s[TG];
#pragma unroll
    for (int g = 0; g < TG; ++g) {
        // thresholds past the first empty set compare false everywhere
        th[g] = (t0 + g < fe) ? thr[t0 + g] : __int_as_float(0x7f800000);
        c[g] = 0;
        s[g] = 0;
        last[g] = -(1 << 20);
    }
    if (live) {
        const int64_t base = (int64_t)n * size * plane + col;
        const float* xv = x_hat + base;
        const int32_t* dv = dt + base;
        uint8_t* out = dz + (int64_t)n * TG * size * plane + col;
        for (int z = 0; z < size; ++z) {
            const float v = xv[(int64_t)z * plane];
            const int d = dv[(int64_t)z * plane];
#pragma unroll
            for (int g = 0; g < TG; ++g) {
                if (v > th[g]) {
                    last[g] = z;
                    ++c[g];
                    s[g] += (u64)d;
                }
                if (need_dz) {
                    const int dd = z - last[g];
                    out[((int64_t)g * size + z) * plane] =
                        (uint8_t)(dd < NONE ? dd : NONE);
                }
            }
        }
        if (need_dz) {
            int next[TG];
#pragma unroll
            for (int g = 0; g < TG; ++g) next[g] = 1 << 20;
            for (int z = size - 1; z >= 0; --z) {
                const float v = xv[(int64_t)z * plane];
#pragma unroll
                for (int g = 0; g < TG; ++g) {
                    if (v > th[g]) next[g] = z;
                    const int dd = next[g] - z;
                    uint8_t* o = out + ((int64_t)g * size + z) * plane;
                    if (dd < *o) *o = (uint8_t)dd;
                }
            }
        }
    }
#pragma unroll
    for (int g = 0; g < TG; ++g) {
        if (t0 + g >= fe) continue;  // uniform over the CTA
        const int cw = __reduce_add_sync(0xffffffffu, c[g]);
        u64 sw = s[g];
        for (int o = 16; o; o >>= 1)
            sw += __shfl_xor_sync(0xffffffffu, sw, o);
        if ((threadIdx.x & 31) == 0 && cw) {
            atomicAdd(cnt + (int64_t)n * T + t0 + g, cw);
            atomicAdd(ba + (int64_t)n * T + t0 + g, sw);
        }
    }
}

__global__ void __launch_bounds__(PLANE_THREADS)
sweep_plane_kernel(const uint8_t* __restrict__ dz,
                   const uint8_t* __restrict__ occ,
                   const int32_t* __restrict__ t_end,
                   u64* __restrict__ ab, int size, int T, int t0) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int n_occ;
    const int z = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
    const int t = t0 + g;
    if (t >= t_end[n]) return;
    const int plane = size * size;
    int* g2 = reinterpret_cast<int*>(smem);                      // [plane]
    uint16_t* list = reinterpret_cast<uint16_t*>(g2 + plane);    // [plane]
    if (threadIdx.x == 0) n_occ = 0;
    __syncthreads();
    const uint8_t* op = occ + ((int64_t)n * size + z) * plane;
    for (int i = threadIdx.x; i < plane; i += PLANE_THREADS)
        if (op[i]) list[atomicAdd(&n_occ, 1)] = (uint16_t)i;
    __syncthreads();
    const int m = n_occ;
    if (m == 0) return;  // uniform: no occupied voxel reads this plane
    const uint8_t* src = dz + (((int64_t)n * TG + g) * size + z) * plane;
    for (int i = threadIdx.x; i < plane; i += PLANE_THREADS) {
        const int d = src[i];
        g2[i] = d == NONE ? INF_I : d * d;
    }
    __syncthreads();
    u64 s = 0;
    for (int j = threadIdx.x; j < m; j += PLANE_THREADS) {
        const int i = list[j];
        const int y = i / size, x = i % size;
        int best = g2[i];
        for (int dy = 0; dy < size && dy * dy < best; ++dy) {
            const int base = dy * dy;
            for (int sgn = 0; sgn < (dy ? 2 : 1); ++sgn) {
                const int yy = sgn ? y - dy : y + dy;
                if (yy < 0 || yy >= size) continue;
                const int* row = g2 + yy * size;
                best = min(best, row[x] + base);
                for (int dx = 1; dx < size && base + dx * dx < best; ++dx) {
                    const int e = base + dx * dx;
                    if (x + dx < size) best = min(best, row[x + dx] + e);
                    if (x - dx >= 0) best = min(best, row[x - dx] + e);
                }
            }
        }
        s += (u64)best;
    }
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0 && s) atomicAdd(ab + (int64_t)n * T + t, s);
}

}  // namespace

extern "C" {

// Thresholds per group: the scratch holds [N, group, size^3] bytes.
int pcc_edt_sweep_group() { return TG; }

// x_hat [N, size^3] f32, occ [N, size^3] uint8, dt [N, size^3] int32
// (squared EDT of occ), thr [T] f32 ascending, first_empty / t_end [N]
// int32 (t_end <= first_empty <= T), scratch [N, TG, size^3] uint8; cnt
// [N, T] int32, ba / ab [N, T] int64, all three zeroed by the caller.
// Needs size <= 90 (shared memory of the plane pass). Returns
// cudaGetLastError.
int pcc_edt_sweep(const float* x_hat, const uint8_t* occ, const int32_t* dt,
                  const float* thr, const int32_t* first_empty,
                  const int32_t* t_end, uint8_t* scratch, int32_t* cnt,
                  int64_t* ba, int64_t* ab, int N, int size, int T,
                  void* stream) {
    if (N <= 0 || T <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int plane = size * size;
    const size_t smem = (size_t)plane * (sizeof(int) + sizeof(uint16_t));
    for (int t0 = 0; t0 < T; t0 += TG) {
        sweep_zpass_kernel<<<dim3((plane + ZPASS_THREADS - 1) / ZPASS_THREADS,
                                  N), ZPASS_THREADS, 0, st>>>(
            x_hat, dt, thr, first_empty, t_end, scratch, cnt,
            reinterpret_cast<u64*>(ba), size, T, t0);
        sweep_plane_kernel<<<dim3(size, TG, N), PLANE_THREADS, smem, st>>>(
            scratch, occ, t_end, reinterpret_cast<u64*>(ab), size, T, t0);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
