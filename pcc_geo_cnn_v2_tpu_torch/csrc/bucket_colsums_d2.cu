// K3: bucket prefix-min column sums with point-to-plane (D2) terms.
//
// Replaces the Pallas TPU kernel `_bucket_kernel_d2`
// (pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py:121, launched by
// `_bucket_colsums_pallas` with `nrm`). Per block n, over the original
// points p (with their normals n_p) and the candidates c_k sorted by
// descending decoded probability, for k < cnt0[n]:
//
//   colsum[n, k]    = sum_p min_{j <= k} d2(p, c_j)          (as K1)
//   candmin[n, k]   = min_p d2(p, c_k)                       (as K1)
//   colplane[n, k]  = sum_p plane2(p, c_{a(p,k)}; n_p), a(p,k) the FIRST
//                     j <= k attaining the prefix minimum (the earlier
//                     candidate wins distance ties)
//   candplane[n, k] = plane2(p*, c_k; n_{p*}), p* the LOWEST point row
//                     among the rows attaining candmin[n, k]
//
// with plane2(p, c; n) = ((p - c) . n)^2. Columns at or past cnt0 keep
// what the wrapper filled in.
//
// Design. As in K1, one CTA per (tile of TP points, block); each thread
// owns one point, its running minimum `run` and the plane value of the
// running argmin, and walks the candidates in sorted order through
// shared-memory tiles. The prefix minimum of a point changes only a few
// times along the candidates, so the kernel does not add every point's
// running value into every column. It adds the CHANGE: where a point's
// minimum improves at candidate k (strictly: the earlier candidate keeps
// a tie) it adds (new - old) of d2 and of the plane value into column k of
// two delta arrays, and a second kernel turns the deltas into inclusive
// prefix sums along k. The column minimum and its first-tied row come from
// one 32-bit key per pair, (d2 << 18) | row, reduced with
// `__reduce_min_sync` and one `atomicMin` per warp and candidate: d2 <=
// 3 (size-1)^2 < 2^14 and row < 2^18 (the wrapper checks both). A third
// small kernel evaluates plane2 at each column's winning row.
//
// Determinism and exactness. d2 deltas are 64-bit integers: colsum and
// candmin equal K1's bit for bit. plane2 is evaluated with explicit
// round-to-nearest multiplies and adds (no FMA contraction), left to
// right, so candplane equals the plain PyTorch version bit for bit. The
// plane deltas are accumulated in 64-bit fixed point with 20 fractional
// bits (each plane value rounded to the nearest 2^-20 once), so colplane
// does not depend on the order of the atomics: two launches give identical
// bits, and it differs from an exact sum by at most npts * 2^-21. The
// fixed-point sum holds for |n_p| up to ~50 (plane2 < 2^25 per point at
// 2^18 points); the encoder checks the normals once per cloud.
//
// Bound: operations, as K1: 9 int32 operations per (point, candidate) pair
// (d2, running min, column sum, column min); the plane arithmetic the
// function needs is one 6-flop evaluation per candidate and per prefix-min
// change, which is negligible next to the pairs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 128;          // points per CTA, one per thread
constexpr int TK = 2048;         // candidates staged per shared-memory tile
constexpr int BIG = 1000000000;  // > any real d2; the "no point" minimum
constexpr int ROW_BITS = 18;     // key = (d2 << ROW_BITS) | point row
constexpr unsigned int NOKEY = 0xFFFFFFFFu;
constexpr float FIX = 1048576.0f;  // 2^20: fixed-point scale of plane sums
constexpr int SCAN_THREADS = 1024;

typedef unsigned long long u64;

__device__ __forceinline__ float plane2(int dx, int dy, int dz, float nx,
                                        float ny, float nz) {
    float dot = __fmul_rn((float)dx, nx);
    dot = __fadd_rn(dot, __fmul_rn((float)dy, ny));
    dot = __fadd_rn(dot, __fmul_rn((float)dz, nz));
    return __fmul_rn(dot, dot);
}

__global__ void __launch_bounds__(TP)
bucket_d2_kernel(const int32_t* __restrict__ pts,
                 const float* __restrict__ nrm,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ cnt0,
                 const int32_t* __restrict__ npts,
                 u64* __restrict__ dsum, u64* __restrict__ dplane,
                 unsigned int* __restrict__ key, int P, int K, int size) {
    __shared__ int16_t cx[TK], cy[TK], cz[TK];
    const int n = blockIdx.y;
    const int p0 = blockIdx.x * TP;
    if (p0 >= npts[n]) return;  // whole tile past the block's points
    const int p = p0 + threadIdx.x;
    int px = -1, py = 0, pz = 0;
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (p < P) {
        const int64_t o = ((int64_t)n * P + p) * 3;
        px = pts[o]; py = pts[o + 1]; pz = pts[o + 2];
        nx = nrm[o]; ny = nrm[o + 1]; nz = nrm[o + 2];
    }
    const bool valid = px >= 0;
    const bool warp_any = __any_sync(0xffffffffu, valid);
    const int lane = threadIdx.x & 31;
    const int c0 = cnt0[n];
    const int32_t* posn = pos + (int64_t)n * K;
    u64* ds = dsum + (int64_t)n * K;
    u64* dp = dplane + (int64_t)n * K;
    unsigned int* kn_ = key + (int64_t)n * K;
    const int plane = size * size;
    int run = BIG;        // running prefix minimum of this point
    long long runf = 0;   // fixed-point plane value of its argmin
    for (int k0 = 0; k0 < c0; k0 += TK) {
        const int kn = min(TK, c0 - k0);
        __syncthreads();
        for (int i = threadIdx.x; i < kn; i += TP) {
            const int f = posn[k0 + i];
            cx[i] = (int16_t)(f / plane);
            cy[i] = (int16_t)((f / size) % size);
            cz[i] = (int16_t)(f % size);
        }
        __syncthreads();
        if (!warp_any) continue;  // warp-uniform: every lane is padding
        for (int i = 0; i < kn; ++i) {
            const int dx = px - cx[i], dy = py - cy[i], dz = pz - cz[i];
            const int d2 = valid ? dx * dx + dy * dy + dz * dz : BIG;
            const unsigned int k32 = valid
                ? ((unsigned int)d2 << ROW_BITS) | (unsigned int)p : NOKEY;
            const unsigned int m = __reduce_min_sync(0xffffffffu, k32);
            if (lane == 0 && m != NOKEY) atomicMin(kn_ + k0 + i, m);
            if (d2 < run) {  // strictly: the earlier candidate keeps a tie
                const long long f =
                    __float2ll_rn(__fmul_rn(plane2(dx, dy, dz, nx, ny, nz),
                                            FIX));
                const long long dd = (long long)d2 - (run == BIG ? 0 : run);
                atomicAdd(ds + k0 + i, (u64)dd);
                atomicAdd(dp + k0 + i, (u64)(f - runf));
                run = d2;
                runf = f;
            }
        }
    }
}

// Inclusive prefix sums along k < cnt0[n] of both delta arrays, in place:
// one CTA per block, each thread a contiguous segment.
__global__ void __launch_bounds__(SCAN_THREADS)
bucket_d2_scan_kernel(const int32_t* __restrict__ cnt0,
                      long long* __restrict__ dsum,
                      long long* __restrict__ dplane, int K) {
    __shared__ long long ts[SCAN_THREADS], tp[SCAN_THREADS];
    const int n = blockIdx.x;
    const int c0 = cnt0[n];
    long long* a = dsum + (int64_t)n * K;
    long long* b = dplane + (int64_t)n * K;
    const int seg = (c0 + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(threadIdx.x * seg, c0);
    const int hi = min(lo + seg, c0);
    long long sa = 0, sb = 0;
    for (int k = lo; k < hi; ++k) { sa += a[k]; sb += b[k]; }
    ts[threadIdx.x] = sa;
    tp[threadIdx.x] = sb;
    __syncthreads();
    if (threadIdx.x == 0) {  // exclusive scan of the segment totals
        long long ra = 0, rb = 0;
        for (int t = 0; t < SCAN_THREADS; ++t) {
            const long long va = ts[t], vb = tp[t];
            ts[t] = ra; tp[t] = rb;
            ra += va; rb += vb;
        }
    }
    __syncthreads();
    sa = ts[threadIdx.x];
    sb = tp[threadIdx.x];
    for (int k = lo; k < hi; ++k) {
        sa += a[k]; sb += b[k];
        a[k] = sa; b[k] = sb;
    }
}

// candmin and candplane from each column's winning (d2, row) key.
__global__ void bucket_d2_cand_kernel(const int32_t* __restrict__ pts,
                                      const float* __restrict__ nrm,
                                      const int32_t* __restrict__ pos,
                                      const int32_t* __restrict__ cnt0,
                                      const unsigned int* __restrict__ key,
                                      int32_t* __restrict__ candmin,
                                      float* __restrict__ candplane,
                                      int P, int K, int size) {
    const int n = blockIdx.y;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= cnt0[n]) return;
    const int64_t o = (int64_t)n * K + k;
    const unsigned int m = key[o];
    if (m == NOKEY) {  // a block without points
        candmin[o] = BIG;
        candplane[o] = (float)BIG;
        return;
    }
    const int row = (int)(m & ((1u << ROW_BITS) - 1));
    const int f = pos[o];
    const int64_t q = ((int64_t)n * P + row) * 3;
    const int dx = pts[q] - f / (size * size);
    const int dy = pts[q + 1] - (f / size) % size;
    const int dz = pts[q + 2] - f % size;
    candmin[o] = (int32_t)(m >> ROW_BITS);
    candplane[o] = plane2(dx, dy, dz, nrm[q], nrm[q + 1], nrm[q + 2]);
}

}  // namespace

extern "C" {

// pts [N, P, 3] int32 (x < 0 = padding), nrm [N, P, 3] f32, pos [N, K]
// int32 flat candidate positions, cnt0/npts [N] int32. The caller zeroes
// dsum and dplane ([N, K] int64) and fills key ([N, K] uint32) with
// 0xFFFFFFFF. On return dsum holds colsum, dplane the fixed-point
// (2^-20) colplane, candmin [N, K] int32 and candplane [N, K] f32 their
// columns k < cnt0. Needs 3 (size-1)^2 < 2^14 and P <= 2^18. Returns
// cudaGetLastError.
int pcc_bucket_colsums_d2(const int32_t* pts, const float* nrm,
                          const int32_t* pos, const int32_t* cnt0,
                          const int32_t* npts, int64_t* dsum,
                          int64_t* dplane, uint32_t* key, int32_t* candmin,
                          float* candplane, int N, int P, int K, int size,
                          void* stream) {
    if (N > 0 && P > 0 && K > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        bucket_d2_kernel<<<dim3((P + TP - 1) / TP, N), TP, 0, st>>>(
            pts, nrm, pos, cnt0, npts, reinterpret_cast<u64*>(dsum),
            reinterpret_cast<u64*>(dplane), key, P, K, size);
        bucket_d2_scan_kernel<<<N, SCAN_THREADS, 0, st>>>(
            cnt0, reinterpret_cast<long long*>(dsum),
            reinterpret_cast<long long*>(dplane), K);
        bucket_d2_cand_kernel<<<dim3((K + 255) / 256, N), 256, 0, st>>>(
            pts, nrm, pos, cnt0, key, candmin, candplane, P, K, size);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
