// K1: bucket prefix-min column sums for the adaptive-threshold D1 sweep.
//
// Replaces the Pallas TPU kernel `_bucket_kernel`
// (pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py:65, launched by
// `_bucket_colsums_pallas`). Per block n, over the original points p and
// the candidates c_k sorted by descending decoded probability:
//
//   colsum[n, k]  = sum_p min_{j <= k} d2(p, c_j)   (inclusive prefix-min)
//   candmin[n, k] = min_p d2(p, c_k)
//
// for k < cnt0[n]; columns at or past cnt0 are never written (the wrapper
// masks them).
//
// Design (a first, simple, exact kernel): one CTA per (point tile of TP
// points, block). Each thread owns one point and its running minimum;
// candidate coordinates stream through shared memory in sorted order, TK
// at a time. For every candidate a warp reduces its 32 prefix-min values
// (`__reduce_add_sync`) and its 32 distances (`__reduce_min_sync`), and
// lane 0 issues one atomicAdd / atomicMin into the block's column. The TPU
// kernel's log-doubling prefix-min across lanes becomes the per-thread
// sequential carry.
//
// Exactness: coordinates are integers in [0, size), d2 <= 3 (size-1)^2, and
// the sums are accumulated in 32-bit unsigned integers (P * d2 < 2^32 for
// every P <= size^3 at size 64), so the result is exact and independent of
// the atomics' order.
//
// Bound: operations. The function needs 9 int32 operations per (point,
// candidate) pair — 3 subtractions and 3 multiply(-add)s for d2, the running
// min, the column-sum add and the column min — on the CUDA cores' int32
// pipes (no tensor-core formulation: a min-plus scan, not a product); the
// inputs and outputs are a few MB per batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 128;     // points per CTA, one per thread
constexpr int TK = 2048;    // candidates staged per shared-memory tile
constexpr int BIG = 1000000000;  // > any real d2; the "no point" minimum

__global__ void __launch_bounds__(TP)
bucket_colsums_kernel(const int32_t* __restrict__ pts,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cnt0,
                      const int32_t* __restrict__ npts,
                      unsigned int* __restrict__ colsum,
                      int32_t* __restrict__ candmin,
                      int P, int K, int size) {
    __shared__ int16_t cx[TK], cy[TK], cz[TK];
    const int n = blockIdx.y;
    const int p0 = blockIdx.x * TP;
    if (p0 >= npts[n]) return;  // whole tile past the block's points
    const int p = p0 + threadIdx.x;
    int px = -1, py = 0, pz = 0;
    if (p < P) {
        const int32_t* q = pts + ((int64_t)n * P + p) * 3;
        px = q[0]; py = q[1]; pz = q[2];
    }
    const bool valid = px >= 0;
    const bool warp_any = __any_sync(0xffffffffu, valid);
    const int lane = threadIdx.x & 31;
    const int c0 = cnt0[n];
    const int32_t* posn = pos + (int64_t)n * K;
    unsigned int* cs = colsum + (int64_t)n * K;
    int32_t* cm = candmin + (int64_t)n * K;
    const int plane = size * size;
    int run = BIG;
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
            run = min(run, d2);
            const unsigned int s =
                __reduce_add_sync(0xffffffffu, valid ? (unsigned)run : 0u);
            const int m = __reduce_min_sync(0xffffffffu, d2);
            if (lane == 0) {
                if (s) atomicAdd(cs + k0 + i, s);
                if (m < BIG) atomicMin(cm + k0 + i, m);
            }
        }
    }
}

}  // namespace

extern "C" {

// colsum must be zeroed and candmin filled with 1e9 by the caller; both
// are [N, K]. pts [N, P, 3] int32 (x < 0 = padding), pos [N, K] int32
// flat candidate positions, cnt0/npts [N] int32. Returns cudaGetLastError.
int pcc_bucket_colsums(const int32_t* pts, const int32_t* pos,
                       const int32_t* cnt0, const int32_t* npts,
                       int32_t* colsum, int32_t* candmin, int N, int P,
                       int K, int size, void* stream) {
    if (N > 0 && P > 0) {
        dim3 grid((P + TP - 1) / TP, N);
        bucket_colsums_kernel<<<grid, TP, 0, (cudaStream_t)stream>>>(
            pts, pos, cnt0, npts, reinterpret_cast<unsigned int*>(colsum),
            candmin, P, K, size);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
