// K1: bucket prefix-min column sums for the adaptive-threshold D1 sweep.
//
// Replaces the Pallas TPU kernel `_bucket_kernel`
// (pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py:65, launched by
// `_bucket_colsums_pallas`). Per block n, over the original points p and
// the candidates c_k sorted by descending decoded probability, k < cnt0[n]:
//
//   colsum[n, k]  = sum_p min_{j <= k} d2(p, c_j)   (inclusive prefix-min)
//   candmin[n, k] = min_p d2(p, c_k)
//
// and 0 / BIG in the columns at or past cnt0.
//
// What bounds it on the H100. Per (point, candidate) pair the function
// needs d2 (3 multiply-adds and 1 add, exact on integer-valued f32), the
// compare with the point's running minimum and the column minimum; the
// inputs and outputs are a few MB a launch, so the bound is the f32
// operations. The candidate axis of a block is not split across CTAs (the
// prefix minimum would need a carry-in and a second pass over all pairs),
// so the points are the only parallel axis, a CTA's work follows its
// block's cnt0, and a launch with few blocks leaves few warps on each SM:
// what the kernel reaches is set by the latency of one warp's chain as much
// as by issue.
//
// Design. Each candidate is packed once per launch as a 16-byte f32 record
// (-2x, -2y, -2z, |c|^2), so d2 = |p|^2 + |c|^2 - 2 p.c is one add and three
// FMAs and no divide or modulo is left in the sweep. One C entry launches
// three kernels:
//
// 1. `bucket_colsums_prep_kernel` packs the records of the candidates a
//    block sweeps (k < cnt0, rounded up to 32), zeroes the delta columns and
//    tile totals, fills the column minima, and orders the blocks by
//    descending cnt0. (Packing with a torch gather in the wrapper cost as
//    much device time as the sweep of a chunk: PERF.md, K1.)
// 2. `bucket_colsums_kernel`: one CTA of NT threads per (NT points, block),
//    the blocks with the most candidates first. A thread carries one point
//    and its running minimum. Candidate tiles of TK records are
//    double-buffered in shared memory with 16-byte `cp.async` (the next tile
//    loads while the current one is swept; one `__syncthreads` a tile), and
//    a thread loads the records of its next group of G candidates into
//    registers before it computes the current group.
//    - Column sums by deltas. A point's prefix minimum changes only a few
//      times along the sorted candidates, so the CTA adds the CHANGE (new -
//      old; the first candidate adds d2 itself) into a shared delta column,
//      not every running minimum into every column. A warp computes a
//      group's G distances per thread, then votes once on "did any running
//      minimum improve"; only then (for a small share of the groups) it
//      applies the group in order, with shared atomics the compiler combines
//      per warp.
//    - Column minima by a transposition. Each lane writes its distance to
//      candidate j into row lane, column j of its warp's 32 x 33 shared
//      buffer; after 32 candidates lane l reads column l down
//      and takes one shared atomicMin into the CTA's minimum column. (A
//      `__reduce_min_sync` per candidate, kept by lane k % 32, put its
//      latency on every candidate's path and was slower: PERF.md, K1.)
//    Once per tile the CTA flushes both shared columns into global memory
//    with coalesced atomics (deltas only where non-zero) and adds the tile's
//    delta total into a per-tile sum: no atomic per candidate reaches global
//    memory.
// 3. `bucket_colsums_scan_kernel`: one CTA per TK columns turns the deltas
//    into inclusive prefix sums (carry-in = the sum of the earlier tiles'
//    totals) and writes both int64 outputs, 0 / BIG past cnt0.
//
// The sweep runs whole groups of 32 candidates. In a block's last group the
// records at or past cnt0 are the next sorted candidates (or the zero rows
// padding K to a multiple of 32): they may lower a running minimum after
// the last column that counts, and the deltas and minima they produce are
// never flushed.
//
// The launch plan is `bucket_sweep.bucket_plan` in Python: point row p of a
// block is handled by thread p % NT of CTA p / NT, a grid of (ceil(P / NT),
// N). More points a thread (2, 4 or 8, sharing the staged records and the
// transposition) summed 1.09-3.02x the time over the flagship cloud's
// launches, and won only on its densest chunk: PERF.md, K1.
//
// Exactness and order independence. Coordinates are integers in [0, size)
// and every intermediate of d2 is an integer below 6 (size-1)^2 < 2^24, so
// the f32 arithmetic is exact. Deltas and prefix sums are taken in 32-bit
// unsigned integers, wrapping: every prefix sum is a true column sum below
// P * 3 (size-1)^2 < 2^32 (the wrapper checks both bounds), so the result
// is exact whatever order the atomics land in. Distances are non-negative,
// so their f32 bits order as integers, and a minimum of integers does not
// depend on order either. Two launches and any batch give the same bits
// for a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;          // threads per sweep CTA
constexpr int TK = 512;          // candidates per shared-memory tile
constexpr int G = 4;             // candidates per group (divides 32)
constexpr int TP = 33;           // pitch of a warp's transposition buffer
constexpr int SCAN_NT = 256;     // scan threads, TK / SCAN_NT columns each
constexpr int PREP_NT = 256;
constexpr int BIG = 1000000000;  // > any real d2: the "no point" minimum
constexpr unsigned FULL = 0xffffffffu;
constexpr float FAR = 1e9f;     // |p|^2 of an invalid point
constexpr float RUN0 = 3.0e38f;  // running minimum before candidate 0
// non-negative floats order as their bits
__device__ __forceinline__ int key(float d) { return __float_as_int(d); }
__device__ __forceinline__ int unkey(int k) {
    return __float2int_rn(__int_as_float(k));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round32(int k) {
    return (k + 31) & ~31;
}

// Candidate records, zeroed accumulators and the block order.
__global__ void __launch_bounds__(PREP_NT)
bucket_colsums_prep_kernel(const int32_t* __restrict__ pos,
                           const int32_t* __restrict__ cnt0,
                           float4* __restrict__ rec,
                           unsigned* __restrict__ delta,
                           int32_t* __restrict__ cmin,
                           unsigned* __restrict__ tiletot,
                           int32_t* __restrict__ order,
                           int N, int K, int Kp, int nseg, int size) {
    const int n = blockIdx.y;
    const int k = blockIdx.x * PREP_NT + threadIdx.x;
    const int c0 = cnt0[n];
    if (k < round32(c0)) {  // the sweep reads whole groups of 32
        float4 r = {0, 0, 0, 0};  // the rows padding K to a multiple of 32
        if (k < K) {
            const int q = pos[(int64_t)n * K + k];
            const int x = q / (size * size), y = (q / size) % size,
                      z = q % size;
            r.x = (float)(-2 * x);
            r.y = (float)(-2 * y);
            r.z = (float)(-2 * z);
            r.w = (float)(x * x + y * y + z * z);
        }
        rec[(int64_t)n * Kp + k] = r;
    }
    if (k < c0) {
        delta[(int64_t)n * Kp + k] = 0u;
        cmin[(int64_t)n * Kp + k] = BIG;
    }
    if (k < nseg) tiletot[(int64_t)n * nseg + k] = 0u;
    if (blockIdx.x == 0 && blockIdx.y == 0) {
        // descending cnt0, ties by block index
        for (int i = threadIdx.x; i < N; i += PREP_NT) {
            const int c = cnt0[i];
            int r = 0;
            for (int m = 0; m < N; ++m) {
                const int cm = cnt0[m];
                r += (cm > c) || (cm == c && m < i);
            }
            order[r] = i;
        }
    }
}

// Flush one tile's shared delta and minimum columns into global memory,
// and reset them for the tile after next.
__device__ __forceinline__ void flush_tile(unsigned* sd, int* sm,
                                           unsigned* gd, int32_t* gm,
                                           unsigned* tot, int kn) {
    unsigned t = 0;
    for (int j = threadIdx.x; j < kn; j += NT) {
        const unsigned d = sd[j];
        const int m = sm[j];
        sd[j] = 0u;
        sm[j] = key(FAR);
        if (d) {
            atomicAdd(gd + j, d);
            t += d;
        }
        if (m != key(FAR)) atomicMin(gm + j, unkey(m));
    }
    t = __reduce_add_sync(FULL, t);
    if ((threadIdx.x & 31) == 0 && t) atomicAdd(tot, t);
}

// 40.5 KB of shared memory: 5 CTAs an SM
__global__ void __launch_bounds__(NT, 5)
bucket_colsums_kernel(const int32_t* __restrict__ pts,
                      const int32_t* __restrict__ cnt0,
                      const int32_t* __restrict__ npts,
                      const int32_t* __restrict__ order,
                      const float4* __restrict__ rec,
                      unsigned* __restrict__ delta,
                      int32_t* __restrict__ cmin,
                      unsigned* __restrict__ tiletot,
                      int P, int Kp, int nseg) {
    __shared__ __align__(16) float4 scand[2][TK];
    __shared__ unsigned sdelta[2][TK];
    __shared__ int smin[2][TK];
    __shared__ int tmin[NT / 32][32 * TP];  // per warp: [lane][candidate]

    const int n = order[blockIdx.y];
    const int c0 = cnt0[n], np = npts[n];
    const int p = blockIdx.x * NT + threadIdx.x;
    if (blockIdx.x * NT >= np || c0 == 0) return;  // CTA-uniform
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    int x = -1, y = 0, z = 0;
    if (p < np) {
        const int32_t* q = pts + ((int64_t)n * P + p) * 3;
        x = q[0]; y = q[1]; z = q[2];
    }
    const bool v = x >= 0;  // padding rows contribute nothing
    const float px = v ? (float)x : 0.f, py = v ? (float)y : 0.f,
                pz = v ? (float)z : 0.f;
    const float pp = v ? (float)(x * x + y * y + z * z) : FAR;
    float run = v ? RUN0 : -1.f;  // an invalid point never improves
    const bool live = __any_sync(FULL, v);  // warp-uniform

    for (int j = threadIdx.x; j < 2 * TK; j += NT) {
        (&sdelta[0][0])[j] = 0u;
        (&smin[0][0])[j] = key(FAR);
    }
    const float4* recn = rec + (int64_t)n * Kp;
    unsigned* dn = delta + (int64_t)n * Kp;
    int32_t* mn = cmin + (int64_t)n * Kp;
    unsigned* totn = tiletot + (int64_t)n * nseg;
    const int ntiles = (c0 + TK - 1) / TK;

    auto stage = [&](int t) {
        const int k0 = t * TK;
        const int m = round32(min(TK, c0 - k0));
        for (int j = threadIdx.x; j < m; j += NT)
            cp_async16(&scand[t & 1][j], recn + k0 + j);
        cp_async_commit();
    };
    stage(0);
    cp_async_wait_all();
    __syncthreads();

    for (int t = 0; t < ntiles; ++t) {
        const int b = t & 1, k0 = t * TK, kn = min(TK, c0 - k0);
        if (t + 1 < ntiles) stage(t + 1);
        if (t > 0)
            flush_tile(sdelta[b ^ 1], smin[b ^ 1], dn + k0 - TK,
                       mn + k0 - TK, totn + t - 1, TK);
        if (live) {
            const float4* sc = scand[b];
            int* tw = tmin[warp];
            float4 c[G];  // this group's records; the next group's load ahead
#pragma unroll
            for (int g = 0; g < G; ++g) c[g] = sc[g];
            for (int kb = 0; kb < kn; kb += 32) {
#pragma unroll
                for (int g0 = 0; g0 < 32; g0 += G) {
                    const int k1 = g0 + G < 32 ? kb + g0 + G
                                               : (kb + 32 < kn ? kb + 32 : 0);
                    float4 cn[G];
#pragma unroll
                    for (int g = 0; g < G; ++g) cn[g] = sc[k1 + g];
                    float d[G];
                    bool imp = false;
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        d[g] = fmaf(px, c[g].x, fmaf(py, c[g].y,
                                    fmaf(pz, c[g].z, pp + c[g].w)));
                        imp |= d[g] < run;
                        tw[lane * TP + g0 + g] = key(d[g]);
                    }
                    if (__any_sync(FULL, imp)) {  // apply in order
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            unsigned acc = 0u;
                            if (d[g] < run) {
                                acc = (unsigned)(int)(d[g] -
                                                      (run == RUN0 ? 0.f : run));
                                run = d[g];
                            }
                            if (acc) atomicAdd(&sdelta[b][kb + g0 + g], acc);
                        }
                    }
#pragma unroll
                    for (int g = 0; g < G; ++g) c[g] = cn[g];
                }
                // lane l: the warp's minimum of candidate kb + l, read down
                // column l of the transposition buffer
                __syncwarp();
                int o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) o[i] = tw[i * TP + lane];
#pragma unroll
                for (int i = 4; i < 32; ++i)
                    o[i & 3] = min(o[i & 3], tw[i * TP + lane]);
                const int own = min(min(o[0], o[1]), min(o[2], o[3]));
                __syncwarp();
                if (kb + lane < kn) atomicMin(&smin[b][kb + lane], own);
            }
        }
        cp_async_wait_all();
        __syncthreads();
    }
    const int t = ntiles - 1;
    flush_tile(sdelta[t & 1], smin[t & 1], dn + t * TK, mn + t * TK,
               totn + t, min(TK, c0 - t * TK));
}

// Inclusive prefix sums of the deltas along k < cnt0[n], and both int64
// outputs (0 / BIG past cnt0): one CTA per TK columns of a block.
__global__ void __launch_bounds__(SCAN_NT)
bucket_colsums_scan_kernel(const int32_t* __restrict__ cnt0,
                           const unsigned* __restrict__ delta,
                           const int32_t* __restrict__ cmin,
                           const unsigned* __restrict__ tiletot,
                           int64_t* __restrict__ colsum,
                           int64_t* __restrict__ candmin,
                           int K, int Kp, int nseg) {
    constexpr int V = TK / SCAN_NT;
    __shared__ unsigned wsum[SCAN_NT / 32];
    __shared__ unsigned carry_s;
    const int n = blockIdx.y, s = blockIdx.x;
    const int c0 = cnt0[n], k0 = s * TK;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int64_t* cs = colsum + (int64_t)n * K;
    int64_t* cm = candmin + (int64_t)n * K;
    const int kt = k0 + threadIdx.x * V;
    if (k0 >= c0) {
        for (int v = 0; v < V; ++v)
            if (kt + v < K) { cs[kt + v] = 0; cm[kt + v] = BIG; }
        return;
    }
    // carry-in: the delta totals of the tiles before this one
    unsigned c = 0u;
    for (int i = threadIdx.x; i < s; i += SCAN_NT)
        c += tiletot[(int64_t)n * nseg + i];
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) wsum[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned a = 0u;
        for (int w = 0; w < SCAN_NT / 32; ++w) a += wsum[w];
        carry_s = a;
    }
    __syncthreads();
    const unsigned carry = carry_s;
    unsigned d[V], run = 0u;
    for (int v = 0; v < V; ++v) {
        const int k = kt + v;
        d[v] = k < c0 ? delta[(int64_t)n * Kp + k] : 0u;
        run += d[v];
    }
    unsigned inc = run;  // inclusive scan of the thread totals in the warp
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += u;
    }
    __syncthreads();
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    unsigned before = carry;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    before += inc - run;
    for (int v = 0; v < V; ++v) {
        const int k = kt + v;
        if (k >= K) break;
        before += d[v];
        const bool in = k < c0;
        cs[k] = in ? (int64_t)before : 0;
        cm[k] = in ? cmin[(int64_t)n * Kp + k] : BIG;
    }
}


}  // namespace

extern "C" {

// pts [N, P, 3] int32 (x < 0 = padding, valid rows first), pos [N, K]
// int32 flat candidate positions in a size^3 block, cnt0 / npts [N] int32
// (cnt0 <= K). colsum / candmin [N, K] int64 need no initialisation. work
// is 16-byte aligned scratch of pcc_bucket_colsums_work_ints(N, K) int32
// elements. threads (NT = 128) and tiles (>= ceil(P / threads)) are the
// launch plan: a grid of (tiles, N). Returns cudaGetLastError
// (cudaErrorInvalidValue for a plan the kernel does not take).
int pcc_bucket_colsums(const int32_t* pts, const int32_t* pos,
                       const int32_t* cnt0, const int32_t* npts,
                       int64_t* colsum, int64_t* candmin, int32_t* work,
                       int N, int P, int K, int size, int threads, int tiles,
                       void* stream) {
    if (N <= 0 || K <= 0) return (int)cudaGetLastError();
    if (threads != NT || (int64_t)tiles * NT < P)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int Kp = round32(K), nseg = (K + TK - 1) / TK;
    const int64_t nk = (int64_t)N * Kp;
    float4* rec = reinterpret_cast<float4*>(work);  // 4 ints a record
    unsigned* delta = reinterpret_cast<unsigned*>(work + nk * 4);
    int32_t* cmin = work + nk * 5;
    unsigned* tiletot = reinterpret_cast<unsigned*>(work + nk * 6);
    int32_t* order = work + nk * 6 + (int64_t)N * nseg;
    bucket_colsums_prep_kernel<<<dim3((Kp + PREP_NT - 1) / PREP_NT, N),
                                 PREP_NT, 0, st>>>(
        pos, cnt0, rec, delta, cmin, tiletot, order, N, K, Kp, nseg, size);
    if (P > 0)
        bucket_colsums_kernel<<<dim3(tiles, N), NT, 0, st>>>(
            pts, cnt0, npts, order, rec, delta, cmin, tiletot, P, Kp, nseg);
    bucket_colsums_scan_kernel<<<dim3(nseg, N), SCAN_NT, 0, st>>>(
        cnt0, delta, cmin, tiletot, colsum, candmin, K, Kp, nseg);
    return (int)cudaGetLastError();
}

// int32 elements of scratch pcc_bucket_colsums needs for N blocks of K
// candidates: records, deltas, minima, tile totals, block order.
int pcc_bucket_colsums_work_ints(int N, int K) {
    const int Kp = round32(K), nseg = (K + TK - 1) / TK;
    return N * (Kp * 6 + nseg + 1);
}

}  // extern "C"
