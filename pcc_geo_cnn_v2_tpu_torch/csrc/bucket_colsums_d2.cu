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
// with plane2(p, c; n) = ((p - c) . n)^2, and 0 / BIG / 0 / 0 in the
// columns at or past cnt0 (BIG / BIG in candmin / candplane of a block
// without points).
//
// What bounds it on the H100: as K1 (csrc/bucket_colsums.cu), the f32
// operations of the (point, candidate) pairs: d2, the compare with the
// point's running minimum, the column minimum. The plane terms the
// function needs are one plane2 per candidate (candplane) and one per
// change of a point's prefix minimum (colplane), a small share of the
// pairs.
//
// Design: K1's, measured on that kernel, with keys in place of distances.
// One C entry launches three kernels:
//
// 1. `bucket_d2_prep_kernel` packs each candidate a block sweeps (k <
//    cnt0, rounded up to 32) once as a 16-byte f32 record (-2x, -2y, -2z,
//    |c|^2 + 2^23), zeroes the delta columns and tile totals, fills the
//    key column and orders the blocks by descending cnt0.
// 2. `bucket_d2_kernel`: one CTA of NT threads per (NT points, block), the
//    blocks with the most candidates first; a thread carries one point,
//    its running minimum and the fixed-point plane2 of its running argmin.
//    Candidate tiles of TK records are double-buffered in shared memory
//    with 16-byte `cp.async`; a thread loads the records of its next group
//    of G candidates into registers before it computes the current group.
//    - The biased record makes d = |p|^2 + |c|^2 + 2^23 - 2 p.c (one add,
//      three FMAs) the f32 number 2^23 + d2: every intermediate is an
//      integer in [2^23, 2^24), so it is exact and its bits are
//      0x4B000000 | d2. The (d2, row) key is then one shift-or,
//      (bits << 18) | row, with no conversion.
//    - Column sums by deltas, as K1: where a point's minimum improves
//      (strictly: the earlier candidate keeps a tie) the thread adds the
//      change of d2 into a shared 32-bit column, and the change of its
//      fixed-point plane2 (evaluated only there) into two more: its bits
//      above 24 (signed) and its low 24 bits. A shared 64-bit atomicAdd
//      compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64); 32-bit
//      adds without a return compile to one native ATOMS.ADD a warp. A
//      column takes at most one add a thread, NT a CTA and tile, so the
//      two 32-bit sums are exact (|delta| < 2^46: |high| < 2^22 and
//      NT * 2^24 <= 2^31) and the flush joins them into 64 bits. A warp
//      votes once a group on "did any running minimum improve" and applies
//      the group only then.
//    - Column minima by K1's per-warp transposition, carrying keys: lane l
//      writes its key for candidate j into row l, column j of a 32 x 33
//      buffer; after 32 candidates lane l takes the minimum down column l
//      and one shared atomicMin. The minimum key is unique (rows differ),
//      so the lowest row wins in whatever order the atomics land.
//    Once per tile the CTA flushes the three shared columns into global
//    memory with coalesced atomics (deltas only where non-zero) and adds
//    the tile's delta totals into per-tile sums (32-bit for d2, 64-bit for
//    plane2).
// 3. `bucket_d2_scan_kernel`: one CTA per TK columns turns the deltas
//    into inclusive prefix sums (carry-in = the earlier tiles' totals) and
//    writes the four outputs in their final types: colsum and candmin
//    int64, colplane f32 (the fixed-point sum times 2^-20, through f64),
//    and candplane, plane2 at the row the column's key names.
//
// The sweep runs whole groups of 32 candidates. In a block's last group
// the records at or past cnt0 are the next sorted candidates (or the rows
// padding K to a multiple of 32): they may lower a running minimum after
// the last column that counts, and the deltas and keys they produce are
// never flushed.
//
// The launch plan is `bucket_sweep.bucket_plan` in Python, as K1's: point
// row p of a block is handled by thread p % NT of CTA p / NT, a grid of
// (ceil(P / NT), N).
//
// Exactness and order independence. Keys need d2 <= 3 (size-1)^2 < 2^14
// and row < 2^18 (the wrapper checks both, and K1's limit on the 32-bit
// column sums). The d2 deltas wrap in 32 bits and every prefix sum is a
// true column sum below 2^32, as K1's. plane2 is evaluated with explicit
// round-to-nearest multiplies and adds (no FMA contraction), left to
// right, from the exact integer differences, so candplane equals the
// plain PyTorch version bit for bit; each plane2 of colplane is rounded
// once to the nearest 2^-20 and summed in 64-bit integers (unsigned,
// wrapping: the sums stay below 2^64 for |n| components up to
// MAX_NORMAL = 32 at 2^18 points), so colplane does not depend on the
// order of the atomics and differs from an exact sum by at most
// npts * 2^-21 before its rounding to f32. Integer minima and sums do not
// depend on order: two launches and any batch give the same bits for a
// block.

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
constexpr int ROW_BITS = 18;     // key = (d2 << ROW_BITS) | point row
constexpr unsigned NOKEY = 0xffffffffu;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIAS = 8388608.0f;  // 2^23: d = 2^23 + d2 = 0x4B000000 | d2
constexpr float RUN0 = 3.0e38f;  // running minimum before candidate 0
constexpr float FIX = 1048576.0f;  // 2^20: fixed-point scale of plane sums
constexpr int LO_BITS = 24;      // plane delta = high << LO_BITS | low

typedef unsigned long long u64;

// dynamic shared memory of the sweep kernel, in bytes
constexpr int SMEM_CAND = 2 * TK * 16;
constexpr int SMEM_PLANE = 2 * TK * 8;  // high and low columns
constexpr int SMEM_DELTA = 2 * TK * 4;
constexpr int SMEM_MIN = 2 * TK * 4;
constexpr int SMEM_TRANS = (NT / 32) * 32 * TP * 4;
constexpr int SMEM = SMEM_CAND + SMEM_PLANE + SMEM_DELTA + SMEM_MIN
    + SMEM_TRANS;
// CTAs an SM holds: 228 KB of shared memory, 1 KB of it reserved a CTA
constexpr int CTAS_SM = 233472 / (SMEM + 1024) < 8
    ? 233472 / (SMEM + 1024) : 8;

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

// ((p - c) . n)^2 of the integer difference, rounded step by step
__device__ __forceinline__ float plane2(float dx, float dy, float dz,
                                        float nx, float ny, float nz) {
    float dot = __fmul_rn(dx, nx);
    dot = __fadd_rn(dot, __fmul_rn(dy, ny));
    dot = __fadd_rn(dot, __fmul_rn(dz, nz));
    return __fmul_rn(dot, dot);
}

__device__ __forceinline__ long long fixed(float plane) {
    return __float2ll_rn(__fmul_rn(plane, FIX));
}

__device__ __forceinline__ u64 warp_sum64(u64 v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// Candidate records, zeroed accumulators, the key column, the block order.
__global__ void __launch_bounds__(PREP_NT)
bucket_d2_prep_kernel(const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cnt0,
                      float4* __restrict__ rec, u64* __restrict__ dplane,
                      u64* __restrict__ ptot, unsigned* __restrict__ delta,
                      unsigned* __restrict__ key,
                      unsigned* __restrict__ tiletot,
                      int32_t* __restrict__ order, int N, int K, int Kp,
                      int nseg, int size) {
    const int n = blockIdx.y;
    const int k = blockIdx.x * PREP_NT + threadIdx.x;
    const int c0 = cnt0[n];
    const int64_t o = (int64_t)n * Kp + k;
    if (k < round32(c0)) {  // the sweep reads whole groups of 32
        float4 r = {0.f, 0.f, 0.f, BIAS};  // rows padding K to 32
        if (k < K) {
            const int q = pos[(int64_t)n * K + k];
            const int x = q / (size * size), y = (q / size) % size,
                      z = q % size;
            r.x = (float)(-2 * x);
            r.y = (float)(-2 * y);
            r.z = (float)(-2 * z);
            r.w = (float)(x * x + y * y + z * z + (1 << 23));
        }
        rec[o] = r;
    }
    if (k < c0) {
        delta[o] = 0u;
        dplane[o] = 0ull;
        key[o] = NOKEY;
    }
    if (k < nseg) {
        tiletot[(int64_t)n * nseg + k] = 0u;
        ptot[(int64_t)n * nseg + k] = 0ull;
    }
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

// Flush one tile's shared columns into global memory and reset them for
// the tile after next.
__device__ __forceinline__ void flush_tile(unsigned* sd, int* sph,
                                           unsigned* spl, unsigned* sm,
                                           unsigned* gd, u64* gp,
                                           unsigned* gk, unsigned* tot,
                                           u64* ptot, int kn) {
    unsigned t = 0u;
    u64 tp = 0ull;
    for (int j = threadIdx.x; j < kn; j += NT) {
        const unsigned d = sd[j], m = sm[j];
        const u64 pl = ((u64)(long long)sph[j] << LO_BITS) + spl[j];
        sd[j] = 0u;
        sph[j] = 0;
        spl[j] = 0u;
        sm[j] = NOKEY;
        if (d) {
            atomicAdd(gd + j, d);
            t += d;
        }
        if (pl) {
            atomicAdd(gp + j, pl);
            tp += pl;
        }
        if (m != NOKEY) atomicMin(gk + j, m);
    }
    t = __reduce_add_sync(FULL, t);
    tp = warp_sum64(tp);
    if ((threadIdx.x & 31) == 0) {
        if (t) atomicAdd(tot, t);
        if (tp) atomicAdd(ptot, tp);
    }
}

__global__ void __launch_bounds__(NT, CTAS_SM)
bucket_d2_kernel(const int32_t* __restrict__ pts,
                 const float* __restrict__ nrm,
                 const int32_t* __restrict__ cnt0,
                 const int32_t* __restrict__ npts,
                 const int32_t* __restrict__ order,
                 const float4* __restrict__ rec,
                 unsigned* __restrict__ delta, u64* __restrict__ dplane,
                 unsigned* __restrict__ key,
                 unsigned* __restrict__ tiletot, u64* __restrict__ ptot,
                 int P, int Kp, int nseg) {
    extern __shared__ __align__(16) unsigned char smem[];
    float4 (*scand)[TK] = reinterpret_cast<float4 (*)[TK]>(smem);
    int (*sphi)[TK] = reinterpret_cast<int (*)[TK]>(smem + SMEM_CAND);
    unsigned (*splo)[TK] = reinterpret_cast<unsigned (*)[TK]>(
        smem + SMEM_CAND + SMEM_PLANE / 2);
    unsigned (*sdelta)[TK] = reinterpret_cast<unsigned (*)[TK]>(
        smem + SMEM_CAND + SMEM_PLANE);
    unsigned (*smin)[TK] = reinterpret_cast<unsigned (*)[TK]>(
        smem + SMEM_CAND + SMEM_PLANE + SMEM_DELTA);
    unsigned* tmin = reinterpret_cast<unsigned*>(
        smem + SMEM_CAND + SMEM_PLANE + SMEM_DELTA + SMEM_MIN);

    const int n = order[blockIdx.y];
    const int c0 = cnt0[n], np = npts[n];
    const int p = blockIdx.x * NT + threadIdx.x;
    if (blockIdx.x * NT >= np || c0 == 0) return;  // CTA-uniform
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    int x = -1, y = 0, z = 0;
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (p < np) {
        const int64_t o = ((int64_t)n * P + p) * 3;
        x = pts[o]; y = pts[o + 1]; z = pts[o + 2];
        nx = nrm[o]; ny = nrm[o + 1]; nz = nrm[o + 2];
    }
    const bool v = x >= 0;  // padding rows contribute nothing
    const float px = v ? (float)x : 0.f, py = v ? (float)y : 0.f,
                pz = v ? (float)z : 0.f;
    const float pp = v ? (float)(x * x + y * y + z * z) : 0.f;
    float run = v ? RUN0 : -1.f;  // an invalid point never improves
    long long runf = 0;          // fixed-point plane2 of the running argmin
    const unsigned row = (unsigned)p;
    const bool live = __any_sync(FULL, v);  // warp-uniform
    unsigned* tw = tmin + warp * 32 * TP;   // [lane][candidate]
    if (!v)  // an invalid lane's keys: never the minimum
        for (int j = 0; j < 32; ++j) tw[lane * TP + j] = NOKEY;

    for (int j = threadIdx.x; j < 2 * TK; j += NT) {
        (&sdelta[0][0])[j] = 0u;
        (&sphi[0][0])[j] = 0;
        (&splo[0][0])[j] = 0u;
        (&smin[0][0])[j] = NOKEY;
    }
    const float4* recn = rec + (int64_t)n * Kp;
    unsigned* dn = delta + (int64_t)n * Kp;
    u64* pn = dplane + (int64_t)n * Kp;
    unsigned* kn_ = key + (int64_t)n * Kp;
    unsigned* totn = tiletot + (int64_t)n * nseg;
    u64* ptotn = ptot + (int64_t)n * nseg;
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
            flush_tile(sdelta[b ^ 1], sphi[b ^ 1], splo[b ^ 1], smin[b ^ 1],
                       dn + k0 - TK, pn + k0 - TK, kn_ + k0 - TK,
                       totn + t - 1, ptotn + t - 1, TK);
        if (live) {
            const float4* sc = scand[b];
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
                        if (v)
                            tw[lane * TP + g0 + g] =
                                (__float_as_uint(d[g]) << ROW_BITS) | row;
                    }
                    if (__any_sync(FULL, imp)) {  // apply in order
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            if (d[g] < run) {
                                const unsigned acc = (unsigned)(int)(
                                    d[g] - (run == RUN0 ? BIAS : run));
                                // c = -record / 2, exact
                                const long long f = fixed(plane2(
                                    fmaf(0.5f, c[g].x, px),
                                    fmaf(0.5f, c[g].y, py),
                                    fmaf(0.5f, c[g].z, pz), nx, ny, nz));
                                const long long pd = f - runf;
                                run = d[g];
                                runf = f;
                                const int k = kb + g0 + g;
                                if (acc) atomicAdd(&sdelta[b][k], acc);
                                if (pd) {
                                    atomicAdd(&sphi[b][k],
                                              (int)(pd >> LO_BITS));
                                    atomicAdd(&splo[b][k],
                                              (unsigned)pd &
                                                  ((1u << LO_BITS) - 1));
                                }
                            }
                        }
                    }
#pragma unroll
                    for (int g = 0; g < G; ++g) c[g] = cn[g];
                }
                // lane l: the warp's minimum key of candidate kb + l, read
                // down column l of the transposition buffer
                __syncwarp();
                unsigned o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) o[i] = tw[i * TP + lane];
#pragma unroll
                for (int i = 4; i < 32; ++i)
                    o[i & 3] = min(o[i & 3], tw[i * TP + lane]);
                const unsigned own = min(min(o[0], o[1]), min(o[2], o[3]));
                __syncwarp();
                if (kb + lane < kn) atomicMin(&smin[b][kb + lane], own);
            }
        }
        cp_async_wait_all();
        __syncthreads();
    }
    const int t = ntiles - 1;
    flush_tile(sdelta[t & 1], sphi[t & 1], splo[t & 1], smin[t & 1],
               dn + t * TK, pn + t * TK, kn_ + t * TK, totn + t, ptotn + t,
               min(TK, c0 - t * TK));
}

// Inclusive prefix sums of both delta columns along k < cnt0[n], and the
// four outputs (0 / BIG / 0 / 0 past cnt0): one CTA per TK columns.
__global__ void __launch_bounds__(SCAN_NT)
bucket_d2_scan_kernel(const int32_t* __restrict__ pts,
                      const float* __restrict__ nrm,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cnt0,
                      const unsigned* __restrict__ delta,
                      const u64* __restrict__ dplane,
                      const unsigned* __restrict__ key,
                      const unsigned* __restrict__ tiletot,
                      const u64* __restrict__ ptot,
                      int64_t* __restrict__ colsum,
                      int64_t* __restrict__ candmin,
                      float* __restrict__ colplane,
                      float* __restrict__ candplane, int P, int K, int Kp,
                      int nseg, int size) {
    constexpr int V = TK / SCAN_NT;
    __shared__ unsigned wsum[SCAN_NT / 32];
    __shared__ u64 wsump[SCAN_NT / 32];
    __shared__ unsigned carry_s;
    __shared__ u64 carryp_s;
    const int n = blockIdx.y, s = blockIdx.x;
    const int c0 = cnt0[n], k0 = s * TK;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t on = (int64_t)n * K;
    const int kt = k0 + threadIdx.x * V;
    if (k0 >= c0) {
        for (int v = 0; v < V; ++v)
            if (kt + v < K) {
                colsum[on + kt + v] = 0;
                candmin[on + kt + v] = BIG;
                colplane[on + kt + v] = 0.f;
                candplane[on + kt + v] = 0.f;
            }
        return;
    }
    // carry-in: the delta totals of the tiles before this one
    unsigned c = 0u;
    u64 cp = 0ull;
    for (int i = threadIdx.x; i < s; i += SCAN_NT) {
        c += tiletot[(int64_t)n * nseg + i];
        cp += ptot[(int64_t)n * nseg + i];
    }
    c = __reduce_add_sync(FULL, c);
    cp = warp_sum64(cp);
    if (lane == 0) {
        wsum[warp] = c;
        wsump[warp] = cp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned a = 0u;
        u64 ap = 0ull;
        for (int w = 0; w < SCAN_NT / 32; ++w) {
            a += wsum[w];
            ap += wsump[w];
        }
        carry_s = a;
        carryp_s = ap;
    }
    __syncthreads();
    unsigned d[V], run = 0u;
    u64 dp[V], runp = 0ull;
    for (int v = 0; v < V; ++v) {
        const int k = kt + v;
        const bool in = k < c0;
        d[v] = in ? delta[(int64_t)n * Kp + k] : 0u;
        dp[v] = in ? dplane[(int64_t)n * Kp + k] : 0ull;
        run += d[v];
        runp += dp[v];
    }
    // inclusive scan of the thread totals in the warp
    unsigned inc = run;
    u64 incp = runp;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(FULL, inc, o);
        const u64 up = __shfl_up_sync(FULL, incp, o);
        if (lane >= o) {
            inc += u;
            incp += up;
        }
    }
    __syncthreads();
    if (lane == 31) {
        wsum[warp] = inc;
        wsump[warp] = incp;
    }
    __syncthreads();
    unsigned before = carry_s;
    u64 beforep = carryp_s;
    for (int w = 0; w < warp; ++w) {
        before += wsum[w];
        beforep += wsump[w];
    }
    before += inc - run;
    beforep += incp - runp;
    for (int v = 0; v < V; ++v) {
        const int k = kt + v;
        if (k >= K) break;
        before += d[v];
        beforep += dp[v];
        const int64_t o = on + k;
        if (k >= c0) {
            colsum[o] = 0;
            candmin[o] = BIG;
            colplane[o] = 0.f;
            candplane[o] = 0.f;
            continue;
        }
        colsum[o] = (int64_t)before;
        colplane[o] = (float)(__ull2double_rn(beforep) * (1.0 / FIX));
        const unsigned m = key[(int64_t)n * Kp + k];
        if (m == NOKEY) {  // a block without points
            candmin[o] = BIG;
            candplane[o] = (float)BIG;
            continue;
        }
        const int r = (int)(m & ((1u << ROW_BITS) - 1));
        const int f = pos[o];
        const int64_t q = ((int64_t)n * P + r) * 3;
        candmin[o] = (int64_t)(m >> ROW_BITS);
        candplane[o] = plane2((float)(pts[q] - f / (size * size)),
                              (float)(pts[q + 1] - (f / size) % size),
                              (float)(pts[q + 2] - f % size), nrm[q],
                              nrm[q + 1], nrm[q + 2]);
    }
}

}  // namespace

extern "C" {

// pts [N, P, 3] int32 (x < 0 = padding, valid rows first), nrm [N, P, 3]
// f32, pos [N, K] int32 flat candidate positions in a size^3 block, cnt0 /
// npts [N] int32 (cnt0 <= K). colsum / candmin [N, K] int64 and colplane /
// candplane [N, K] f32 need no initialisation. work is 16-byte aligned
// scratch of pcc_bucket_colsums_d2_work_ints(N, K) int32 elements. threads
// (NT = 128) and tiles (>= ceil(P / threads)) are the launch plan: a grid
// of (tiles, N). Needs 3 (size-1)^2 < 2^14 and P <= 2^18 (the caller
// checks). Returns cudaGetLastError (cudaErrorInvalidValue for a plan the
// kernel does not take).
int pcc_bucket_colsums_d2(const int32_t* pts, const float* nrm,
                          const int32_t* pos, const int32_t* cnt0,
                          const int32_t* npts, int64_t* colsum,
                          int64_t* candmin, float* colplane,
                          float* candplane, int32_t* work, int N, int P,
                          int K, int size, int threads, int tiles,
                          void* stream) {
    if (N <= 0 || K <= 0) return (int)cudaGetLastError();
    if (threads != NT || (int64_t)tiles * NT < P)
        return (int)cudaErrorInvalidValue;
    // above 48 KB only when asked for; the attribute belongs to the
    // current device, so it is set on every call (K2 and K5 do the same)
    cudaError_t e = cudaFuncSetAttribute(
        bucket_d2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            bucket_d2_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    const int Kp = round32(K), nseg = (K + TK - 1) / TK;
    const int64_t nk = (int64_t)N * Kp;
    float4* rec = reinterpret_cast<float4*>(work);       // 4 ints a record
    u64* dplane = reinterpret_cast<u64*>(work + nk * 4);  // 2 ints each
    u64* ptot = reinterpret_cast<u64*>(work + nk * 6);
    unsigned* delta =
        reinterpret_cast<unsigned*>(work + nk * 6 + (int64_t)N * nseg * 2);
    unsigned* key = delta + nk;
    unsigned* tiletot = key + nk;
    int32_t* order = reinterpret_cast<int32_t*>(tiletot + (int64_t)N * nseg);
    bucket_d2_prep_kernel<<<dim3((Kp + PREP_NT - 1) / PREP_NT, N), PREP_NT,
                            0, st>>>(pos, cnt0, rec, dplane, ptot, delta,
                                     key, tiletot, order, N, K, Kp, nseg,
                                     size);
    if (P > 0)
        bucket_d2_kernel<<<dim3(tiles, N), NT, SMEM, st>>>(
            pts, nrm, cnt0, npts, order, rec, delta, dplane, key, tiletot,
            ptot, P, Kp, nseg);
    bucket_d2_scan_kernel<<<dim3(nseg, N), SCAN_NT, 0, st>>>(
        pts, nrm, pos, cnt0, delta, dplane, key, tiletot, ptot, colsum,
        candmin, colplane, candplane, P, K, Kp, nseg, size);
    return (int)cudaGetLastError();
}

// int32 elements of scratch pcc_bucket_colsums_d2 needs for N blocks of K
// candidates: records, plane deltas, plane tile totals, d2 deltas, keys,
// d2 tile totals, block order.
int pcc_bucket_colsums_d2_work_ints(int N, int K) {
    const int Kp = round32(K), nseg = (K + TK - 1) / TK;
    return N * (Kp * 8 + nseg * 3 + 1);
}

}  // extern "C"
