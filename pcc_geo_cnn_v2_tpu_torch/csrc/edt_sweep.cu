// K5: exact-EDT adaptive-threshold D1 sweep sums.
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_sweep.py:156, launched by
// `d1_sweep_sums_pallas`). Per block n and threshold t, with the candidate
// set S_t = {v : x_hat[n, v] > thr[t]} (f32 `>`, thresholds ascending):
//
//   cnt[n, t] = |S_t|
//   ba[n, t]  = sum_{v in S_t} min(dt_orig[n, v], 2^24)
//   ab[n, t]  = sum_{v occupied} min_{c in S_t} |v - c|^2    (t < te[n])
//
// for t < first_empty[n] (the number of thresholds below the block's
// largest value; 0 when the block holds a NaN); cnt and ba are 0 from
// there on. te = min(t_end, first_empty); ab is `inf` from te on, which
// lets the caller keep the sparse-tail thresholds off the EDT (it computes
// their AB sums from the point lists), as the TPU wrapper does. All three
// are exact integer sums, written once as f32 (round to nearest).
//
// The TPU kernel's coarse-grid bound, axis-ray bound and threshold
// chunking are cost controls that never change a value; this kernel
// carries over the function, not them.
//
// Design: three launches a call, whatever T.
//  1. edt_sweep_bins_kernel, one CTA per (block, segment of seg voxels):
//     reads x_hat, dt_orig and occ once. A voxel's bin
//     b(v) = #{t : x_hat(v) > thr[t]} (binary search over the thresholds
//     in shared memory; NaN gets 0) is written as uint16, and 1 and dt_orig
//     go into per-bin shared histograms (lanes of a warp with one bin are
//     summed first: __match_any_sync). Each CTA also lists its segment's
//     occupied voxels (warp ballots, one shared atomic a warp) and its
//     largest bin. S_t = {b > t}, so cnt and ba of every threshold are
//     suffix sums of the histograms.
//  2. edt_sweep_sums_kernel, one CTA per block: adds the segments'
//     histograms, takes the suffix sums, writes cnt, ba and ab's inf tail,
//     and the offsets of the occupied lists; CTA 0 also lists pass 3's
//     work items, one per (block, threshold below te), every block's
//     sparsest sets first.
//  3. edt_sweep_ab_kernel<W>, one CTA per (block, threshold t < te). It
//     builds S_t as bit rows in shared memory, W 64-bit words per (z, y)
//     row along x (32 KB at B = 64), from the bins with one __ballot_sync
//     per 32 voxels, and the set's three axis projections (which rows are
//     not empty; the OR of the rows along y and along z). Each occupied
//     voxel is then searched:
//     a. a lane walks a spiral table of (dz, dy) rows in order of
//        dz^2 + dy^2 (a row's nearest candidate along x is a shift and
//        __ffsll / __clzll) and stops at the first entry whose dz^2 + dy^2
//        is not below its best value: exact without any external bound.
//        Voxels near the set end here, within LANE_ENTRIES entries;
//     b. a search still open takes lower bounds from the projections (the
//        squared 2-D distances to them) and ends if its best value meets
//        them;
//     c. else, for a set of at most BRUTE_MAX voxels (listed in shared
//        memory as int8 (z, y, x) and |c|^2) the open lanes compare their
//        voxels with every candidate, one broadcast read and one dp4a a
//        candidate; for a larger set the whole warp finishes each open
//        search, 32 spiral entries a step, from the first entry the row
//        projection allows.
//     A far voxel would otherwise hold its warp, and its CTA, for
//     thousands of spiral rows: the sparse sets at the highest thresholds
//     below te, with thousands of occupied voxels far from them, set the
//     time of a launch. The CTA adds its voxels' distances and writes the
//     threshold's AB once: no global atomics. Nothing passes through
//     global memory between the 1-D and 2-D steps.
//
// Exactness: squared distances are integers <= 3 (size-1)^2 < 2^24, dt
// is capped at 2^24, so the 64-bit sums are exact whatever the order of
// the work; the f32 outputs equal the int64 sums rounded once.
//
// Bound (per call): x_hat (f32), dt_orig (f32) and occ (uint8) read once,
// three [N, T] f32 out. Operations the function needs: one bin per voxel
// (3 int32 operations, with the histogram adds); the sets are nested
// (S_t = S_{t+1} + {b = t + 1}), so they need no more work per voxel; per
// occupied voxel and threshold below te one add of its distance, and the
// disc searches (~pi D rows for a voxel whose result is D, 2 operations
// each: 2 pi ab). Pass 3 rebuilds each set from the bins (a 2-byte L2
// read and a compare per voxel and threshold), more than that bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int BINS_THREADS = 256;
constexpr int SUMS_THREADS = 256;
constexpr int AB_THREADS = 512;
constexpr int AB_WARPS = AB_THREADS / 32;
constexpr int T_MAX = 2048;           // shared histograms of pass 1 / 2
constexpr int INF_I = 1 << 24;        // > 3 (size-1)^2 for size <= 128
constexpr float DT_CAP = 16777216.f;  // 2^24, the wrapper's DT_CAP
constexpr int ROWS_AHEAD = 4;         // rows a warp loads before its ballots
constexpr int LANE_ENTRIES = 8;       // spiral entries a lane searches alone
constexpr int BRUTE_MAX = 2048;       // sets listed for the brute-force path

__global__ void __launch_bounds__(BINS_THREADS)
edt_sweep_bins_kernel(const float* __restrict__ x_hat,
                      const uint8_t* __restrict__ occ,
                      const float* __restrict__ dt,
                      const float* __restrict__ thr,
                      uint16_t* __restrict__ bins, int32_t* __restrict__ hcnt,
                      u64* __restrict__ hba, int32_t* __restrict__ seg_max,
                      int32_t* __restrict__ occ_list,
                      int32_t* __restrict__ occ_cnt, int size, int T, int S,
                      int seg) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* hb = reinterpret_cast<u64*>(smem);           // [T + 1]
    int* hc = reinterpret_cast<int*>(hb + T + 1);      // [T + 1]
    float* th = reinterpret_cast<float*>(hc + T + 1);  // [T]
    __shared__ int n_occ, max_bin, has_nan;
    const int s = blockIdx.x, n = blockIdx.y;
    for (int i = threadIdx.x; i <= T; i += BINS_THREADS) {
        hb[i] = 0;
        hc[i] = 0;
        if (i < T) th[i] = thr[i];
    }
    if (threadIdx.x == 0) {
        n_occ = 0;
        max_bin = 0;
        has_nan = 0;
    }
    __syncthreads();
    const int vol = size * size * size;
    const int lo = s * seg, hi = min(lo + seg, vol);
    const int64_t base = (int64_t)n * vol;
    int32_t* list = occ_list + ((int64_t)n * S + s) * seg;
    const int lane = threadIdx.x & 31;
    int my_max = 0;
    bool nan = false;
    // the trip count is the same for every thread: warp-wide collectives
    for (int i0 = lo; i0 < hi; i0 += BINS_THREADS) {
        const int i = i0 + threadIdx.x;
        const bool live = i < hi;
        int b = -1;
        unsigned d = 0;
        bool o = false;
        if (live) {
            const float v = x_hat[base + i];
            int l = 0, h = T;  // #{t : v > thr[t]}, thresholds ascending
            while (l < h) {
                const int mid = (l + h) >> 1;
                if (v > th[mid]) l = mid + 1;
                else h = mid;
            }
            b = l;
            nan |= v != v;
            my_max = max(my_max, b);
            d = (unsigned)fminf(dt[base + i], DT_CAP);
            o = occ[base + i] != 0;
            bins[base + i] = (uint16_t)b;
        }
        const unsigned peers = __match_any_sync(FULL, b);
        if (peers == FULL) {  // one bin for the whole warp (the common case)
            const unsigned sum = __reduce_add_sync(FULL, d);  // < 2^29
            if (lane == 0 && b >= 0) {
                atomicAdd(hc + b, 32);
                atomicAdd(hb + b, (u64)sum);
            }
        } else {
            u64 sum = 0;
            for (int k = 0; k < 32; ++k) {
                const unsigned dk = __shfl_sync(FULL, d, k);
                if ((peers >> k) & 1u) sum += dk;
            }
            if (live && lane == __ffs(peers) - 1) {
                atomicAdd(hc + b, __popc(peers));
                atomicAdd(hb + b, sum);
            }
        }
        const unsigned om = __ballot_sync(FULL, o);
        if (om) {
            int wb = 0;
            if (lane == 0) wb = atomicAdd(&n_occ, __popc(om));
            wb = __shfl_sync(FULL, wb, 0);
            if (o) list[wb + __popc(om & ((1u << lane) - 1u))] = i;
        }
    }
    const int wmax = __reduce_max_sync(FULL, my_max);
    const bool wnan = __any_sync(FULL, nan);
    if (lane == 0) {
        atomicMax(&max_bin, wmax);
        if (wnan) has_nan = 1;
    }
    __syncthreads();
    const int64_t row = ((int64_t)n * S + s) * (T + 1);
    for (int i = threadIdx.x; i <= T; i += BINS_THREADS) {
        hcnt[row + i] = hc[i];
        hba[row + i] = hb[i];
    }
    if (threadIdx.x == 0) {
        occ_cnt[n * S + s] = n_occ;
        seg_max[n * S + s] = has_nan ? -1 : max_bin;  // -1: a NaN was seen
    }
}

// #thresholds below the block's largest value; 0 if the block holds a NaN
// (torch.topk and jnp.max both take a NaN as the largest value)
__device__ int block_first_empty(const int32_t* __restrict__ seg_max, int n,
                                 int S) {
    int fe = 0;
    for (int s = 0; s < S; ++s) {
        const int m = seg_max[n * S + s];
        if (m < 0) return 0;
        fe = max(fe, m);
    }
    return fe;
}

__global__ void __launch_bounds__(SUMS_THREADS)
edt_sweep_sums_kernel(const int32_t* __restrict__ hcnt,
                      const u64* __restrict__ hba,
                      const int32_t* __restrict__ seg_max,
                      const int32_t* __restrict__ occ_cnt,
                      const int32_t* __restrict__ t_end,
                      int32_t* __restrict__ te_all,
                      int32_t* __restrict__ occ_off,
                      int32_t* __restrict__ items, float* __restrict__ cnt,
                      float* __restrict__ ba, float* __restrict__ ab, float inf,
                      int N, int T, int S) {
    __shared__ u64 sb[T_MAX + 1];
    __shared__ int sc[T_MAX + 1];
    const int n = blockIdx.x;
    const int fe = block_first_empty(seg_max, n, S);
    const int te = max(min(t_end[n], fe), 0);
    for (int b = threadIdx.x; b <= T; b += SUMS_THREADS) {
        int c = 0;
        u64 v = 0;
        for (int s = 0; s < S; ++s) {
            const int64_t r = ((int64_t)n * S + s) * (T + 1) + b;
            c += hcnt[r];
            v += hba[r];
        }
        sc[b] = c;
        sb[b] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        // suffix sums: sc[b] = #voxels with bin >= b
        for (int b = T - 1; b >= 0; --b) {
            sc[b] += sc[b + 1];
            sb[b] += sb[b + 1];
        }
        int acc = 0;
        occ_off[n * (S + 1)] = 0;
        for (int s = 0; s < S; ++s) {
            acc += occ_cnt[n * S + s];
            occ_off[n * (S + 1) + s + 1] = acc;
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += SUMS_THREADS) {
        const bool live = t < fe;  // S_t = {bin > t} = {bin >= t + 1}
        cnt[(int64_t)n * T + t] = live ? (float)sc[t + 1] : 0.f;
        ba[(int64_t)n * T + t] = live ? __ull2float_rn(sb[t + 1]) : 0.f;
        if (t >= te) ab[(int64_t)n * T + t] = inf;
    }
    if (n) return;
    // CTA 0 lists pass 3's work items, one a (block, t < te): k-major,
    // t = te - 1 - k, so that every block's sparsest sets (the longest
    // searches) start first. items[0] = count, items[1 + i] = n | t << 16.
    __syncthreads();
    for (int k = threadIdx.x; k <= T; k += SUMS_THREADS) sc[k] = 0;
    __syncthreads();
    for (int k = threadIdx.x; k < N; k += SUMS_THREADS) {
        const int tk = max(min(t_end[k], block_first_empty(seg_max, k, S)), 0);
        te_all[k] = tk;
        atomicAdd(sc + tk, 1);  // histogram of te
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        // sc[k] = #blocks with te > k, then its exclusive prefix over k
        int above = 0, acc = 0;
        for (int k = T; k >= 0; --k) {
            const int h = sc[k];
            sc[k] = above;
            above += h;
        }
        for (int k = 0; k <= T; ++k) {
            const int c = sc[k];
            sc[k] = acc;
            acc += c;
        }
        items[0] = acc;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < T; k += SUMS_THREADS) {
        int at = 1 + sc[k];
        for (int b = 0; b < N; ++b) {
            const int tb = te_all[b];
            if (tb > k) items[at++] = b | ((tb - 1 - k) << 16);
        }
    }
}

// x of the set bit nearest to x in a row of W words (bit x of the row is
// bit x & 63 of word x >> 6), -1 if the row is empty; ties take x + d
template <int W>
__device__ __forceinline__ int nearest_x(const u64* __restrict__ row, int x) {
    const int wi = x >> 6, xb = x & 63;
    const u64 cur = row[wi];
    int best = INF_I, cx = -1;
    const u64 r = cur >> xb;  // bits >= x of this word, x at bit 0
    if (r) {
        best = __ffsll((long long)r) - 1;
        cx = x + best;
    } else if (W > 1 && wi == 0 && row[1]) {
        best = 64 - xb + __ffsll((long long)row[1]) - 1;
        cx = x + best;
    }
    const u64 l = cur << (63 - xb);  // bits <= x of this word, x at bit 63
    if (l) {
        const int d = __clzll((long long)l);
        if (d < best) cx = x - d;
    } else if (W > 1 && wi == 1 && row[0]) {
        const int d = xb + 1 + __clzll((long long)row[0]);
        if (d < best) cx = x - d;
    }
    return cx;
}

// min over a of (a - a0)^2 + (b - b0)^2 for the set bits b of vec[a] (W
// words each): the squared 2-D distance from (a0, b0) to a projection of
// the set. Every such bound is a lower bound of the 3-D distance.
template <int W>
__device__ int proj_bound(const u64* __restrict__ vec, int size, int a0,
                          int b0) {
    int best = INF_I;
    for (int d = 0; d < size && d * d < best; ++d) {
        for (int s = 0; s < (d ? 2 : 1); ++s) {
            const int a = s ? a0 - d : a0 + d;
            if (a < 0 || a >= size) continue;
            const int c = nearest_x<W>(vec + a * W, b0);
            if (c >= 0) best = min(best, d * d + (c - b0) * (c - b0));
        }
    }
    return best;
}

// one entry of the spiral table: the rows (z +- dz, y +- dy) at
// r2 = dz^2 + dy^2; the least r2 + dx^2 over them (INF_I if none)
template <int W>
__device__ __forceinline__ int entry_best(const u64* __restrict__ set,
                                          int size, int z, int y, int x,
                                          int p) {
    const int r2 = p >> 14, dz = (p >> 7) & 127, dy = p & 127;
    int best = INF_I;
    for (int sz = 0; sz < (dz ? 2 : 1); ++sz) {
        const int zz = sz ? z - dz : z + dz;
        if (zz < 0 || zz >= size) continue;
        for (int sy = 0; sy < (dy ? 2 : 1); ++sy) {
            const int yy = sy ? y - dy : y + dy;
            if (yy < 0 || yy >= size) continue;
            const int c = nearest_x<W>(set + (zz * size + yy) * W, x);
            if (c >= 0) best = min(best, r2 + (c - x) * (c - x));
        }
    }
    return best;
}

// The whole warp finishes the spiral search of voxel (z, y, x) from entry
// e with best value bb and lower bound lw, 32 entries a step. Every lane
// passes the same arguments and gets the result.
template <int W>
__device__ __forceinline__ int warp_spiral(const u64* __restrict__ set,
                                           const int32_t* __restrict__ spiral,
                                           int size, int z, int y, int x,
                                           int e, int bb, int lw) {
    const int n_entries = size * size, lane = threadIdx.x & 31;
    for (int base = e; base < n_entries; base += 32) {
        const int ei = base + lane;
        int b = INF_I;
        if (ei < n_entries) {
            const int p = __ldg(spiral + ei);
            if ((p >> 14) < bb) b = entry_best<W>(set, size, z, y, x, p);
        }
        bb = min(bb, __reduce_min_sync(FULL, b));
        if (bb <= lw) break;
        const int nx = base + 32;
        if (nx >= n_entries || (__ldg(spiral + nx) >> 14) >= bb) break;
    }
    return bb;
}

template <int W>
__global__ void __launch_bounds__(AB_THREADS)
edt_sweep_ab_kernel(const uint16_t* __restrict__ bins,
                    const int32_t* __restrict__ occ_list,
                    const int32_t* __restrict__ occ_off,
                    const int32_t* __restrict__ items,
                    const float* __restrict__ cnt,
                    const int32_t* __restrict__ spiral,
                    float* __restrict__ ab, int N, int size, int T, int S,
                    int seg) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ u64 red[AB_WARPS];
    __shared__ int next_batch, n_cand;
    const int rows = size * size, n_entries = size * size;
    const int max_r2 = 2 * (size - 1) * (size - 1) + 1;  // start's last
    // the start table follows the spiral: start[r] = first entry with
    // dz^2 + dy^2 >= r
    const int32_t* start = spiral + n_entries;
    u64* set = reinterpret_cast<u64*>(smem);           // [rows][W]
    u64* proj = set + (size_t)rows * W;                 // [3][size][W]
    int2* cand = reinterpret_cast<int2*>(proj + 3 * size * W);  // [BRUTE_MAX]
    int* off = reinterpret_cast<int*>(cand + BRUTE_MAX);  // [S + 1]
    if ((int)blockIdx.x >= items[0]) return;  // the grid is an upper bound
    const int it = items[1 + blockIdx.x];
    const int n = it & 0xffff, t = it >> 16;
    for (int i = threadIdx.x; i <= S; i += AB_THREADS)
        off[i] = occ_off[n * (S + 1) + i];
    if (threadIdx.x == 0) next_batch = n_cand = 0;
    __syncthreads();
    const int m = off[S];
    if (m == 0) {  // no occupied voxel: AB is 0
        if (threadIdx.x == 0) ab[(int64_t)n * T + t] = 0.f;
        return;
    }
    // a small set is also listed, for the brute-force path
    const bool brute = (int)cnt[(int64_t)n * T + t] <= BRUTE_MAX;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const uint16_t* bv = bins + (int64_t)n * rows * size;
    constexpr int NC = 2 * W;  // 32-voxel chunks of a row
    for (int r0 = warp * ROWS_AHEAD; r0 < rows;
         r0 += AB_WARPS * ROWS_AHEAD) {
        int bx[ROWS_AHEAD][NC];
#pragma unroll
        for (int q = 0; q < ROWS_AHEAD; ++q)
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const int x = c * 32 + lane;
                bx[q][c] = (r0 + q < rows && x < size)
                               ? bv[(int64_t)(r0 + q) * size + x] : 0;
            }
#pragma unroll
        for (int q = 0; q < ROWS_AHEAD; ++q) {
            const int r = r0 + q;
            if (r >= rows) break;  // uniform over the warp
            u64 word[W];
#pragma unroll
            for (int w = 0; w < W; ++w)
                word[w] = __ballot_sync(FULL, bx[q][2 * w] > t) |
                          ((u64)__ballot_sync(FULL, bx[q][2 * w + 1] > t)
                           << 32);
            if (lane < W) set[r * W + lane] = lane ? word[W - 1] : word[0];
        }
    }
    __syncthreads();
    if (brute) {
        // list a small set for the brute-force path: (z, y, x) as int8
        // lanes and |c|^2, in no particular order
        int k = 0;
        for (int r = threadIdx.x; r < rows; r += AB_THREADS)
#pragma unroll
            for (int w = 0; w < W; ++w) k += __popcll(set[r * W + w]);
        int at = k ? atomicAdd(&n_cand, k) : 0;
        for (int r = threadIdx.x; r < rows && k; r += AB_THREADS) {
            const int z = r / size, y = r - z * size;
#pragma unroll
            for (int w = 0; w < W; ++w)
                for (u64 b = set[r * W + w]; b; b &= b - 1) {
                    const int x = 64 * w + __ffsll((long long)b) - 1;
                    cand[at++] = make_int2((z << 16) | (y << 8) | x,
                                           z * z + y * y + x * x);
                }
        }
    }
    // the set's three projections: px[z] bit y = row (z, y) is not empty
    // (along x), py[z] = OR over y of row (z, y) (along y), pz[y] = OR
    // over z of row (z, y) (along z)
    for (int a = threadIdx.x; a < 2 * size; a += AB_THREADS) {
        u64 o[W], f[W];
#pragma unroll
        for (int w = 0; w < W; ++w) o[w] = f[w] = 0;
        if (a < size) {  // plane z = a: px and py
            for (int yy = 0; yy < size; ++yy) {
                u64 any = 0;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    const u64 r = set[(a * size + yy) * W + w];
                    o[w] |= r;
                    any |= r;
                }
                if (any) f[yy >> 6] |= 1ull << (yy & 63);
            }
#pragma unroll
            for (int w = 0; w < W; ++w) {
                proj[a * W + w] = f[w];
                proj[(size + a) * W + w] = o[w];
            }
        } else {  // row y = a - size: pz
            const int yy = a - size;
            for (int zz = 0; zz < size; ++zz)
#pragma unroll
                for (int w = 0; w < W; ++w)
                    o[w] |= set[(zz * size + yy) * W + w];
#pragma unroll
            for (int w = 0; w < W; ++w) proj[(2 * size + yy) * W + w] = o[w];
        }
    }
    __syncthreads();
    const int nc = n_cand;
    u64 acc = 0;
    int si = 0;
    // A warp takes 32 voxels at a time, one a lane. A lane walks the
    // spiral table (rows in order of dz^2 + dy^2) alone for LANE_ENTRIES
    // entries. A search still open then takes its lower bounds from the
    // set's projections, and is done if its best value meets them. Else,
    // for a small set the open lanes compare their voxels with every
    // candidate (all lanes read one candidate at a time: a broadcast);
    // for a large one the whole warp finishes each open search, 32 spiral
    // entries a step, from the first entry the row projection allows.
    while (true) {
        int jb = 0;
        if (lane == 0) jb = atomicAdd(&next_batch, 32);
        jb = __shfl_sync(FULL, jb, 0);
        if (jb >= m) break;
        const int j = jb + lane;
        int z = 0, y = 0, x = 0, e = 0, best = INF_I, lower = 0;
        bool open = false;
        if (j < m) {
            while (off[si + 1] <= j) ++si;
            const int v =
                occ_list[((int64_t)n * S + si) * seg + (j - off[si])];
            z = v / rows;
            const int rem = v - z * rows;
            y = rem / size;
            x = rem - y * size;
            open = true;
            for (; e < LANE_ENTRIES && e < n_entries; ++e) {
                const int p = __ldg(spiral + e);
                if ((p >> 14) >= best) {
                    open = false;
                    break;
                }
                best = min(best, entry_best<W>(set, size, z, y, x, p));
            }
            if (open && e < n_entries) {
                const int ex = min(proj_bound<W>(proj, size, z, y), max_r2);
                lower = max(max(ex, proj_bound<W>(proj + size * W, size, z,
                                                  x)),
                            proj_bound<W>(proj + 2 * size * W, size, y, x));
                open = best > lower;
                e = max(e, __ldg(start + ex));
            } else {
                open = false;
            }
        }
        const unsigned todo = __ballot_sync(FULL, open);
        if (todo && brute) {
            // |c - v|^2 = |c|^2 - 2 c.v + |v|^2, c.v one dp4a on int8 lanes
            const int pv = (z << 16) | (y << 8) | x;
            const int vv = z * z + y * y + x * x;
            int b = INF_I;
            for (int i0 = 0; i0 < nc; i0 += 64) {
                const int i1 = min(i0 + 64, nc);
#pragma unroll 4
                for (int i = i0; i < i1; ++i) {
                    const int2 c = cand[i];
                    b = min(b, c.y - 2 * __dp4a(c.x, pv, 0));
                }
                if (__all_sync(FULL, !open || b + vv <= lower)) break;
            }
            if (open) best = min(best, b + vv);
        } else {
            for (unsigned u = todo; u; u &= u - 1) {
                const int src = __ffs(u) - 1;
                const int bb = warp_spiral<W>(
                    set, spiral, size, __shfl_sync(FULL, z, src),
                    __shfl_sync(FULL, y, src), __shfl_sync(FULL, x, src),
                    __shfl_sync(FULL, e, src), __shfl_sync(FULL, best, src),
                    __shfl_sync(FULL, lower, src));
                if (lane == src) best = bb;
            }
        }
        if (j < m) acc += (u64)best;
    }
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        u64 s = 0;
        for (int w = 0; w < AB_WARPS; ++w) s += red[w];
        ab[(int64_t)n * T + t] = __ull2float_rn(s);
    }
}

template <int W>
int launch_ab(const uint16_t* bins, const int32_t* occ_list,
              const int32_t* occ_off, const int32_t* items, const float* cnt,
              const int32_t* spiral, float* ab, int N, int size, int T,
              int S, int seg, cudaStream_t st) {
    const size_t smem = (size_t)(size + 3) * size * W * sizeof(u64) +
                        (size_t)BRUTE_MAX * sizeof(int2) +
                        (size_t)(S + 1) * sizeof(int);
    auto kernel = edt_sweep_ab_kernel<W>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<N * T, AB_THREADS, smem, st>>>(bins, occ_list, occ_off, items,
                                            cnt, spiral, ab, N, size, T, S,
                                            seg);
    return 0;
}

}  // namespace

extern "C" {

// x_hat [N, size^3] f32, occ [N, size^3] uint8 (non-zero = occupied), dt
// [N, size^3] f32 (squared EDT of occ; capped at 2^24 here), thr [T] f32
// ascending, t_end [N] int32, spiral [size^2 + 2 (size-1)^2 + 2] int32
// (the search order, ops/edt_sweep.spiral_table). Scratch (written before
// it is read, so it needs no zeroing): bins [N, size^3] uint16, hcnt / hba
// [N, S, T + 1] int32 / int64, seg_max / occ_cnt [N, S], occ_list [N, S,
// seg], occ_off [N, S + 1], te [N], items [1 + N T] int32,
// S = ceil(size^3 / seg). Out: cnt, ba, ab [N, T] f32. Needs T <= 2048,
// size <= 128 and one bit-row set in shared memory. Returns
// cudaGetLastError (or the first failing call's error).
int pcc_edt_sweep(const float* x_hat, const uint8_t* occ, const float* dt,
                  const float* thr, const int32_t* t_end, uint16_t* bins,
                  int32_t* hcnt, int64_t* hba, int32_t* seg_max,
                  int32_t* occ_list, int32_t* occ_cnt, int32_t* occ_off,
                  int32_t* te, int32_t* items, const int32_t* spiral,
                  float* cnt, float* ba, float* ab, float inf, int N,
                  int size, int T, int seg, void* stream) {
    if (N <= 0 || T <= 0) return (int)cudaGetLastError();
    if (T > T_MAX || size <= 0 || size > 128 || seg <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int vol = size * size * size, S = (vol + seg - 1) / seg;
    const size_t smem1 = (size_t)(T + 1) * (sizeof(u64) + sizeof(int)) +
                         (size_t)T * sizeof(float);
    edt_sweep_bins_kernel<<<dim3(S, N), BINS_THREADS, smem1, st>>>(
        x_hat, occ, dt, thr, bins, hcnt, reinterpret_cast<u64*>(hba), seg_max,
        occ_list, occ_cnt, size, T, S, seg);
    edt_sweep_sums_kernel<<<N, SUMS_THREADS, 0, st>>>(
        hcnt, reinterpret_cast<const u64*>(hba), seg_max, occ_cnt, t_end, te,
        occ_off, items, cnt, ba, ab, inf, N, T, S);
    const int err = size > 64
        ? launch_ab<2>(bins, occ_list, occ_off, items, cnt, spiral, ab, N,
                       size, T, S, seg, st)
        : launch_ab<1>(bins, occ_list, occ_off, items, cnt, spiral, ab, N,
                       size, T, S, seg, st);
    if (err) return err;
    return (int)cudaGetLastError();
}

}  // extern "C"
