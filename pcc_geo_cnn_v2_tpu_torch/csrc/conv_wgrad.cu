// conv_wgrad: the weight gradient of a stride-1, k3 3D convolution
// (`F.conv3d` of an input already zero-padded by one voxel a side), f32
// operands and f32 FFMA sums, in a fixed order:
//
//   dw[co, ci, a, b, c] = sum_{n, d, h, w} dy[n, co, d, h, w] *
//                         xp[n, ci, d + a, h + b, w + c]
//
// for xp [N, CI, D + 2, H + 2, W + 2] and dy [N, CO, D, H, W].
//
// Replaces no Pallas TPU kernel: the JAX package leaves a layer's weight
// gradient to XLA. It was added for training, which runs its convolutions
// under cuDNN's deterministic algorithms: for few channels at large
// volumes (c3p's 16 -> 16 at 64^3 and 32^3, 16 -> 1 at 64^3) cuDNN's fast
// weight-gradient algorithms finish the N*D*H*W reduction with float
// atomics, so it falls back to its direct kernel at about 1 TFLOP/s, 81% of
// a training step.
//
// Bound: operations. 16 -> 16 at 64^3, batch 32: 116 GFLOP against 1.1 GB
// read (1.73 ms at the f32 FFMA peak, 0.34 ms at HBM speed). Design:
//   - The reduction over positions is split into tiles of TD x TH x TW
//     positions of one batch element; a grid of CTAS CTAs takes a fixed,
//     contiguous range of tiles each (the split depends on the shape alone).
//   - A CTA stages a tile of xp with its one-voxel halo and the tile's dy,
//     every channel, into shared memory with cp.async (8- and 16-byte copies
//     where rows are aligned, else 4-byte; zero fill past the volume's
//     edge), double-buffered against the compute of the previous tile.
//   - A thread owns RCO output channels, one input channel and all 27 taps
//     (108 accumulators at RCO = 4). A segment of V = 8 positions along w
//     is one step: its dy values (RCO x 8) stay in registers while the 9
//     rows of x that the taps (a, b) read are loaded, 12 floats each (three
//     128-bit loads), and each x value serves the 3 taps along w and RCO
//     output channels: 864 FFMA for 35 shared loads at RCO = 4.
//   - Where one group of threads does not fill the CTA (fewer channels),
//     G groups take the tile's segments in turn, each into its own
//     partial.
//   - Bank conflicts: a quarter warp reads 8 input channels at one offset;
//     the channel stride is an odd number of 16-byte groups. dy reads are
//     broadcasts (a quarter warp shares its output channels).
//   - Each thread writes its partials to its slot of a scratch buffer; a
//     second kernel sums the slots in a fixed order (8 contiguous ranges,
//     each in order, then the 8 sums in order). No atomics: the result does
//     not depend on the CTAs' scheduling, so two runs are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;           // positions along w a segment
constexpr int TW = 32;         // positions along w a tile
constexpr int XS = TW + 4;     // x row stride: TW + 2 columns read, 16 B rows
constexpr int CTAS = 132;      // CTAs of the reduction (one an SM of an H100)
constexpr int RED_WARPS = 8;   // slot ranges of the sum over the partials

template <int CI, int CO, int TD, int TH>
struct Geom {
    static constexpr int RCO = CO < 4 ? CO : 4;      // output channels a thread
    static constexpr int PG = (CO / RCO) * CI;       // threads a group
    static constexpr int G = THREADS / PG;           // groups a CTA
    static constexpr int SEGS = TD * TH * (TW / V);  // segments a tile
    static constexpr int XPL = (TD + 2) * (TH + 2) * XS;
    // channel stride: an odd number of 16-byte groups
    static constexpr int XCS = XPL % 8 == 4 ? XPL : XPL + 4;
    static constexpr int DYCS = TD * TH * TW;        // dy floats a channel
    static constexpr int STAGE = CI * XCS + CO * DYCS;
    static constexpr int SMEM = 2 * STAGE * 4;
    static constexpr int J = CO * CI * 27;           // weights
    static_assert(CO % RCO == 0 && THREADS % PG == 0, "whole groups");
    static_assert(SEGS % G == 0, "every group takes as many segments");
    static_assert(XPL % 4 == 0 && DYCS % 4 == 0 && STAGE % 4 == 0,
                  "16 B alignment");
    static_assert(SMEM + 1024 <= 232448, "a CTA fits in shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// a cp.async of `bytes` that writes zeros where `valid` is false
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src,
                                         bool valid) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         dst),
                     "l"(src), "r"(valid ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                         dst),
                     "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Tile {
    long long n;
    int d0, h0, w0;
};

__device__ __forceinline__ Tile tile_at(long long t, int tiles_d,
                                        int tiles_h, int tiles_w, int TD,
                                        int TH) {
    Tile r;
    const int tw = (int)(t % tiles_w);
    t /= tiles_w;
    const int th = (int)(t % tiles_h);
    t /= tiles_h;
    r.d0 = (int)(t % tiles_d) * TD;
    r.n = t / tiles_d;
    r.h0 = th * TH;
    r.w0 = tw * TW;
    return r;
}

// Stage tile `tl` of xp (with its halo) and dy into `buf`. XB: bytes a
// copy of x (4 or 8), YB: of dy (4 or 16).
template <int CI, int CO, int TD, int TH, int XB, int YB>
__device__ __forceinline__ void load_tile(float* buf, const float* xp,
                                          const float* dy, const Tile& tl,
                                          int D, int H, int W) {
    using Gm = Geom<CI, CO, TD, TH>;
    const int Dp = D + 2, Hp = H + 2, Wp = W + 2;
    constexpr int XE = XB / 4, XK = XS / XE;  // floats a copy, copies a row
    constexpr int XROWS = CI * (TD + 2) * (TH + 2);
#pragma unroll 4
    for (int e = threadIdx.x; e < XROWS * XK; e += THREADS) {
        const int col = (e % XK) * XE;
        const int row = e / XK;
        const int hy = row % (TH + 2), dz = (row / (TH + 2)) % (TD + 2),
                  ci = row / ((TH + 2) * (TD + 2));
        const int d = tl.d0 + dz, h = tl.h0 + hy, w = tl.w0 + col;
        const bool ok = d < Dp && h < Hp && col < TW + 2 && w < Wp;
        const float* src =
            ok ? xp + (((tl.n * CI + ci) * Dp + d) * Hp + h) * (long long)Wp + w
               : xp;
        cp_async<XB>(smem_addr(buf + ci * Gm::XCS + (dz * (TH + 2) + hy) * XS +
                               col),
                     src, ok);
    }
    constexpr int YE = YB / 4, YK = TW / YE;
    constexpr int YROWS = CO * TD * TH;
    float* sdy = buf + CI * Gm::XCS;
#pragma unroll 4
    for (int e = threadIdx.x; e < YROWS * YK; e += THREADS) {
        const int col = (e % YK) * YE;
        const int row = e / YK;
        const int hy = row % TH, dz = (row / TH) % TD, co = row / (TH * TD);
        const int d = tl.d0 + dz, h = tl.h0 + hy, w = tl.w0 + col;
        const bool ok = d < D && h < H && w < W;
        const float* src =
            ok ? dy + (((tl.n * CO + co) * D + d) * H + h) * (long long)W + w
               : dy;
        cp_async<YB>(smem_addr(sdy + co * Gm::DYCS + (dz * TH + hy) * TW + col),
                     src, ok);
    }
}

template <int CI, int CO, int TD, int TH, int XB, int YB>
__global__ void __launch_bounds__(THREADS, 1)
    conv_wgrad_partials(const float* __restrict__ xp,
                        const float* __restrict__ dy,
                        float* __restrict__ part, int D, int H, int W,
                        int tiles_d, int tiles_h, int tiles_w,
                        long long tiles) {
    using Gm = Geom<CI, CO, TD, TH>;
    constexpr int RCO = Gm::RCO;
    extern __shared__ __align__(16) float smem[];
    const int g = threadIdx.x / Gm::PG, r = threadIdx.x % Gm::PG;
    const int ci = r % CI, co0 = (r / CI) * RCO;
    const long long t_lo = tiles * blockIdx.x / gridDim.x;
    const long long t_hi = tiles * (blockIdx.x + 1) / gridDim.x;

    float acc[RCO][27];
#pragma unroll
    for (int j = 0; j < RCO; ++j)
#pragma unroll
        for (int k = 0; k < 27; ++k) acc[j][k] = 0.f;

    if (t_lo < t_hi)
        load_tile<CI, CO, TD, TH, XB, YB>(
            smem, xp, dy, tile_at(t_lo, tiles_d, tiles_h, tiles_w, TD, TH), D,
            H, W);
    cp_async_commit();
    for (long long t = t_lo; t < t_hi; ++t) {
        float* buf = smem + ((t - t_lo) & 1) * Gm::STAGE;
        if (t + 1 < t_hi)
            load_tile<CI, CO, TD, TH, XB, YB>(
                smem + ((t + 1 - t_lo) & 1) * Gm::STAGE, xp, dy,
                tile_at(t + 1, tiles_d, tiles_h, tiles_w, TD, TH), D, H, W);
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies have landed
        __syncthreads();
        const float* sx = buf + ci * Gm::XCS;
        const float* sdy = buf + CI * Gm::XCS + co0 * Gm::DYCS;
#pragma unroll 1
        for (int s = g; s < Gm::SEGS; s += Gm::G) {
            const int sw = s % (TW / V), hh = (s / (TW / V)) % TH,
                      dd = s / ((TW / V) * TH);
            float dv[RCO][V];
#pragma unroll
            for (int j = 0; j < RCO; ++j) {
                const float4* p = reinterpret_cast<const float4*>(
                    sdy + j * Gm::DYCS + (dd * TH + hh) * TW + sw * V);
                const float4 u = p[0], v = p[1];
                dv[j][0] = u.x, dv[j][1] = u.y, dv[j][2] = u.z,
                dv[j][3] = u.w;
                dv[j][4] = v.x, dv[j][5] = v.y, dv[j][6] = v.z,
                dv[j][7] = v.w;
            }
            const float* xr = sx + (dd * (TH + 2) + hh) * XS + sw * V;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b) {
                    const float4* p = reinterpret_cast<const float4*>(
                        xr + (a * (TH + 2) + b) * XS);
                    const float4 x0 = p[0], x1 = p[1], x2 = p[2];
                    const float xv[12] = {x0.x, x0.y, x0.z, x0.w,
                                          x1.x, x1.y, x1.z, x1.w,
                                          x2.x, x2.y, x2.z, x2.w};
#pragma unroll
                    for (int v = 0; v < V; ++v)
#pragma unroll
                        for (int c = 0; c < 3; ++c)
#pragma unroll
                            for (int j = 0; j < RCO; ++j)
                                acc[j][a * 9 + b * 3 + c] =
                                    fmaf(dv[j][v], xv[v + c],
                                         acc[j][a * 9 + b * 3 + c]);
                }
        }
        __syncthreads();  // the buffer is refilled next
    }
    float* out = part + ((long long)blockIdx.x * Gm::G + g) * Gm::J;
#pragma unroll
    for (int j = 0; j < RCO; ++j)
#pragma unroll
        for (int k = 0; k < 27; ++k)
            out[((co0 + j) * CI + ci) * 27 + k] = acc[j][k];
}

// dw[j] = the sum of part[s][j] over the slots s: 8 contiguous ranges of
// slots, each summed in order by one warp, then the 8 sums in order
__global__ void __launch_bounds__(32 * RED_WARPS)
    conv_wgrad_sum(const float* __restrict__ part, float* __restrict__ dw,
                   int slots, int J) {
    __shared__ float sums[RED_WARPS][32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int j = blockIdx.x * 32 + lane;
    const int lo = (int)((long long)slots * warp / RED_WARPS);
    const int hi = (int)((long long)slots * (warp + 1) / RED_WARPS);
    float s = 0.f;
    if (j < J)
        for (int k = lo; k < hi; ++k) s += part[(long long)k * J + j];
    sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && j < J) {
        float t = sums[0][lane];
#pragma unroll
        for (int w = 1; w < RED_WARPS; ++w) t += sums[w][lane];
        dw[j] = t;
    }
}

template <int CI, int CO, int TD, int TH, int XB, int YB>
int launch_partials(const float* xp, const float* dy, float* part, int n,
                    int D, int H, int W, int ctas, cudaStream_t st) {
    using Gm = Geom<CI, CO, TD, TH>;
    auto kernel = conv_wgrad_partials<CI, CO, TD, TH, XB, YB>;
    // above 48 KB only when asked for; the attribute belongs to the
    // current device, so it is set on every call
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int td = (D + TD - 1) / TD, th = (H + TH - 1) / TH,
              tw = (W + TW - 1) / TW;
    kernel<<<ctas, THREADS, Gm::SMEM, st>>>(xp, dy, part, D, H, W, td, th,
                                             tw, (long long)n * td * th * tw);
    return (int)cudaGetLastError();
}

template <int CI, int CO, int TD, int TH>
int launch(const float* xp, const float* dy, float* part, float* dw, int n,
           int D, int H, int W, int ctas, cudaStream_t st) {
    using Gm = Geom<CI, CO, TD, TH>;
    // 8-byte copies of x where every row of xp starts on 8 bytes, 16-byte
    // copies of dy where every row of dy starts on 16
    const bool x8 = W % 2 == 0 && reinterpret_cast<uintptr_t>(xp) % 8 == 0;
    const bool y16 = W % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    int err = x8 ? (y16 ? launch_partials<CI, CO, TD, TH, 8, 16>(
                              xp, dy, part, n, D, H, W, ctas, st)
                        : launch_partials<CI, CO, TD, TH, 8, 4>(
                              xp, dy, part, n, D, H, W, ctas, st))
                 : (y16 ? launch_partials<CI, CO, TD, TH, 4, 16>(
                              xp, dy, part, n, D, H, W, ctas, st)
                        : launch_partials<CI, CO, TD, TH, 4, 4>(
                              xp, dy, part, n, D, H, W, ctas, st));
    if (err != 0) return err;
    conv_wgrad_sum<<<(Gm::J + 31) / 32, 32 * RED_WARPS, 0, st>>>(
        part, dw, ctas * Gm::G, Gm::J);
    return (int)cudaGetLastError();
}

// the instantiated (CI, CO): template arguments (TD, TH: a tile's extent
// along d and h)
#define PCC_WGRAD_SHAPES(X) \
    X(16, 16, 4, 2)         \
    X(32, 32, 2, 2)         \
    X(16, 1, 4, 4)

}  // namespace

extern "C" {

// xp [n, cin, D + 2, H + 2, W + 2], dy [n, cout, D, H, W], part
// [ctas * G, cout * cin * 27] scratch, dw [cout, cin, 3, 3, 3]; all f32,
// contiguous. ctas = min(tiles, CTAS) (pcc_conv_wgrad_geometry). Returns
// cudaGetLastError, or cudaErrorInvalidValue for a (cin, cout) that is not
// instantiated.
int pcc_conv_wgrad(const float* xp, const float* dy, float* part, float* dw,
                   int cin, int cout, int n, int D, int H, int W, int ctas,
                   void* stream) {
    if (n <= 0 || D <= 0 || H <= 0 || W <= 0 || ctas <= 0)
        return (int)cudaErrorInvalidValue;
#define PCC_WGRAD_LAUNCH(CI_, CO_, TD_, TH_)                               \
    if (cin == CI_ && cout == CO_)                                        \
        return launch<CI_, CO_, TD_, TH_>(xp, dy, part, dw, n, D, H, W,   \
                                          ctas, (cudaStream_t)stream);
    PCC_WGRAD_SHAPES(PCC_WGRAD_LAUNCH)
#undef PCC_WGRAD_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// geo[5] = {TD, TH, TW, G, CTAS} of (cin, cout): a tile's extent, the
// groups (partials) a CTA, the most CTAs; returns -1 for a shape that is
// not instantiated.
int pcc_conv_wgrad_geometry(int cin, int cout, int* geo) {
#define PCC_WGRAD_GEO(CI_, CO_, TD_, TH_)     \
    if (cin == CI_ && cout == CO_) {          \
        geo[0] = TD_;                         \
        geo[1] = TH_;                         \
        geo[2] = TW;                          \
        geo[3] = Geom<CI_, CO_, TD_, TH_>::G; \
        geo[4] = CTAS;                        \
        return 0;                             \
    }
    PCC_WGRAD_SHAPES(PCC_WGRAD_GEO)
#undef PCC_WGRAD_GEO
    return -1;
}

}  // extern "C"
