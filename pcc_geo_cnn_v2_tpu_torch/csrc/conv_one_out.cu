// conv_one_out: a SAME-padded transposed 3D convolution (flax
// `nn.ConvTranspose`, i.e. `lax.conv_transpose` with the un-flipped kernel)
// into ONE output channel, f32 operands and f32 FFMA accumulation.
//
// Replaces no Pallas TPU kernel: the JAX package leaves these layers to
// XLA. It was added for the synthesis transforms' last layer (c1 / c2:
// k9, stride 2, 32 -> 1 at 32^3 -> 64^3; c3 / c3p: k3, stride 1, 16 -> 1 at
// 64^3), which cuDNN runs as an implicit GEMM with N = Cout = 1: one column
// of a 32-wide tile, 0.5 TFLOP/s on an H100.
//
// What it computes (transforms.subpixel_conv_transpose, the same products):
// per axis, output j = S*i + r (r the parity class) reads input i + d for
// d in [DMIN, DMAX] through kernel tap m = S*d + PAD_A - r when 0 <= m < K,
//
//   y[n, 0, j] = bias + sum_c sum_{dd, dh, dw} w[0, c, m_d, m_h, m_w] *
//                x[n, c, i_d + d_d + shift_d, i_h + d_h, i_w + d_w],
//
// inputs outside x being zero. `shift_d` is the number of planes x holds
// before the global input's first (a depth slab extended by its halo,
// parallel/spatial.py; 0 otherwise).
//
// Bound: at stride 2 operations (2 * 32 * 9^3 FLOP an input voxel against
// 32 input and 8 output floats: 1.53 GFLOP and 5.3 MB a 32^3 block, 22.8 us
// at the f32 peak); at k3 stride 1, 16 -> 1, bytes (226 MFLOP and 17.8 MB a
// 64^3 block: 5.3 us at HBM speed, 3.4 us of FFMA). Design:
//   - A CTA owns a tile of TD x 8 x TW input positions of one batch element
//     and ALL S^3 parity classes of their outputs, so one launch writes the
//     interleaved [N, 1, S*D, S*H, S*W] result directly.
//   - Input channels are staged CCH at a time, tile plus halo, by one TMA
//     box copy (the tensor map's out-of-bounds zero fill is the SAME
//     padding; no thread computes a load address), double-buffered on two
//     mbarriers. A box's start along w must lie on a 16-byte boundary (an
//     unaligned one, w0 - 2, faulted as an illegal instruction on an H100),
//     so the tile starts 4 columns before w0. The cp.async version that
//     computed every element's address took 2.5x as long at k3 (26.0
//     against 10.6 us a block) and 1.2x at k9. Beside the box, a bulk copy
//     of the same channels' weights,
//     packed on the host in the order the inner loop reads them (table
//     [CIN][NT][NT][S][S][GW]: one group of NT*S taps along w for each
//     (d_d, d_h, r_d, r_h), zero-padded to GW, a multiple of 4; see
//     ops/conv_one_out.py).
//   - A thread keeps V = 8 consecutive input positions along w and all S^3
//     classes in registers (64 accumulators at stride 2): a row of V + NT -
//     1 inputs (four 128-bit loads) serves every (d_w, r_w) tap, a group
//     of weights (128-bit broadcast loads) serves V outputs.
//   - Bank conflicts: a quarter warp reads 4 row segments along w (every
//     other 16-byte group) on 2 rows whose stride is an odd number of
//     16-byte groups, so its eight 16-byte reads fall in distinct banks.
// Each output is summed in one fixed order — input channel, then d_d, d_h,
// d_w — by one thread, with no atomics and no split of the reduction: the
// result does not depend on the batch width or on a block's place in it.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time (no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 8;    // input positions along w a thread
constexpr int TH = 8;   // input rows a CTA (lane bits 2..4)

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }

template <int K, int S, int CIN, int TD, int TW, int CCH, int MINB>
struct Geom {
    // lax.conv_transpose SAME pads (transforms.transpose_pads)
    static constexpr int PAD_A =
        S > K - 1 ? K - 1 : (K + S - 2 + 1) / 2;
    static constexpr int PAD_B = K + S - 2 - PAD_A;
    static constexpr int DMIN = -(PAD_A / S);
    static constexpr int DMAX = PAD_B / S;
    static constexpr int NT = DMAX - DMIN + 1;        // input offsets an axis
    static constexpr int GW = round_up(NT * S, 4);    // weights a group
    static constexpr int WPC = NT * NT * S * S * GW;  // weights a channel
    static constexpr int NTW = TW / V;                // threads along w
    static constexpr int THREADS = 32 * (NTW / 4) * TD;
    static constexpr int TDX = TD + NT - 1;           // tile with its halo
    static constexpr int THX = TH + NT - 1;
    // a TMA box starts on a 16-byte boundary along w: the tile's columns
    // start 4 before w0, so a thread's first input (w0 + tw * V + DMIN) is
    // column tw * V + OFF; it reads RWL columns from tw * V (16 B aligned)
    static constexpr int OFF = 4 + DMIN;
    static constexpr int RWL = round_up(OFF + V + NT - 1, 4);
    static constexpr int XW = OFF + TW + NT - 1;      // columns read
    static constexpr int RW0 = TW - V + RWL > XW ? TW - V + RWL : XW;
    static constexpr int RWS = RW0 % 8 <= 4 ? RW0 - RW0 % 8 + 4
                                            : RW0 - RW0 % 8 + 12;
    static constexpr int PLANE = THX * RWS;
    static constexpr int CH_ELEMS = TDX * PLANE;
    static constexpr int BOX_BYTES = CCH * CH_ELEMS * 4;  // one TMA box
    static constexpr int W_BYTES = CCH * WPC * 4;         // its weights
    // floats a stage, a multiple of 128 bytes (a TMA destination)
    static constexpr int STAGE = round_up(CCH * (CH_ELEMS + WPC), 32);
    static constexpr int SMEM = 2 * STAGE * 4 + 16;  // + two mbarriers
    static constexpr int NCH = CIN / CCH;
    static constexpr int CCH_ = CCH;
    static_assert(TW % (4 * V) == 0, "a warp spans 4 segments along w");
    static_assert(OFF >= 0, "the low halo along w fits in 4 columns");
    static_assert(CIN % CCH == 0, "channels stage in whole chunks");
    static_assert(RWS % 8 == 4, "row stride: an odd number of 16 B groups");
    static_assert(CH_ELEMS % 4 == 0 && WPC % 4 == 0, "16 B alignment");
    static_assert(SMEM * MINB + MINB * 1024 <= 232448,
                  "MINB blocks an SM must fit in shared memory");
};

// kernel tap of input offset index `dd` (d = dd + DMIN) for parity r; -1
// where no tap meets it
template <int K, int S, int PAD_A, int DMIN>
__host__ __device__ constexpr int tap(int r, int dd) {
    return S * (dd + DMIN) + PAD_A - r >= 0 && S * (dd + DMIN) + PAD_A - r < K
               ? S * (dd + DMIN) + PAD_A - r
               : -1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// box (w, h, d, channel row) of the tensor map at those coordinates;
// zeros where the box leaves the tensor
__device__ __forceinline__ void tma_box(uint32_t dst, uint64_t map,
                                        uint32_t bar, int w, int h, int d,
                                        int c) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(map), "r"(w), "r"(h), "r"(d), "r"(c), "r"(bar)
        : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int K, int S, int CIN, int TD, int TW, int CCH, int MINB>
__global__ void __launch_bounds__(
    (Geom<K, S, CIN, TD, TW, CCH, MINB>::THREADS), MINB)
conv_one_out_convolve(const __grid_constant__ CUtensorMap xmap,
                      const float* __restrict__ table,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int Do, int Ho, int Wo, int shift_d, int tiles_w,
                      int tiles_h) {
    using G = Geom<K, S, CIN, TD, TW, CCH, MINB>;
    constexpr int PAD_A = G::PAD_A, DMIN = G::DMIN, NT = G::NT, GW = G::GW;
    extern __shared__ __align__(128) float smem[];
    const uint32_t bars = smem_addr(smem + 2 * G::STAGE);
    // the tensor map in the kernel's parameter space, where TMA reads it
    const uint64_t map = reinterpret_cast<uint64_t>(&xmap);

    const int n = blockIdx.y;
    const int t_w = blockIdx.x % tiles_w;
    const int t_h = (blockIdx.x / tiles_w) % tiles_h;
    const int t_d = blockIdx.x / (tiles_w * tiles_h);
    const int w0 = t_w * TW, h0 = t_h * TH, d0 = t_d * TD;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tw = (lane & 3) + 4 * (warp % (G::NTW / 4));
    const int th = lane >> 2;
    const int td = warp / (G::NTW / 4);

    // thread 0 stages chunk q (CCH channels: the tile with its halo, and
    // their weights) into buffer q & 1 and arms that buffer's mbarrier
    auto load_chunk = [&](int q) {
        const uint32_t xs = smem_addr(smem + (q & 1) * G::STAGE);
        const uint32_t bar = bars + 8 * (q & 1);
        mbar_expect(bar, G::BOX_BYTES + G::W_BYTES);
        tma_box(xs, map, bar, w0 - 4, h0 + DMIN, d0 + DMIN + shift_d,
                n * CIN + q * CCH);
        bulk_copy(xs + 4 * CCH * G::CH_ELEMS, table + (size_t)q * G::WPC *
                  CCH, G::W_BYTES, bar);
    };

    float acc[S][S][S][V];
#pragma unroll
    for (int rd = 0; rd < S; ++rd)
#pragma unroll
        for (int rh = 0; rh < S; ++rh)
#pragma unroll
            for (int rw = 0; rw < S; ++rw)
#pragma unroll
                for (int v = 0; v < V; ++v) acc[rd][rh][rw][v] = 0.f;

    if (tid == 0) {
        mbar_init(bars);
        mbar_init(bars + 8);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        load_chunk(0);
        if (G::NCH > 1) load_chunk(1);
    }
#pragma unroll 1
    for (int q = 0; q < G::NCH; ++q) {
        // the buffer's (q >> 1)-th use completes that phase
        mbar_wait(bars + 8 * (q & 1), (q >> 1) & 1);
        const float* xs = smem + (q & 1) * G::STAGE + td * G::PLANE +
                          th * G::RWS + tw * V;
        const float* ws = smem + (q & 1) * G::STAGE + CCH * G::CH_ELEMS;
#pragma unroll 1
        for (int c = 0; c < CCH; ++c) {
#pragma unroll 1
            for (int dd = 0; dd < NT; ++dd) {
                const float* xr = xs + c * G::CH_ELEMS + dd * G::PLANE;
                const float* wr = ws + c * G::WPC + dd * NT * S * S * GW;
                bool dvalid[S];
#pragma unroll
                for (int rd = 0; rd < S; ++rd)
                    dvalid[rd] = tap<K, S, PAD_A, DMIN>(rd, dd) >= 0;
#pragma unroll
                for (int dh = 0; dh < NT; ++dh) {
                    float row[G::RWL];
#pragma unroll
                    for (int k4 = 0; k4 < G::RWL / 4; ++k4) {
                        const float4 t = *reinterpret_cast<const float4*>(
                            xr + dh * G::RWS + 4 * k4);
                        row[4 * k4] = t.x;
                        row[4 * k4 + 1] = t.y;
                        row[4 * k4 + 2] = t.z;
                        row[4 * k4 + 3] = t.w;
                    }
#pragma unroll
                    for (int rd = 0; rd < S; ++rd) {
                        if (!dvalid[rd]) continue;
#pragma unroll
                        for (int rh = 0; rh < S; ++rh) {
                            if (tap<K, S, PAD_A, DMIN>(rh, dh) < 0) continue;
                            float wv[GW];
                            const float* wg =
                                wr + ((dh * S + rd) * S + rh) * GW;
#pragma unroll
                            for (int k4 = 0; k4 < GW / 4; ++k4) {
                                const float4 t =
                                    *reinterpret_cast<const float4*>(
                                        wg + 4 * k4);
                                wv[4 * k4] = t.x;
                                wv[4 * k4 + 1] = t.y;
                                wv[4 * k4 + 2] = t.z;
                                wv[4 * k4 + 3] = t.w;
                            }
#pragma unroll
                            for (int dw = 0; dw < NT; ++dw)
#pragma unroll
                                for (int rw = 0; rw < S; ++rw) {
                                    if (tap<K, S, PAD_A, DMIN>(rw, dw) < 0)
                                        continue;
#pragma unroll
                                    for (int v = 0; v < V; ++v)
                                        acc[rd][rh][rw][v] = fmaf(
                                            wv[dw * S + rw],
                                            row[G::OFF + v + dw],
                                            acc[rd][rh][rw][v]);
                                }
                        }
                    }
                }
            }
        }
        __syncthreads();  // every thread is done reading this buffer
        if (tid == 0 && q + 2 < G::NCH) {
            // the copy engine's writes after the threads' reads
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_chunk(q + 2);
        }
    }

    const float b = bias != nullptr ? __ldg(bias) : 0.f;
    const int jw0 = S * (w0 + tw * V);
    const bool vec = (Wo & 3) == 0 && jw0 + S * V <= Wo;
#pragma unroll
    for (int rd = 0; rd < S; ++rd) {
        const int jd = S * (d0 + td) + rd;
#pragma unroll
        for (int rh = 0; rh < S; ++rh) {
            const int jh = S * (h0 + th) + rh;
            if (jd >= Do || jh >= Ho) continue;
            float out[S * V];
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
                for (int rw = 0; rw < S; ++rw)
                    out[v * S + rw] = acc[rd][rh][rw][v] + b;
            float* yr = y + (((size_t)n * Do + jd) * Ho + jh) * Wo + jw0;
            if (vec) {
#pragma unroll
                for (int k4 = 0; k4 < S * V / 4; ++k4)
                    *reinterpret_cast<float4*>(yr + 4 * k4) =
                        make_float4(out[4 * k4], out[4 * k4 + 1],
                                    out[4 * k4 + 2], out[4 * k4 + 3]);
            } else {
#pragma unroll
                for (int k = 0; k < S * V; ++k)
                    if (jw0 + k < Wo) yr[k] = out[k];
            }
        }
    }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// x [n, CIN, Dx, Hx, Wx] as a 4-d tensor map (w, h, d, n * CIN channel
// rows) whose box is a chunk's tile with its halo: (RWS, THX, TDX, CCH)
template <typename G>
int encode_map(CUtensorMap* map, const float* x, int n, int cin, int Dx,
               int Hx, int Wx) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (e != cudaSuccess) return (int)e;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return (int)cudaErrorNotSupported;
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[4] = {(cuuint64_t)Wx, (cuuint64_t)Hx,
                                (cuuint64_t)Dx, (cuuint64_t)cin * n};
    const cuuint64_t row = (cuuint64_t)Wx * 4;  // bytes
    const cuuint64_t strides[3] = {row, row * Hx, row * Hx * Dx};
    const cuuint32_t box[4] = {G::RWS, G::THX, G::TDX, G::CCH_};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<float*>(x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int K, int S, int CIN, int TD, int TW, int CCH, int MINB>
int launch(const float* x, const float* table, const float* bias, float* y,
           int n, int Dx, int Hx, int Wx, int Do, int Ho, int Wo,
           int shift_d, cudaStream_t st) {
    using G = Geom<K, S, CIN, TD, TW, CCH, MINB>;
    auto kernel = conv_one_out_convolve<K, S, CIN, TD, TW, CCH, MINB>;
    // the tensor map's row pitch and base must be multiples of 16 bytes
    if (Wx % 4 || reinterpret_cast<uintptr_t>(x) % 16)
        return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    int err = encode_map<G>(&map, x, n, CIN, Dx, Hx, Wx);
    if (err != 0) return err;
    // above 48 KB only when asked for; the attribute belongs to the
    // current device, so it is set on every call
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    // input positions an axis: output j = S * i + r
    const int ni_d = ceil_div(Do, S), ni_h = ceil_div(Ho, S),
              ni_w = ceil_div(Wo, S);
    const int tiles_w = ceil_div(ni_w, TW), tiles_h = ceil_div(ni_h, TH),
              tiles_d = ceil_div(ni_d, TD);
    const long long tiles = (long long)tiles_w * tiles_h * tiles_d;
    if (tiles > 0x7fffffff || n > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<dim3((unsigned)tiles, n), G::THREADS, G::SMEM, st>>>(
        map, table, bias, y, Do, Ho, Wo, shift_d, tiles_w, tiles_h);
    return (int)cudaGetLastError();
}

// the instantiated (K, S, CIN): template arguments, and the geometry the
// host packs the weight table for
#define PCC_ONE_OUT_SHAPES(X)        \
    X(9, 2, 32, 8, 32, 1, 2)         \
    X(3, 1, 16, 4, 64, 2, 3)

}  // namespace

extern "C" {

// x [n, cin, Dx, Hx, Wx], y [n, 1, Do, Ho, Wo], table [cin, WPC] (see the
// head of this file), bias [1] or null; all f32, contiguous. Returns
// cudaGetLastError, or cudaErrorInvalidValue for a (k, s, cin) that is not
// instantiated.
int pcc_conv_one_out(const float* x, const float* table, const float* bias,
                     float* y, int k, int s, int cin, int n, int Dx, int Hx,
                     int Wx, int Do, int Ho, int Wo, int shift_d,
                     void* stream) {
    if (n <= 0 || Do <= 0 || Ho <= 0 || Wo <= 0)
        return (int)cudaGetLastError();
#define PCC_ONE_OUT_LAUNCH(K_, S_, C_, TD_, TW_, CCH_, MINB_)                 \
    if (k == K_ && s == S_ && cin == C_)                                     \
        return launch<K_, S_, C_, TD_, TW_, CCH_, MINB_>(                    \
            x, table, bias, y, n, Dx, Hx, Wx, Do, Ho, Wo, shift_d,           \
            (cudaStream_t)stream);
    PCC_ONE_OUT_SHAPES(PCC_ONE_OUT_LAUNCH)
#undef PCC_ONE_OUT_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// geo[4] = {DMIN, NT, GW, WPC} of the weight table for (k, s, cin);
// returns -1 for a shape that is not instantiated.
int pcc_conv_one_out_geometry(int k, int s, int cin, int* geo) {
#define PCC_ONE_OUT_GEO(K_, S_, C_, TD_, TW_, CCH_, MINB_)                    \
    if (k == K_ && s == S_ && cin == C_) {                                   \
        using G = Geom<K_, S_, C_, TD_, TW_, CCH_, MINB_>;                   \
        geo[0] = G::DMIN;                                                    \
        geo[1] = G::NT;                                                      \
        geo[2] = G::GW;                                                      \
        geo[3] = G::WPC;                                                     \
        return 0;                                                            \
    }
    PCC_ONE_OUT_SHAPES(PCC_ONE_OUT_GEO)
#undef PCC_ONE_OUT_GEO
    return -1;
}

}  // extern "C"
