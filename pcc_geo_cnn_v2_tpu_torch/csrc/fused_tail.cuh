// Window body shared by K4a (fused_tail.cu) and K4b (fused_tail_slab.cu):
//
//   out = relu(conv2(relu(conv1(x) + b1)) + b2) [+ x]
//
// two 3x3x3 stride-1 SAME convolutions C -> C over a cube of S^3 voxels,
// channels last (x, out: [N, S, S, S, C]; w: [27, C, C] tap-major, tap order
// (dz, dy, dx) row-major over {-1, 0, 1}^3; b: [C] f32). Operands are of type
// T (float or __nv_bfloat16); products are accumulated in f32, the bias is
// added in f32, and the intermediate and the output are rounded to T (round
// to nearest even). The residual adds the T-rounded x in f32.
//
// What bounds the function on an H100 is operations (54 * C FLOP per element
// moved), so the design is about feeding the tensor cores:
//
//   1. Rolling window along D. A block owns a TH x TW tile of one batch
//      element and a depth range [d_lo, d_hi). It keeps a ring of three input
//      planes (2-voxel H/W halo) and a ring of three conv1 planes (1-voxel
//      halo) in shared memory. Each step loads ONE input plane t (cp.async,
//      16 bytes a thread, zero outside the volume), computes ONE conv1 plane
//      t-1 from input planes t-2..t and ONE output plane t-2 from conv1
//      planes t-3..t-1. Halo recompute is confined to H/W (180/128 on conv1
//      for an 8x16 tile) plus two conv1 planes per depth range; every input
//      voxel is read once along D. conv1 positions outside the volume are
//      ZERO (conv2's SAME padding pads the intermediate; relu(b1) is not 0).
//   2. Weights in shared memory. The [27*C, C] rows of the two convs are
//      streamed in stages of R rows through a ring of NBUF buffers with
//      cp.async, NBUF - 1 stages ahead of the one being used (across the end
//      of a conv), one __syncthreads per stage; where both convs fit (bf16,
//      C = 16) they are loaded once and stay.
//   3. The inner product is an implicit GEMM per tap on the tensor cores:
//      M = voxels of the plane being computed (m16 tiles over the flattened
//      plane, rows past its end clamped on read and masked on write),
//      N = C output channels, K = C input channels. Activations are
//      voxel-major with the C channels of a voxel contiguous and a padded
//      pitch, so a tap is a different row address per lane and fragment
//      loads fall on distinct banks; no im2col copy.
//      bf16: mma.sync.m16n8k16 (bf16 x bf16 -> f32) with ldmatrix operands,
//      the 27 * C / 16 instructions of a voxel accumulate into one f32
//      fragment.
//      f32: 3xTF32. Every operand is split in registers into hi (v rounded
//      to TF32's 10 mantissa bits) and lo (the exact remainder v - hi, cut to
//      TF32); a k-step of 8 channels is three mma.sync.m16n8k8 (lo*hi, hi*lo,
//      hi*hi) into a zeroed fragment, which is then added to the running sum
//      with an f32 add (round to nearest): the tensor core's own accumulator
//      truncates, so long sums are kept out of it. What is dropped (lo*lo and
//      the cut of lo) is below 2^-20 of a product; against an f32 FFMA
//      convolution the result differs by about 1e-6 of the largest value.
//      A single-pass TF32 product (3 decimal digits) is never taken.
//
// Order of a voxel's sum, whatever the tile, the block, the depth range, the
// batch index or the batch width: taps ascending (dz, dy, dx), within a tap
// chunks of 16 (bf16) or 8 (f32) input channels ascending, one mma (bf16) or
// one mma triple plus one f32 add (f32) per chunk; inside an instruction the
// order is the hardware's and the same for every row of a fragment. Results
// are deterministic, independent of the batch, and K4b equals K4a bit for
// bit.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// internal linkage: both kernel libraries instantiate these templates
namespace fused_tail {
namespace {

constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void zero16(uint32_t dst) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n"
                 :: "r"(dst), "r"(0) : "memory");
}

// Per-type fragment operations. A lane addresses NROW rows of an m16 tile
// (lane_rows) at element lane_k of a k-step; its B address in a weight stage
// is row lane_b_row, column lane_b_col of the k-step's [KK, C] rows.
template <typename T> struct Ops;

template <> struct Ops<__nv_bfloat16> {
    static constexpr int KK = 16, PAD = 8, NROW = 1, AREGS = 4, BREGS = 2;
    static __device__ __forceinline__ void lane_rows(int lane, int (&r)[1]) {
        r[0] = lane & 15;
    }
    static __device__ __forceinline__ int lane_k(int lane) {
        return (lane >> 4) * 8;
    }
    static __device__ __forceinline__ int lane_b_row(int lane) {
        return lane & 15;
    }
    static __device__ __forceinline__ int lane_b_col(int lane) {
        return (lane >> 4) * 8;
    }
    static __device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                                  const uint32_t (&addr)[1]) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr[0]));
    }
    // B fragments of NT8 n8-tiles of one k-step; `pitch` is the row pitch in
    // bytes (unused here: ldmatrix takes the lane's row address)
    template <int NT8>
    static __device__ __forceinline__ void load_b(uint32_t (&b)[NT8][2],
                                                  uint32_t addr, int) {
        static_assert(NT8 % 2 == 0, "ldmatrix.x4 loads two n8-tiles");
#pragma unroll
        for (int j = 0; j < NT8 / 2; ++j)
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                "{%0, %1, %2, %3}, [%4];\n"
                : "=r"(b[2 * j][0]), "=r"(b[2 * j][1]), "=r"(b[2 * j + 1][0]),
                  "=r"(b[2 * j + 1][1])
                : "r"(addr + j * 32));
    }
    static __device__ __forceinline__ void mma(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
    static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    // two consecutive channels, rounded to T
    static __device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                                  float v1) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(v0);
        v.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(p) = v;
    }
};

template <> struct Ops<float> {
    // A: hi[4] then lo[4]; B: hi[2] then lo[2]
    static constexpr int KK = 8, PAD = 4, NROW = 2, AREGS = 8, BREGS = 4;
    static __device__ __forceinline__ void lane_rows(int lane, int (&r)[2]) {
        r[0] = lane >> 2;
        r[1] = (lane >> 2) + 8;
    }
    static __device__ __forceinline__ int lane_k(int lane) { return lane & 3; }
    static __device__ __forceinline__ int lane_b_row(int lane) {
        return lane & 3;
    }
    static __device__ __forceinline__ int lane_b_col(int lane) {
        return lane >> 2;
    }
    // v = hi + lo + (less than 2^-21 |v|): hi is v rounded to TF32's 10
    // mantissa bits (half away from zero, on the bits), lo the exact
    // remainder cut to TF32; both have the 13 low bits clear
    static __device__ __forceinline__ void split(float v, uint32_t& hi,
                                                 uint32_t& lo) {
        hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
        lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
    }
    static __device__ __forceinline__ float lds(uint32_t addr) {
        float v;
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
        return v;
    }
    static __device__ __forceinline__ void load_a(uint32_t (&a)[8],
                                                  const uint32_t (&addr)[2]) {
        // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        split(lds(addr[0]), a[0], a[4]);
        split(lds(addr[1]), a[1], a[5]);
        split(lds(addr[0] + 16), a[2], a[6]);
        split(lds(addr[1] + 16), a[3], a[7]);
    }
    template <int NT8>
    static __device__ __forceinline__ void load_b(uint32_t (&b)[NT8][4],
                                                  uint32_t addr, int pitch) {
#pragma unroll
        for (int j = 0; j < NT8; ++j) {  // b0 (k t, n g), b1 (k t + 4, n g)
            split(lds(addr + j * 32), b[j][0], b[j][2]);
            split(lds(addr + j * 32 + 4 * pitch), b[j][1], b[j][3]);
        }
    }
    static __device__ __forceinline__ void mma1(float (&c)[4], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint32_t b0,
                                                uint32_t b1) {
        asm(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    static __device__ __forceinline__ void mma(float (&c)[4],
                                               const uint32_t (&a)[8],
                                               const uint32_t (&b)[4]) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma1(t, a[4], a[5], a[6], a[7], b[0], b[1]);  // lo * hi
        mma1(t, a[0], a[1], a[2], a[3], b[2], b[3]);  // hi * lo
        mma1(t, a[0], a[1], a[2], a[3], b[0], b[1]);  // hi * hi
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], t[i]);
    }
    static __device__ __forceinline__ float to_f(float v) { return v; }
    static __device__ __forceinline__ void store2(float* p, float v0,
                                                  float v1) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    }
};

// Tile shape per type and channel count: the H x W tile, the warp grid (WM
// warps over the m16 tiles of a plane, WN over the output channels) and the
// weight rows per stage with the number of stage buffers (R = 27 * C: both
// convs stay resident, one buffer each). Every choice gives the same bits.
// ops/fused_conv.py mirrors TH, TW and the blocks per SM for its launch
// plan (pcc_fused_tail_geometry reports them).
template <typename T, int C> struct Geom;
template <> struct Geom<__nv_bfloat16, 16> {
    static constexpr int TH = 8, TW = 16, WM = 4, WN = 1, R = 432, NBUF = 2;
};
template <> struct Geom<__nv_bfloat16, 32> {
    static constexpr int TH = 8, TW = 16, WM = 4, WN = 2, R = 48, NBUF = 2;
};
template <> struct Geom<__nv_bfloat16, 64> {
    static constexpr int TH = 8, TW = 16, WM = 4, WN = 2, R = 96, NBUF = 2;
};
template <> struct Geom<float, 16> {
    static constexpr int TH = 16, TW = 16, WM = 8, WN = 1, R = 144, NBUF = 2;
};
template <> struct Geom<float, 32> {
    static constexpr int TH = 8, TW = 16, WM = 8, WN = 1, R = 96, NBUF = 2;
};
template <> struct Geom<float, 64> {
    static constexpr int TH = 8, TW = 8, WM = 4, WN = 2, R = 32, NBUF = 3;
};

template <typename T, int C> struct Tile : Geom<T, C> {
    using G = Geom<T, C>;
    using O = Ops<T>;
    static constexpr int ES = (int)sizeof(T);
    static constexpr int AP = C + O::PAD, WP = C + 8;  // pitches, elements
    static constexpr int IH = G::TH + 4, IW = G::TW + 4, IV = IH * IW;
    static constexpr int MH = G::TH + 2, MW = G::TW + 2, MV = MH * MW;
    static constexpr int OV = G::TH * G::TW;
    static constexpr int NT = 32 * G::WM * G::WN;
    static constexpr int M1 = (MV + 15) / 16, M2 = (OV + 15) / 16;
    static constexpr int MT1 = (M1 + G::WM - 1) / G::WM;
    static constexpr int MT2 = (M2 + G::WM - 1) / G::WM;
    static constexpr int NT8 = C / 8 / G::WN;
    static constexpr int ROWS = 27 * C, NSTAGE = ROWS / G::R;
    static constexpr bool RESIDENT = G::R == ROWS;
    static constexpr int IN_BYTES = IV * AP * ES, MID_BYTES = MV * AP * ES;
    static constexpr int W_BYTES = G::R * WP * ES;
    static constexpr int SMEM_BYTES = 3 * IN_BYTES + 3 * MID_BYTES
                                      + G::NBUF * W_BYTES;
    static constexpr int BLOCKS_PER_SM =
        (SMEM_LIMIT + 1024) / (SMEM_BYTES + 1024);
    static_assert(SMEM_BYTES <= SMEM_LIMIT, "tile exceeds shared memory");
    static_assert(G::NBUF >= 2 && (!RESIDENT || G::NBUF == 2), "buffers");
    static_assert(ROWS % G::R == 0 && G::R % O::KK == 0 && C % O::KK == 0,
                  "a stage is whole k-steps, a k-step lies in one tap");
    static_assert((AP * ES) % 16 == 0 && (WP * ES) % 16 == 0
                  && (C * ES) % 16 == 0, "16-byte rows");
    static_assert(C % (8 * G::WN) == 0, "n8-tiles per warp");
};

// acc[mt][nt] += rows [r0, r0 + R) of the flattened [27 * C, C] weights
// (staged at `wlane`, the lane's B address) times the source planes: the
// ring of three planes at `ring` (plane bytes PB, slot of the dz = -1 plane
// `slot0`), rows of width SW voxels, lane row offsets `ro` (bytes).
template <typename T, int C, int MT, int M, int SW, int PB>
__device__ __forceinline__ void conv_rows(
        float (&acc)[MT][Tile<T, C>::NT8][4], uint32_t ring, int slot0,
        const uint32_t (&ro)[MT][Ops<T>::NROW], uint32_t wlane, int r0,
        int warp_m) {
    using G = Tile<T, C>;
    using O = Ops<T>;
    constexpr int KSTEPS = G::R / O::KK;
    constexpr int UNROLL = KSTEPS <= 8 ? KSTEPS : (KSTEPS % 6 == 0 ? 6 : 3);
#pragma unroll UNROLL
    for (int kk = 0; kk < KSTEPS; ++kk) {
        const int r = r0 + kk * O::KK;
        const int tap = r / C, ci0 = r % C;
        const int tz = tap / 9, ty = (tap - 9 * tz) / 3, tx = tap % 3;
        int slot = slot0 + tz;
        slot -= slot >= 3 ? 3 : 0;
        const uint32_t src = ring + slot * PB
            + ((ty * SW + tx) * G::AP + ci0) * G::ES;
        uint32_t b[G::NT8][O::BREGS];
        O::template load_b<G::NT8>(b, wlane + kk * O::KK * G::WP * G::ES,
                                   G::WP * G::ES);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            if (warp_m + mt * G::WM >= M) continue;  // uniform per warp
            uint32_t a[O::AREGS], addr[O::NROW];
#pragma unroll
            for (int q = 0; q < O::NROW; ++q) addr[q] = src + ro[mt][q];
            O::load_a(a, addr);
#pragma unroll
            for (int nt = 0; nt < G::NT8; ++nt) O::mma(acc[mt][nt], a, b[nt]);
        }
    }
}

// The window of one block: the TH x TW tile at (h0, w0) of batch element n,
// output planes [d_lo, d_hi); see the file header. Every thread of the block
// must call it; `smem` holds Tile<T, C>::SMEM_BYTES, 16-byte aligned.
template <typename T, int C>
__device__ void tail_window(const T* __restrict__ x,
                            const T* __restrict__ w1,
                            const float* __restrict__ b1,
                            const T* __restrict__ w2,
                            const float* __restrict__ b2, T* __restrict__ out,
                            int n, int S, int h0, int w0, int d_lo, int d_hi,
                            bool residual, unsigned char* smem) {
    using G = Tile<T, C>;
    using O = Ops<T>;
    constexpr int ES = G::ES, NT = G::NT, CH = C * ES / 16;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int warp_m = warp % G::WM, warp_n = warp / G::WM;
    const int n0 = warp_n * G::NT8 * 8;  // first output channel of the warp
    const uint32_t in_s = smem_addr(smem);
    const uint32_t mid_s = in_s + 3 * G::IN_BYTES;
    const uint32_t w_s = mid_s + 3 * G::MID_BYTES;
    T* const in_p = reinterpret_cast<T*>(smem);
    T* const mid_p = reinterpret_cast<T*>(smem + 3 * G::IN_BYTES);

    // the lane's row offsets in the source plane of each conv (bytes);
    // rows past the plane's end read its last voxel and are never written
    uint32_t ro1[G::MT1][O::NROW], ro2[G::MT2][O::NROW];
    {
        int lr[O::NROW];
        O::lane_rows(lane, lr);
#pragma unroll
        for (int q = 0; q < O::NROW; ++q) {
#pragma unroll
            for (int mt = 0; mt < G::MT1; ++mt) {
                const int m = min((warp_m + mt * G::WM) * 16 + lr[q],
                                  G::MV - 1);
                ro1[mt][q] = (((m / G::MW) * G::IW + m % G::MW) * G::AP
                              + O::lane_k(lane)) * ES;
            }
#pragma unroll
            for (int mt = 0; mt < G::MT2; ++mt) {
                const int o = min((warp_m + mt * G::WM) * 16 + lr[q],
                                  G::OV - 1);
                ro2[mt][q] = (((o / G::TW) * G::MW + o % G::TW) * G::AP
                              + O::lane_k(lane)) * ES;
            }
        }
    }
    const uint32_t wlane = (O::lane_b_row(lane) * G::WP + O::lane_b_col(lane)
                            + n0) * ES;  // the lane's B position in a stage

    auto slot_of = [](int p) { return (p + 3) % 3; };  // p >= -2

    // rows [s * R, (s + 1) * R) of a conv's weights into stage buffer `buf`
    auto stage = [&](const T* w, int s, int buf) {
        const char* src = reinterpret_cast<const char*>(
            w + (size_t)s * G::R * C);
        const uint32_t dst = w_s + buf * G::W_BYTES;
        for (int idx = tid; idx < G::R * CH; idx += NT) {
            const int row = idx / CH, ch = idx % CH;
            cp_async16(dst + row * G::WP * ES + ch * 16,
                       src + (size_t)row * C * ES + ch * 16);
        }
    };

    // input plane p with its 2-voxel H/W halo, zero outside the volume
    auto load_plane = [&](int p) {
        const uint32_t dst = in_s + slot_of(p) * G::IN_BYTES;
        const bool pin = (unsigned)p < (unsigned)S;
        for (int idx = tid; idx < G::IV * CH; idx += NT) {
            const int v = idx / CH, ch = idx % CH;
            const int gy = h0 - 2 + v / G::IW, gx = w0 - 2 + v % G::IW;
            const uint32_t a = dst + v * G::AP * ES + ch * 16;
            if (pin && (unsigned)gy < (unsigned)S && (unsigned)gx < (unsigned)S)
                cp_async16(a, reinterpret_cast<const char*>(
                    x + ((((size_t)n * S + p) * S + gy) * S + gx) * C)
                    + ch * 16);
            else
                zero16(a);
        }
    };

    // The block runs the phases conv1(t), conv2(t) for t = d_lo .. d_hi + 1
    // where they exist. Their weight stages form one sequence, consumed in
    // order from a ring of NBUF buffers; the prefetch cursor (it, iw, is) runs
    // NBUF - 1 stages ahead, across phase ends, one commit group per stage.
    auto do1 = [&](int t) { return (unsigned)(t - 1) < (unsigned)S; };
    auto do2 = [&](int t) { return t - 2 >= d_lo; };
    auto next_phase = [&](int& t, int& which) {  // which: 0 conv1, 1 conv2
        for (;;) {
            if (which == 0) {
                which = 1;
            } else {
                which = 0;
                ++t;
            }
            if (t > d_hi + 1) {
                which = -1;  // past the last phase
                return;
            }
            if (which == 0 ? do1(t) : do2(t)) return;
        }
    };
    int it = d_lo - 1, iw = 1, is = 0, ibuf = 0, cbuf = 0;
    auto prefetch_next = [&]() {
        if (iw >= 0) {
            stage(iw == 0 ? w1 : w2, is, ibuf);
            ibuf = ibuf + 1 == G::NBUF ? 0 : ibuf + 1;
            if (++is == G::NSTAGE) {
                is = 0;
                next_phase(it, iw);
            }
        }
        cp_async_commit();
    };
    if constexpr (G::RESIDENT) {
        stage(w1, 0, 0);
        stage(w2, 0, 1);
        cp_async_commit();
    } else {
        next_phase(it, iw);
        for (int i = 0; i < G::NBUF - 1; ++i) prefetch_next();
    }

    // one conv over the plane: acc += all 27 * C weight rows of conv `which`
#define PCC_TAIL_CONV(acc, MT, M, SW, PB, ring, slot0, ro, which)             \
    if constexpr (G::RESIDENT) {                                              \
        conv_rows<T, C, MT, M, SW, PB>(acc, ring, slot0, ro,                  \
                                       w_s + (which) * G::W_BYTES + wlane, 0, \
                                       warp_m);                               \
    } else {                                                                  \
        for (int s = 0; s < G::NSTAGE; ++s) {                                 \
            cp_async_wait_group<G::NBUF - 2>();  /* this stage has landed */  \
            __syncthreads();  /* ... for all; the oldest buffer is free */    \
            prefetch_next();                                                     \
            conv_rows<T, C, MT, M, SW, PB>(                                   \
                acc, ring, slot0, ro, w_s + cbuf * G::W_BYTES + wlane,        \
                s * G::R, warp_m);                                            \
            cbuf = cbuf + 1 == G::NBUF ? 0 : cbuf + 1;                        \
        }                                                                     \
    }

    load_plane(d_lo - 2);
    load_plane(d_lo - 1);
    const int g = lane >> 2, tq = lane & 3;
    for (int t = d_lo; t <= d_hi + 1; ++t) {
        load_plane(t);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();  // planes t-2 .. t are staged

        // conv1 -> intermediate plane t - 1 (1-voxel H/W halo)
        T* const mid = mid_p + (size_t)slot_of(t - 1) * G::MV * G::AP;
        if (do1(t)) {
            float acc[G::MT1][G::NT8][4];
#pragma unroll
            for (int mt = 0; mt < G::MT1; ++mt)
#pragma unroll
                for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
            PCC_TAIL_CONV(acc, G::MT1, G::M1, G::IW, G::IN_BYTES, in_s,
                          slot_of(t - 2), ro1, 0)
#pragma unroll
            for (int mt = 0; mt < G::MT1; ++mt) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int m = (warp_m + mt * G::WM) * 16 + g + 8 * hf;
                    if (m >= G::MV) continue;
                    const int gy = h0 - 1 + m / G::MW;
                    const int gx = w0 - 1 + m % G::MW;
                    const bool inside = (unsigned)gy < (unsigned)S
                                        && (unsigned)gx < (unsigned)S;
#pragma unroll
                    for (int nt = 0; nt < G::NT8; ++nt) {
                        const int co = n0 + nt * 8 + 2 * tq;
                        const float v0 = inside ? fmaxf(
                            acc[mt][nt][2 * hf] + __ldg(b1 + co), 0.0f) : 0.0f;
                        const float v1 = inside ? fmaxf(
                            acc[mt][nt][2 * hf + 1] + __ldg(b1 + co + 1),
                            0.0f) : 0.0f;
                        O::store2(mid + m * G::AP + co, v0, v1);
                    }
                }
            }
        } else {  // a plane outside the volume: conv2's zero padding
            const uint32_t dst = mid_s + slot_of(t - 1) * G::MID_BYTES;
            for (int idx = tid; idx < G::MV * CH; idx += NT)
                zero16(dst + (idx / CH) * G::AP * ES + (idx % CH) * 16);
        }
        __syncthreads();  // intermediate plane t - 1 is written

        // conv2 -> output plane t - 2
        if (do2(t)) {
            const int z = t - 2;
            float acc[G::MT2][G::NT8][4];
#pragma unroll
            for (int mt = 0; mt < G::MT2; ++mt)
#pragma unroll
                for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
            PCC_TAIL_CONV(acc, G::MT2, G::M2, G::MW, G::MID_BYTES, mid_s,
                          slot_of(t - 3), ro2, 1)
            const T* const xin = in_p + (size_t)slot_of(z) * G::IV * G::AP;
#pragma unroll
            for (int mt = 0; mt < G::MT2; ++mt) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int o = (warp_m + mt * G::WM) * 16 + g + 8 * hf;
                    if (o >= G::OV) continue;
                    const int oy = o / G::TW, ox = o % G::TW;
                    const int gy = h0 + oy, gx = w0 + ox;
                    if (gy >= S || gx >= S) continue;
                    const T* const xr = xin
                        + ((oy + 2) * G::IW + ox + 2) * G::AP;
                    T* const dst = out
                        + ((((size_t)n * S + z) * S + gy) * S + gx) * C;
#pragma unroll
                    for (int nt = 0; nt < G::NT8; ++nt) {
                        const int co = n0 + nt * 8 + 2 * tq;
                        float v0 = fmaxf(acc[mt][nt][2 * hf]
                                         + __ldg(b2 + co), 0.0f);
                        float v1 = fmaxf(acc[mt][nt][2 * hf + 1]
                                         + __ldg(b2 + co + 1), 0.0f);
                        if (residual) {
                            v0 += O::to_f(xr[co]);
                            v1 += O::to_f(xr[co + 1]);
                        }
                        O::store2(dst + co, v0, v1);
                    }
                }
            }
        }
        __syncthreads();  // plane t - 2 and intermediate t - 3 are free
    }
#undef PCC_TAIL_CONV
    cp_async_wait_all();
}

// The body of both kernels: grid (H x W tiles * depth ranges, n); depth
// range k of `dchunk` planes, the last one possibly shorter.
template <typename T, int C>
__device__ __forceinline__ void window_block(
        const T* __restrict__ x, const T* __restrict__ w1,
        const float* __restrict__ b1, const T* __restrict__ w2,
        const float* __restrict__ b2, T* __restrict__ out, int S, int dchunk,
        int residual) {
    using G = Tile<T, C>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int nth = (S + G::TH - 1) / G::TH, ntw = (S + G::TW - 1) / G::TW;
    const int tile = blockIdx.x % (nth * ntw), k = blockIdx.x / (nth * ntw);
    const int d_lo = k * dchunk, d_hi = min(d_lo + dchunk, S);
    tail_window<T, C>(x, w1, b1, w2, b2, out, blockIdx.y, S,
                      (tile / ntw) * G::TH, (tile % ntw) * G::TW, d_lo, d_hi,
                      residual != 0, smem);
}

// Each library names its own __global__ entry (a one-line call of
// window_block) and hands it over as K::get<T, C>().
template <typename K, typename T, int C>
int launch_window(const void* x, const void* w1, const float* b1,
                  const void* w2, const float* b2, void* out, int n, int S,
                  int dchunk, int residual, cudaStream_t st) {
    using G = Tile<T, C>;
    if (dchunk <= 0) return -2;
    auto kernel = K::template get<T, C>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int nth = (S + G::TH - 1) / G::TH, ntw = (S + G::TW - 1) / G::TW;
    const int nk = (S + dchunk - 1) / dchunk;
    kernel<<<dim3(nth * ntw * nk, n), G::NT, G::SMEM_BYTES, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1,
        static_cast<const T*>(w2), b2, static_cast<T*>(out), S, dchunk,
        residual);
    return (int)cudaGetLastError();
}

// Dispatch over (dtype, C); -1 for a channel count the kernels lack.
template <typename K>
int launch_any(const void* x, const void* w1, const float* b1,
               const void* w2, const float* b2, void* out, int n, int S,
               int C, int dchunk, int residual, int bf16, cudaStream_t st) {
#define PCC_TAIL(T, CC)                                                    \
    launch_window<K, T, CC>(x, w1, b1, w2, b2, out, n, S, dchunk, residual, \
                            st)
    if (bf16) {
        if (C == 16) return PCC_TAIL(__nv_bfloat16, 16);
        if (C == 32) return PCC_TAIL(__nv_bfloat16, 32);
        if (C == 64) return PCC_TAIL(__nv_bfloat16, 64);
    } else {
        if (C == 16) return PCC_TAIL(float, 16);
        if (C == 32) return PCC_TAIL(float, 32);
        if (C == 64) return PCC_TAIL(float, 64);
    }
#undef PCC_TAIL
    return -1;
}

// geo = {TH, TW, blocks per SM by shared memory}; -1 as above
inline int geometry_any(int C, int bf16, int* geo) {
#define PCC_GEO(T, CC)                                              \
    do {                                                            \
        using G = Tile<T, CC>;                                      \
        geo[0] = G::TH; geo[1] = G::TW; geo[2] = G::BLOCKS_PER_SM; \
        return 0;                                                   \
    } while (0)
    if (bf16) {
        if (C == 16) PCC_GEO(__nv_bfloat16, 16);
        if (C == 32) PCC_GEO(__nv_bfloat16, 32);
        if (C == 64) PCC_GEO(__nv_bfloat16, 64);
    } else {
        if (C == 16) PCC_GEO(float, 16);
        if (C == 32) PCC_GEO(float, 32);
        if (C == 64) PCC_GEO(float, 64);
    }
#undef PCC_GEO
    return -1;
}

}  // namespace
}  // namespace fused_tail
