// Tile body shared by K4a (fused_tail.cu) and K4b (fused_tail_slab.cu):
//
//   out = relu(conv2(relu(conv1(x) + b1)) + b2) [+ x]
//
// two 3x3x3 stride-1 SAME convolutions C -> C over a cube of S^3 voxels,
// channels last (x, out: [N, S, S, S, C]; w: [27, C, C] tap-major, tap order
// (dz, dy, dx) row-major over {-1, 0, 1}^3; b: [C] f32). Operands are of type
// T (float or __nv_bfloat16); every product is accumulated in f32, the bias
// is added in f32, and the intermediate and the output are rounded to T
// (round to nearest even). The residual adds the T-rounded x in f32.
//
// One call of tail_tile computes one output tile of TD x TH x TW voxels, all
// C channels:
//   1. the input tile with a 2-voxel halo is staged in shared memory,
//      channel-major ([C][voxel], odd channel stride), zero outside the
//      volume;
//   2. conv1 is computed on the tile with a 1-voxel halo and kept in shared
//      memory, rounded to T. Positions outside the volume are set to ZERO
//      (conv2's SAME padding pads the intermediate, and relu(b1) is not 0);
//   3. conv2 + bias + ReLU (+ the residual, read back from the staged input)
//      is written to global memory.
// A work item is V voxels x K output channels in registers; the lanes of a
// warp hold consecutive voxels of one channel group, so shared-memory reads
// are conflict-free and the weight reads (global, through L1) are uniform
// per warp. Each output sums its 27 * C products in one fixed order (taps
// ascending, then input channels ascending) whatever the tile, the batch
// index or the batch width: results are deterministic and do not depend on
// the batch.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_tail {

template <typename T> struct Elem;
template <> struct Elem<float> {
    static __device__ __forceinline__ float to_f(float v) { return v; }
    static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
    static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
        return __float2bfloat16_rn(v);
    }
};

// K consecutive weights (16-byte aligned) as f32
template <int K>
__device__ __forceinline__ void load_w(const float* p, float (&w)[K]) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
        w[4 * q] = v.x; w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
}
template <int K>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p,
                                       float (&w)[K]) {
#pragma unroll
    for (int q = 0; q < K / 8; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
            w[8 * q + 2 * i] = __uint_as_float(u[i] << 16);
            w[8 * q + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
}

// K consecutive outputs (16-byte aligned), rounded to T
template <int K>
__device__ __forceinline__ void store_out(float* p, const float (&v)[K]) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
        reinterpret_cast<float4*>(p)[q] = make_float4(
            v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
template <int K>
__device__ __forceinline__ void store_out(__nv_bfloat16* p,
                                          const float (&v)[K]) {
#pragma unroll
    for (int q = 0; q < K / 8; ++q) {
        unsigned u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const unsigned lo = __bfloat16_as_ushort(
                __float2bfloat16_rn(v[8 * q + 2 * i]));
            const unsigned hi = __bfloat16_as_ushort(
                __float2bfloat16_rn(v[8 * q + 2 * i + 1]));
            u[i] = lo | (hi << 16);
        }
        reinterpret_cast<uint4*>(p)[q] = make_uint4(u[0], u[1], u[2], u[3]);
    }
}

// Tile shapes per channel count. The f32 tiles fill an SM's shared memory
// (C = 16: 188 KB, C = 32: 219 KB, C = 64: 183 KB), so one block runs per SM
// and its own warps must hide the latencies; bf16 takes half. NT / V1 / V2
// are chosen so that the warp-sized groups of work items of both
// convolutions spread over all warps in one round (C = 16: 18 warps,
// C = 32: 20). At C = 64 the tile is small and a deeper register tile
// (8 voxels x 8 channels) on 8 warps measured faster than 16 warps of
// 4 x 8. Every choice gives the same bits: the order of a voxel's sum does
// not depend on the tiling.
template <int C> struct Geom;
template <> struct Geom<16> {
    static constexpr int TD = 4, TH = 8, TW = 16, K = 8, V1 = 4, V2 = 2,
                         NT = 576;
};
template <> struct Geom<32> {
    static constexpr int TD = 4, TH = 8, TW = 8, K = 8, V1 = 4, V2 = 2,
                         NT = 640;
};
template <> struct Geom<64> {
    static constexpr int TD = 4, TH = 4, TW = 4, K = 8, V1 = 8, V2 = 2,
                         NT = 256;
};

template <int C> struct Tile : Geom<C> {
    using G = Geom<C>;
    // input tile (2-voxel halo), intermediate tile (1-voxel halo), output
    static constexpr int ID = G::TD + 4, IH = G::TH + 4, IW = G::TW + 4;
    static constexpr int MD = G::TD + 2, MH = G::TH + 2, MW = G::TW + 2;
    static constexpr int IVOL = ID * IH * IW, MVOL = MD * MH * MW;
    static constexpr int OVOL = G::TD * G::TH * G::TW;
    // odd channel strides: the channel-major staging writes spread over
    // the banks
    static constexpr int IVOLP = IVOL | 1, MVOLP = MVOL | 1;
    static constexpr int SMEM_ELEMS = C * (IVOLP + MVOLP);
};

// acc[j][k] += sum over the 27 taps and the C input channels of
// src[ci][base[j] + tap offset] * w[tap][ci][co0 + k], in that fixed order.
// src is a channel-major tile of row length SW and plane SH * SW.
template <typename T, int C, int V, int K, int SH, int SW, int SVOLP>
__device__ __forceinline__ void conv27(const T* __restrict__ src,
                                       const T* __restrict__ w, int co0,
                                       const int (&base)[V],
                                       float (&acc)[V][K]) {
#pragma unroll 1
    for (int tz = 0; tz < 3; ++tz) {
#pragma unroll 1
        for (int ty = 0; ty < 3; ++ty) {
#pragma unroll
            for (int tx = 0; tx < 3; ++tx) {
                const T* s = src + (tz * SH + ty) * SW + tx;
                const T* wt = w + (size_t)((tz * 3 + ty) * 3 + tx) * C * C
                              + co0;
#pragma unroll 4
                for (int ci = 0; ci < C; ++ci) {
                    float wv[K];
                    load_w<K>(wt + ci * C, wv);
                    float a[V];
#pragma unroll
                    for (int j = 0; j < V; ++j)
                        a[j] = Elem<T>::to_f(s[ci * SVOLP + base[j]]);
#pragma unroll
                    for (int j = 0; j < V; ++j)
#pragma unroll
                        for (int k = 0; k < K; ++k)
                            acc[j][k] = fmaf(a[j], wv[k], acc[j][k]);
                }
            }
        }
    }
}

// One output tile at (d0, h0, w0) of batch element n; see the file header.
// Every thread of the block must call it (it synchronises the block).
template <typename T, int C>
__device__ void tail_tile(const T* __restrict__ x, const T* __restrict__ w1,
                          const float* __restrict__ b1,
                          const T* __restrict__ w2,
                          const float* __restrict__ b2, T* __restrict__ out,
                          int n, int S, int d0, int h0, int w0, bool residual,
                          T* in_s, T* mid_s) {
    using G = Tile<C>;
    constexpr int K = G::K, NT = G::NT;
    const int tid = threadIdx.x;

    __syncthreads();  // a previous tile's reads of in_s / mid_s are done
    for (int idx = tid; idx < G::IVOL * C; idx += NT) {
        const int v = idx / C, ci = idx % C;
        const int gz = d0 - 2 + v / (G::IH * G::IW);
        const int gy = h0 - 2 + (v / G::IW) % G::IH;
        const int gx = w0 - 2 + v % G::IW;
        T val = Elem<T>::from_f(0.0f);
        if ((unsigned)gz < (unsigned)S && (unsigned)gy < (unsigned)S
            && (unsigned)gx < (unsigned)S)
            val = x[((((size_t)n * S + gz) * S + gy) * S + gx) * C + ci];
        in_s[ci * G::IVOLP + v] = val;
    }
    __syncthreads();

    // conv1 on the tile with a 1-voxel halo -> mid_s
    {
        constexpr int V = G::V1;
        constexpr int VS = ((G::MVOL + V - 1) / V + 31) / 32 * 32;
        for (int item = tid; item < VS * (C / K); item += NT) {
            const int co0 = (item / VS) * K, vs = item % VS;
            int m[V], base[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
                m[j] = vs + j * VS;
                const int mm = min(m[j], G::MVOL - 1);
                base[j] = ((mm / (G::MH * G::MW)) * G::IH
                           + (mm / G::MW) % G::MH) * G::IW + mm % G::MW;
            }
            float acc[V][K];
#pragma unroll
            for (int j = 0; j < V; ++j)
#pragma unroll
                for (int k = 0; k < K; ++k) acc[j][k] = 0.0f;
            conv27<T, C, V, K, G::IH, G::IW, G::IVOLP>(in_s, w1, co0, base,
                                                       acc);
#pragma unroll
            for (int j = 0; j < V; ++j) {
                if (m[j] >= G::MVOL) continue;
                const int gz = d0 - 1 + m[j] / (G::MH * G::MW);
                const int gy = h0 - 1 + (m[j] / G::MW) % G::MH;
                const int gx = w0 - 1 + m[j] % G::MW;
                const bool inside = (unsigned)gz < (unsigned)S
                                    && (unsigned)gy < (unsigned)S
                                    && (unsigned)gx < (unsigned)S;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const float t = inside
                        ? fmaxf(acc[j][k] + b1[co0 + k], 0.0f) : 0.0f;
                    mid_s[(co0 + k) * G::MVOLP + m[j]] = Elem<T>::from_f(t);
                }
            }
        }
    }
    __syncthreads();

    // conv2 on the tile -> out
    {
        constexpr int V = G::V2;
        constexpr int VS = ((G::OVOL + V - 1) / V + 31) / 32 * 32;
        for (int item = tid; item < VS * (C / K); item += NT) {
            const int co0 = (item / VS) * K, vs = item % VS;
            int o[V], base[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
                o[j] = vs + j * VS;
                const int oo = min(o[j], G::OVOL - 1);
                base[j] = ((oo / (G::TH * G::TW)) * G::MH
                           + (oo / G::TW) % G::TH) * G::MW + oo % G::TW;
            }
            float acc[V][K];
#pragma unroll
            for (int j = 0; j < V; ++j)
#pragma unroll
                for (int k = 0; k < K; ++k) acc[j][k] = 0.0f;
            conv27<T, C, V, K, G::MH, G::MW, G::MVOLP>(mid_s, w2, co0, base,
                                                       acc);
#pragma unroll
            for (int j = 0; j < V; ++j) {
                if (o[j] >= G::OVOL) continue;
                const int oz = o[j] / (G::TH * G::TW);
                const int oy = (o[j] / G::TW) % G::TH, ox = o[j] % G::TW;
                const int gz = d0 + oz, gy = h0 + oy, gx = w0 + ox;
                if (gz >= S || gy >= S || gx >= S) continue;
                const int iv = ((oz + 2) * G::IH + oy + 2) * G::IW + ox + 2;
                float y[K];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    y[k] = fmaxf(acc[j][k] + b2[co0 + k], 0.0f);
                    if (residual)
                        y[k] += Elem<T>::to_f(
                            in_s[(co0 + k) * G::IVOLP + iv]);
                }
                store_out<K>(out + ((((size_t)n * S + gz) * S + gy) * S + gx)
                                       * C + co0, y);
            }
        }
    }
}

}  // namespace fused_tail
