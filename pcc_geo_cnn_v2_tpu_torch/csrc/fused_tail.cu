// K4a: fused residual tail of an analysis / synthesis block over whole
// volumes,
//
//   out = relu(conv2(relu(conv1(x) + b1)) + b2) [+ x]
//
// two 3x3x3 stride-1 SAME convolutions C -> C with the intermediate kept on
// chip. Replaces the Pallas TPU kernel `_tail_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_conv.py:171, launched by
// `fused_residual_tail`, :194). The TPU kernel keeps a whole lane-folded
// volume in VMEM, one program per batch element; an SM has 227 KB, so here
// the grid runs over (output tiles of the volume, batch element) and every
// block computes one tile with its halo (fused_tail.cuh). None of the TPU
// layout devices (128-lane folding, block-diagonal taps, rolls) is carried
// over: x, out are plain channels-last [N, S, S, S, C], the weights
// [27, C, C].
//
// Bound: operations. The function needs 2 * 2 * 27 * C^2 * S^3 * N FLOP
// against (2 * S^3 * N * C + 2 * 27 * C^2) elements moved: 54 * C FLOP per
// element, far above the card's ratio for f32 FFMA (20 FLOP/B) at every C
// here. This first kernel is plain FFMA with register tiles (bf16 operands
// are widened to f32 in registers, no tensor cores) and recomputes conv1 on
// each tile's 1-voxel halo; PERF.md has its times beside cuDNN's.

#include "fused_tail.cuh"

namespace {

using namespace fused_tail;

template <typename T, int C>
__global__ void __launch_bounds__(Geom<C>::NT)
tail_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const float* __restrict__ b1, const T* __restrict__ w2,
            const float* __restrict__ b2, T* __restrict__ out, int S,
            int residual) {
    using G = Tile<C>;
    extern __shared__ __align__(16) unsigned char smem[];
    T* in_s = reinterpret_cast<T*>(smem);
    T* mid_s = in_s + C * G::IVOLP;
    const int nth = (S + G::TH - 1) / G::TH, ntw = (S + G::TW - 1) / G::TW;
    const int t = blockIdx.x;
    tail_tile<T, C>(x, w1, b1, w2, b2, out, blockIdx.y, S,
                    (t / (ntw * nth)) * G::TD, ((t / ntw) % nth) * G::TH,
                    (t % ntw) * G::TW, residual != 0, in_s, mid_s);
}

template <typename T, int C>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, void* out, int n, int S, int residual,
           cudaStream_t st) {
    using G = Tile<C>;
    const size_t smem = (size_t)G::SMEM_ELEMS * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int ntd = (S + G::TD - 1) / G::TD, nth = (S + G::TH - 1) / G::TH,
              ntw = (S + G::TW - 1) / G::TW;
    tail_kernel<T, C><<<dim3(ntd * nth * ntw, n), G::NT, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1,
        static_cast<const T*>(w2), b2, static_cast<T*>(out), S, residual);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [n, S, S, S, C]; w1, w2 [27, C, C]: f32, or bf16 when `bf16` is
// set; b1, b2 [C] f32. C is 16, 32 or 64 (-1 otherwise). Returns
// cudaGetLastError.
int pcc_fused_tail(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, void* out, int n, int S,
                   int C, int residual, int bf16, void* stream) {
    if (n <= 0 || S <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
#define PCC_TAIL(T, CC) \
    launch<T, CC>(x, w1, b1, w2, b2, out, n, S, residual, st)
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

}  // extern "C"
