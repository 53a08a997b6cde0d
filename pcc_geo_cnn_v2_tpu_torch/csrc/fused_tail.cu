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
// the grid runs over (H x W tile, depth range, batch element) and every
// block rolls a window of three input planes and three intermediate planes
// along its depth range (fused_tail.cuh). None of the TPU layout devices
// (128-lane folding, block-diagonal taps, rolls) is carried over: x, out are
// plain channels-last [N, S, S, S, C], the weights [27, C, C].
//
// Bound: operations. The function needs 2 * 2 * 27 * C^2 * S^3 * N FLOP
// against (2 * S^3 * N * C + 2 * 27 * C^2) elements moved: 54 * C FLOP per
// element, far above the card's ratio at every C here, for the f32 FFMA
// rate (20 FLOP/B) and, at C >= 32, for the bf16 tensor-core rate (295
// FLOP/B). So the inner products run on the tensor cores (bf16:
// mma.sync.m16n8k16; f32: three TF32 mma.sync.m16n8k8 per k-step on hi / lo
// splits, summed in f32 outside the tensor core), the weights are staged in
// shared memory, and the halo is recomputed in H and W only; the depth
// range (`dchunk` planes per block, chosen by the wrapper) trades two
// extra intermediate planes per range for enough blocks to fill the card.
// PERF.md has the times beside cuDNN's.

#include "fused_tail.cuh"

namespace {

using fused_tail::Tile;

template <typename T, int C>
__global__ void __launch_bounds__(Tile<T, C>::NT, Tile<T, C>::BLOCKS_PER_SM)
tail_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const float* __restrict__ b1, const T* __restrict__ w2,
            const float* __restrict__ b2, T* __restrict__ out, int S,
            int dchunk, int residual) {
    fused_tail::window_block<T, C>(x, w1, b1, w2, b2, out, S, dchunk,
                                   residual);
}

struct Kernel {
    template <typename T, int C> static auto get() {
        return &tail_kernel<T, C>;
    }
};

}  // namespace

extern "C" {

// x, out [n, S, S, S, C]; w1, w2 [27, C, C]: f32, or bf16 when `bf16` is
// set; b1, b2 [C] f32. C is 16, 32 or 64 (-1 otherwise); a block walks
// `dchunk` > 0 output planes (-2 otherwise). Returns cudaGetLastError.
int pcc_fused_tail(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, void* out, int n, int S,
                   int C, int dchunk, int residual, int bf16, void* stream) {
    if (n <= 0 || S <= 0) return (int)cudaGetLastError();
    return fused_tail::launch_any<Kernel>(x, w1, b1, w2, b2, out, n, S, C,
                                          dchunk, residual, bf16,
                                          (cudaStream_t)stream);
}

// geo[3] = {tile height, tile width, blocks per SM by shared memory} of
// the kernel for (C, bf16); -1 for an unknown C.
int pcc_fused_tail_geometry(int C, int bf16, int* geo) {
    return fused_tail::geometry_any(C, bf16, geo);
}

}  // extern "C"
