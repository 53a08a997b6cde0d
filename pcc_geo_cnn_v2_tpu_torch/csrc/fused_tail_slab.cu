// K4b: the fused residual tail over D-slabs, for the volumes the codec's
// dispatch rule sends past the whole-volume kernel (c3p: 64^3 x 16),
//
//   out = relu(conv2(relu(conv1(x) + b1)) + b2) [+ x]
//
// Replaces the Pallas TPU kernel `_tail_slab_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_conv.py:345, launched by
// `fused_residual_tail_slab`, :391). As there, the grid runs over
// (batch element, S / slab) slabs of `slab` D-slices; here a third grid
// dimension runs over the H x W tiles of a slab, and a block walks its
// slab's depth in steps of the tile depth, computing each tile with its halo
// through the same tile body as K4a (fused_tail.cuh), so values at slab seams
// equal the whole-volume kernel's bit for bit. The TPU wrapper zero-pads the
// volume by two slices at each D end for its DMA; this kernel takes the
// unpadded volume: slices outside it read as zero by predicate, and the
// intermediate there is set to zero (not relu(b1)), as SAME padding of the
// second convolution requires.
//
// Bound: operations, as for K4a (54 * C FLOP per element moved).

#include "fused_tail.cuh"

namespace {

using namespace fused_tail;

template <typename T, int C>
__global__ void __launch_bounds__(Geom<C>::NT)
tail_slab_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int S,
                 int slab, int residual) {
    using G = Tile<C>;
    extern __shared__ __align__(16) unsigned char smem[];
    T* in_s = reinterpret_cast<T*>(smem);
    T* mid_s = in_s + C * G::IVOLP;
    const int ntw = (S + G::TW - 1) / G::TW;
    const int h0 = (blockIdx.x / ntw) * G::TH, w0 = (blockIdx.x % ntw) * G::TW;
    const int dlo = blockIdx.y * slab;
    for (int d0 = dlo; d0 < dlo + slab; d0 += G::TD)
        tail_tile<T, C>(x, w1, b1, w2, b2, out, blockIdx.z, S, d0, h0, w0,
                        residual != 0, in_s, mid_s);
}

template <typename T, int C>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, void* out, int n, int S, int slab, int residual,
           cudaStream_t st) {
    using G = Tile<C>;
    if (slab % G::TD || S % slab) return -2;
    const size_t smem = (size_t)G::SMEM_ELEMS * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        tail_slab_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int nth = (S + G::TH - 1) / G::TH, ntw = (S + G::TW - 1) / G::TW;
    tail_slab_kernel<T, C><<<dim3(nth * ntw, S / slab, n), G::NT, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1,
        static_cast<const T*>(w2), b2, static_cast<T*>(out), S, slab,
        residual);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [n, S, S, S, C] (unpadded); w1, w2 [27, C, C]: f32, or bf16 when
// `bf16` is set; b1, b2 [C] f32. C is 16, 32 or 64 (-1 otherwise); S must be
// a multiple of `slab` and `slab` of the tile depth, 4 (-2 otherwise).
// Returns cudaGetLastError.
int pcc_fused_tail_slab(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, int n,
                        int S, int C, int slab, int residual, int bf16,
                        void* stream) {
    if (n <= 0 || S <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
#define PCC_TAIL(T, CC) \
    launch<T, CC>(x, w1, b1, w2, b2, out, n, S, slab, residual, st)
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
