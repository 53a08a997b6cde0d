// K4b: the fused residual tail over D-slabs, for the volumes the codec's
// dispatch rule sends past the whole-volume kernel (c3p: 64^3 x 16),
//
//   out = relu(conv2(relu(conv1(x) + b1)) + b2) [+ x]
//
// Replaces the Pallas TPU kernel `_tail_slab_kernel`
// (pcc_geo_cnn_v2_tpu/ops/pallas_conv.py:345, launched by
// `fused_residual_tail_slab`, :391). As there, the grid runs over
// (batch element, S / slab) slabs of `slab` D-slices, here times the H x W
// tiles of a slab; a block rolls the window of fused_tail.cuh (three input
// planes, three intermediate planes in shared memory) through its slab:
// one new input plane, one intermediate plane and one output plane per
// step, nothing restaged. It is the body K4a runs, so values at slab seams
// equal the whole-volume kernel's bit for bit. The TPU wrapper zero-pads the
// volume by two slices at each D end for its DMA; this kernel takes the
// unpadded volume: planes outside it are staged as zeros by predicate, and
// the intermediate there is set to zero (not relu(b1)), as SAME padding of
// the second convolution requires.
//
// Bound: operations, as for K4a (54 * C FLOP per element moved); the inner
// products run on the tensor cores in both dtypes (fused_tail.cuh).

#include "fused_tail.cuh"

namespace {

using fused_tail::Tile;

template <typename T, int C>
__global__ void __launch_bounds__(Tile<T, C>::NT, Tile<T, C>::BLOCKS_PER_SM)
tail_slab_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int S,
                 int dchunk, int residual) {
    fused_tail::window_block<T, C>(x, w1, b1, w2, b2, out, S, dchunk,
                                   residual);
}

struct Kernel {
    template <typename T, int C> static auto get() {
        return &tail_slab_kernel<T, C>;
    }
};

}  // namespace

extern "C" {

// x, out [n, S, S, S, C] (unpadded); w1, w2 [27, C, C]: f32, or bf16 when
// `bf16` is set; b1, b2 [C] f32. C is 16, 32 or 64 (-1 otherwise); S must be
// a multiple of `slab` and `slab` of 4 (-2 otherwise). Returns
// cudaGetLastError.
int pcc_fused_tail_slab(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, int n,
                        int S, int C, int slab, int residual, int bf16,
                        void* stream) {
    if (n <= 0 || S <= 0) return (int)cudaGetLastError();
    if (slab <= 0 || slab % 4 || S % slab) return -2;
    return fused_tail::launch_any<Kernel>(x, w1, b1, w2, b2, out, n, S, C,
                                          slab, residual, bf16,
                                          (cudaStream_t)stream);
}

}  // extern "C"
