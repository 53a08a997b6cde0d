"""The frozen conv count against hand counts."""

from __future__ import annotations

import pytest

from benchlib import workcount

C3P = {"num_filters": 64, "block_size": 64,
       "analysis": "AnalysisTransformProgressiveV2"}


def test_stride_one_conv_by_hand():
    # 8³ outputs, k3, 4 → 5 channels: 2·27·4·5 FLOPs an output voxel
    lay = workcount._layer("a", 8, 8, 3, 4, 5, False)
    assert lay["flops"] == 512 * 2 * 27 * 4 * 5
    assert lay["bytes"] == 4 * (512 * 4 + 512 * 5 + 27 * 4 * 5)


def test_stride_two_transposed_conv_counts_input_voxels():
    # 8³ → 16³: the products are per input voxel, not per output voxel
    lay = workcount._layer("s", 8, 16, 3, 4, 5, True)
    assert lay["flops"] == 512 * 2 * 27 * 4 * 5
    assert lay["bytes"] == 4 * (512 * 4 + 4096 * 5 + 27 * 4 * 5)


def test_passes_and_peaks():
    enc, _ = workcount.pass_work(C3P, "encode")
    dec, _ = workcount.pass_work(C3P, "decode")
    train, _ = workcount.pass_work(C3P, "train")
    assert dec < enc and train == 3 * enc
    assert workcount.PEAK_FLOPS == 67e12 and workcount.PEAK_BYTES == 3.35e12
    assert 0 < workcount.roofline_s(C3P, "decode") < workcount.roofline_s(
        C3P, "encode")
    # 26 convolutions in c3p: 10 analysis, 3 + 3 hyper, 10 synthesis
    assert len(workcount.layers(C3P)) == 26


@pytest.mark.parametrize("name,fam", [
    # kernel names of the traced runs on the card (H100, cuDNN)
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize64x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_"
     "kernel__5x_cudnn", "convolution"),
    ("sm80_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nchwkcrs_"
     "nchw_tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_"
     "execute_kernel__5x_", "convolution"),
    ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<true, true, int, "
     "float, float, float>(cudnn::cnn::WgradGroupedDirectParams, ...)",
     "convolution"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_"
     "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_execute_kernel__5x_cudnn",
     "convolution"),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_"
     "kernel__5x_cudnn", "convolution"),
    ("void wgrad_alg1_nd_float_engine<float, float, 3, 0, 5, 7, 4, 3, 5, "
     "false, true>(int, int, int, float const*, int, float*, ...)",
     "convolution"),
    ("(anonymous namespace)::bucket_colsums_kernel(int const*, int const*, "
     "...)", "K1 bucket_colsums"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase"
     "&)::{lambda()", "copy / fill"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, ...)", "copy / fill"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, ...)", "other"),
    ("void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...>", "sort"),
    # not convolutions: a plain GEMM (the factorized prior's matmul) and a
    # dtype conversion
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x16_warpgroup"
     "size1x1x1_execute_segment_k_off_kernel__5x_cublas", "other"),
    ("ampere_sgemm_32x32_sliced1x4_nn", "other"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "convert_kernel(...)>", "other"),
])
def test_kernel_family(name, fam):
    from benchlib.tracing import family

    assert family(name) == fam
