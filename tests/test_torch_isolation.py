"""The port stands alone: no JAX-side imports, and no silent CPU runs."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "msgpack",
             "pcc_geo_cnn_v2_tpu")


def _port_sources():
    files = sorted((REPO / "pcc_geo_cnn_v2_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_side_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_reads_no_kernel_source_and_no_jax():
    """Every module of the port imports without touching ``csrc/``, the
    host C++ or a built library, and without pulling in JAX."""
    import subprocess
    import sys

    code = """
import importlib, pkgutil, sys
opened = []
sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == "open"
                 else None)
import pcc_geo_cnn_v2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) > 25, names
bad = [p for p in opened if "pcc_geo_cnn_v2_tpu_torch" in p
       and p.endswith((".cu", ".cpp", ".so"))]
assert not bad, bad
assert not {"jax", "flax", "pcc_geo_cnn_v2_tpu"} & set(sys.modules)
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


@pytest.mark.parametrize("name", ["bucket_colsums", "bucket_colsums_d2",
                                  "edt_sweep", "halo_edt", "fused_tail",
                                  "fused_tail_slab"])
def test_kernel_source_is_registered_and_stands_alone(name):
    """Each ``csrc/*.cu`` is a registered kernel with a plain C interface
    (no torch headers, so it builds in seconds) and names the TPU kernel
    it replaces."""
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    assert sorted(kernels.KERNELS) == sorted(
        p.stem for p in kernels.CSRC.glob("*.cu"))
    src, fns = kernels.KERNELS[name]
    text = (kernels.CSRC / src).read_text()
    assert "Replaces the Pallas TPU kernel" in text
    assert "torch/" not in text and "ATen" not in text
    assert 'extern "C"' in text
    for fn in fns:
        assert f"int {fn}(" in text
    assert name in kernels.launches


def test_fused_tail_sources_share_one_tile_body_and_no_library_conv():
    """K4a and K4b include the same header for the window body, neither
    source reaches for a library convolution or matrix product, and the
    inner products are tensor-core instructions on staged weights."""
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    for name in ("fused_tail.cu", "fused_tail_slab.cu", "fused_tail.cuh"):
        text = (kernels.CSRC / name).read_text()
        for word in ("cudnn", "cublas", "cutlass", "torch/", "ATen"):
            assert word not in text.lower().replace("cudnn's", ""), \
                (name, word)
        if name.endswith(".cu"):
            assert '#include "fused_tail.cuh"' in text
    body = (kernels.CSRC / "fused_tail.cuh").read_text()
    assert "tail_window" in body and "__float2bfloat16_rn" in body
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in body
    assert "ldmatrix" in body and "cp.async" in body
    assert "static_assert(SMEM_BYTES <= SMEM_LIMIT" in body
    assert "atomic" not in body  # fixed summation order, no float atomics


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a host without CUDA")


def test_codec_without_device_raises_on_cuda_less_host():
    _no_cuda()
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockCodec(build_model("c3p"), {}, device=None)


def test_trainer_without_device_raises_on_cuda_less_host(tmp_path):
    _no_cuda()
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(build_model("c1"), TrainConfig(), tmp_path, device=None)
    assert not list(tmp_path.iterdir())  # nothing written before the raise


def test_bench_without_device_raises_on_cuda_less_host():
    _no_cuda()
    from pcc_geo_cnn_v2_tpu_torch import bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--devices", "2"])


def test_bench_module_exits_non_zero_and_prints_no_result_without_cuda():
    """``python -m pcc_geo_cnn_v2_tpu_torch.bench`` on a host without a
    card: a non-zero exit, nothing on standard output."""
    import subprocess
    import sys

    _no_cuda()
    proc = subprocess.run(
        [sys.executable, "-m", "pcc_geo_cnn_v2_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    _no_cuda()
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_all(force=True)


def test_k1_wrapper_raises_off_cpu():
    """A non-CPU tensor goes to the kernel or raises — never the plain
    version."""
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep import bucket_colsums

    before = dict(kernels.launches)
    pts = torch.zeros(2, 8, 3, dtype=torch.int32, device="meta")
    pos = torch.zeros(2, 16, dtype=torch.int32, device="meta")
    cnt = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bucket_colsums(pts, pos, cnt, cnt, 16)
    assert kernels.launches == before


def test_k2_wrapper_raises_off_cpu():
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.halo import halo_edt

    before = dict(kernels.launches)
    qry = torch.zeros(2, 16, 16, 16, dtype=torch.uint8, device="meta")
    tgt = torch.zeros(2, 26, 26, 26, dtype=torch.uint8, device="meta")
    kmax = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        halo_edt(qry, tgt, kmax, 16, 5)
    assert kernels.launches == before


def test_k3_wrapper_raises_off_cpu():
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep import bucket_colsums_d2

    before = dict(kernels.launches)
    pts = torch.zeros(2, 8, 3, dtype=torch.int32, device="meta")
    nrm = torch.zeros(2, 8, 3, dtype=torch.float32, device="meta")
    pos = torch.zeros(2, 16, dtype=torch.int32, device="meta")
    cnt = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bucket_colsums_d2(pts, nrm, pos, cnt, cnt, 16)
    assert kernels.launches == before


def test_k5_wrapper_raises_off_cpu():
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.edt_sweep import edt_sweep_sums

    before = dict(kernels.launches)
    vol = torch.zeros(2, 16, 16, 16, dtype=torch.float32, device="meta")
    thr = torch.zeros(8, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        edt_sweep_sums(vol, vol, vol, thr)
    assert kernels.launches == before


@pytest.mark.parametrize("slab", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_wrappers_raise_off_cpu(slab, dtype):
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    before = dict(kernels.launches)
    x = torch.zeros(2, 16, 16, 16, 16, dtype=dtype, device="meta")
    w = torch.zeros(27, 16, 16, dtype=dtype, device="meta")
    b = torch.zeros(16, device="meta")
    kw = dict(spatial=16, channels=16, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if slab is None:
            fc.fused_residual_tail(x, w, b, w, b, **kw)
        else:
            fc.fused_residual_tail_slab(x, w, b, w, b, slab=slab, **kw)
    assert kernels.launches == before


def test_k4_wrappers_refuse_what_the_kernels_are_not_built_for():
    """Off the CPU there is no plain version to fall back to: a channel
    count or a slab depth outside the compiled set raises."""
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc

    x = torch.zeros(1, 8, 8, 8, 8, device="meta")
    w = torch.zeros(27, 8, 8, device="meta")
    b = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="channels"):
        fc.fused_residual_tail(x, w, b, w, b, spatial=8, channels=8,
                               dtype=torch.float32)
    x = torch.zeros(1, 8, 8, 8, 16, device="meta")
    w = torch.zeros(27, 16, 16, device="meta")
    b = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="multiple of slab"):
        fc.fused_residual_tail_slab(x, w, b, w, b, spatial=8, channels=16,
                                    slab=2, dtype=torch.float32)


def test_cpu_wrappers_of_the_fused_tails_take_the_plain_versions():
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    before = dict(kernels.launches)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4))
                         .astype(np.float32))
    w1, w2 = (rng.standard_normal((3, 3, 3, 4, 4)).astype(np.float32) * 0.2
              for _ in range(2))
    b1, b2 = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        kw = dict(spatial=8, channels=4, dtype=dtype)
        want = fc.fused_residual_tail_plain(x, w1, b1, w2, b2, **kw)
        assert torch.equal(fc.fused_residual_tail(x, w1, b1, w2, b2, **kw),
                           want)
        assert torch.equal(
            fc.fused_residual_tail_slab(x, w1, b1, w2, b2, slab=4, **kw),
            fc.fused_residual_tail_slab_plain(x, w1, b1, w2, b2, slab=4,
                                              **kw))
    assert kernels.launches == before  # plain versions are not launches


def test_cpu_wrappers_of_the_sweep_kernels_take_the_plain_versions():
    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bs
    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.edt import squared_edt

    before = dict(kernels.launches)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.integers(0, 8, (2, 8, 3)).astype(np.int32))
    nrm = torch.from_numpy(rng.normal(size=(2, 8, 3)).astype(np.float32))
    pos = torch.from_numpy(rng.permutation(512)[:32].reshape(2, 16)
                           .astype(np.int32))
    cnt = torch.tensor([16, 9], dtype=torch.int32)
    npts = torch.tensor([8, 5], dtype=torch.int32)
    for g, w in zip(bs.bucket_colsums_d2(pts, nrm, pos, cnt, npts, 8),
                    bs.bucket_colsums_d2_plain(pts, nrm, pos, cnt, npts, 8)):
        assert torch.equal(g, w)
    x_hat = torch.from_numpy(rng.random((2, 8, 8, 8)).astype(np.float32))
    occ = torch.from_numpy((rng.random((2, 8, 8, 8)) < 0.1)
                           .astype(np.float32))
    thr = torch.linspace(0, 1, 16)
    dt = squared_edt(occ > 0)
    for g, w in zip(es.edt_sweep_sums(x_hat, occ, dt, thr),
                    es.d1_sweep_sums_plain(x_hat, occ, dt, thr)):
        assert torch.equal(g, w)
    assert kernels.launches == before  # plain versions are not launches


def test_cpu_wrappers_take_the_plain_versions():
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep import (
        bucket_colsums,
        bucket_colsums_plain,
    )

    before = dict(kernels.launches)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.integers(0, 8, (2, 8, 3)).astype(np.int32))
    pos = torch.from_numpy(rng.permutation(512)[:32].reshape(2, 16)
                           .astype(np.int32))
    cnt = torch.tensor([16, 9], dtype=torch.int32)
    npts = torch.tensor([8, 5], dtype=torch.int32)
    got = bucket_colsums(pts, pos, cnt, npts, 8)
    want = bucket_colsums_plain(pts, pos, cnt, npts, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.launches == before  # plain versions are not launches
