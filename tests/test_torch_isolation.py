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
                                  "edt_sweep", "halo_edt"])
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


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a host without CUDA")


def test_codec_without_device_raises_on_cuda_less_host():
    _no_cuda()
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockCodec(build_model("c3p"), {}, device=None)


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
