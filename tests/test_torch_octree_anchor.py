"""The port's built-in octree anchor against the JAX package's, on the CPU.

- The adaptive binary coder: the port's native ``abc_encode`` and its
  Python twin ``abc_encode_py`` byte-equal to JAX's on seeded bits and
  contexts (balanced, skewed, one context, empty); both decoders round-trip,
  the native one plane by plane; a failed build of the native library
  raises (no fall back to the twin).
- ``anchor_encode`` byte-equal to JAX's on seeded clouds at several scales
  in CABAC and DEFLATE modes (the gzip time stamp zeroed);
  ``anchor_decode`` equal; lossless at scale 1 (JAX
  ``tests/test_octree_anchor.py``, mirrored).
- ``mp_run --tmc3 builtin`` and ``mp_report``: reports equal to JAX's on
  the same cloud and logs; the external-binary branch runs the same argv.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.coding import binary_coder as jbc
from pcc_geo_cnn_v2_tpu.coding import octree_anchor as joa
from pcc_geo_cnn_v2_tpu_torch.coding import binary_coder as bc
from pcc_geo_cnn_v2_tpu_torch.coding import octree_anchor as oa
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

SCALES = (1.0, 0.96875, 0.75, 0.5, 0.25, 0.0625)
# gzip's MTIME field inside a DEFLATE anchor stream: magic, header, then
# the gzip member (its bytes 4-8)
_GZ_MTIME = slice(4 + oa._HDR_LEN + 4, 4 + oa._HDR_LEN + 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file, as the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed=0, n=5000, r=256):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.clip(np.round(v * (r // 3) + r // 2), 0, r - 1)
    return np.unique(pts, axis=0)


def _no_mtime(data):
    data = bytearray(data)
    if data[:4] == oa._MAGIC_DEFLATE:
        data[_GZ_MTIME] = b"\0\0\0\0"
    return bytes(data)


# -- the binary coder ----------------------------------------------------------


def _bits(kind, n=6000, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "balanced":
        return ((rng.random(n) < 0.5).astype(np.uint8),
                rng.integers(0, 50, n).astype(np.int32), 50)
    if kind == "skewed":  # long runs of one symbol: carries and 0xFF bytes
        p = np.where(rng.random(n) < 0.5, 0.002, 0.998)
        return ((rng.random(n) < p).astype(np.uint8),
                rng.integers(0, 3, n).astype(np.int32), 3)
    if kind == "one_context":
        return ((rng.random(n) < 0.1).astype(np.uint8),
                np.zeros(n, np.int32), 1)
    if kind == "all_ones":
        return np.ones(n, np.uint8), np.zeros(n, np.int32), 1
    assert kind == "empty"
    return np.zeros(0, np.uint8), np.zeros(0, np.int32), 4


KINDS = ["balanced", "skewed", "one_context", "all_ones", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_abc_streams_equal_jax_and_the_twin(kind):
    bits, ctxs, n_ctx = _bits(kind)
    want = jbc.abc_encode_py(bits, ctxs, n_ctx)
    assert jbc.abc_encode(bits, ctxs, n_ctx) == want
    assert bc.abc_encode(bits, ctxs, n_ctx) == want
    assert bc.abc_encode_py(bits, ctxs, n_ctx) == want


@pytest.mark.parametrize("kind", KINDS)
def test_abc_decoders_round_trip(kind):
    bits, ctxs, n_ctx = _bits(kind)
    data = bc.abc_encode(bits, ctxs, n_ctx)
    cut = len(bits) // 3
    with bc.AbcDecoder(data, n_ctx) as dec:  # plane by plane
        out = np.concatenate([dec.decode(ctxs[:cut]), dec.decode(ctxs[cut:])])
    np.testing.assert_array_equal(out, bits)
    np.testing.assert_array_equal(bc.AbcDecoderPy(data, n_ctx).decode(ctxs),
                                  bits)
    np.testing.assert_array_equal(jbc.AbcDecoderPy(data, n_ctx).decode(ctxs),
                                  bits)


def test_abc_rejects_a_context_out_of_range():
    bits, ctxs, _ = _bits("balanced")
    with pytest.raises(RuntimeError, match="context range"):
        bc.abc_encode(bits, ctxs, 10)
    with bc.AbcDecoder(bc.abc_encode(bits, ctxs, 50), 10) as dec:
        with pytest.raises(ValueError, match="malformed"):
            dec.decode(ctxs)


def test_abc_raises_when_the_native_library_cannot_be_built(
        monkeypatch, tmp_path):
    from pcc_geo_cnn_v2_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    bits, ctxs, n_ctx = _bits("balanced")
    with pytest.raises(OSError):
        bc.abc_encode(bits, ctxs, n_ctx)
    with pytest.raises(OSError):
        bc.AbcDecoder(b"\0" * 8, n_ctx)


# -- the anchor codec -----------------------------------------------------------


@pytest.mark.parametrize("entropy", ["cabac", "deflate"])
@pytest.mark.parametrize("seed,n,r", [(0, 5000, 256), (1, 20000, 1024),
                                      (2, 300, 64)])
def test_anchor_streams_and_decode_equal_jax(seed, n, r, entropy):
    pts = _cloud(seed, n, r)
    for scale in SCALES:
        got = oa.anchor_encode(pts, r, scale=scale, entropy=entropy)
        want = joa.anchor_encode(pts, r, scale=scale, entropy=entropy)
        assert _no_mtime(got) == _no_mtime(want), (scale, entropy)
        dec, res = oa.anchor_decode(got)
        jdec, jres = joa.anchor_decode(want)
        assert res == jres == r
        np.testing.assert_array_equal(dec, jdec)


def test_mask_stream_round_trip_equals_jax():
    pts = _cloud()
    codes = oa._interleave(pts.astype(np.int64), 8)
    np.testing.assert_array_equal(codes, joa._interleave(pts, 8))
    masks = oa.octree_mask_stream(codes, 8)
    np.testing.assert_array_equal(masks, joa.octree_mask_stream(codes, 8))
    np.testing.assert_array_equal(oa.octree_mask_decode(masks, 8),
                                  np.unique(codes))
    np.testing.assert_array_equal(oa._deinterleave(codes, 8),
                                  pts.astype(np.int64))


@pytest.mark.parametrize("entropy", ["cabac", "deflate"])
def test_lossless_at_scale_one(entropy):
    pts = _cloud(4, n=20000)
    dec, res = oa.anchor_decode(oa.anchor_encode(pts, 256, 1.0, entropy))
    assert res == 256
    np.testing.assert_array_equal(np.unique(dec, axis=0), pts)


def test_rd_monotone_across_scales_and_cabac_beats_deflate():
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics

    pts = _cloud(2, n=20000)
    sizes, psnrs = [], []
    for scale in (1.0, 0.5, 0.25):
        data = oa.anchor_encode(pts, 256, scale=scale)
        sizes.append(len(data))
        psnrs.append(compute_metrics(pts, oa.anchor_decode(data)[0],
                                     255)["d1_psnr"])
    assert sizes[0] > sizes[1] > sizes[2]
    assert psnrs[0] > psnrs[1] > psnrs[2]
    assert len(oa.anchor_encode(pts, 256, entropy="deflate")) * 0.92 > \
        sizes[0]


def test_anchor_resolution_header_u32():
    data = oa.anchor_encode(_cloud(5, n=500), 2 ** 17)
    assert oa.anchor_decode(data)[1] == 2 ** 17
    assert data == joa.anchor_encode(_cloud(5, n=500), 2 ** 17)


# -- mp_run / mp_report -----------------------------------------------------------


def _reports(root):
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted(root.glob("**/report.json"))}


@pytest.mark.parametrize("with_norm", [False, True])
def test_mp_run_builtin_reports_equal_jax(tmp_path, with_norm):
    from pcc_geo_cnn_v2_tpu.cli import mp_run as jax_mp
    from pcc_geo_cnn_v2_tpu_torch.cli import mp_run

    pts = _cloud(3, n=8000)
    in_pc = tmp_path / "in.ply"
    pc_io.write_ply(in_pc, pts)
    argv = [str(in_pc), "--tmc3", "builtin", "--rates", "0.75", "0.5",
            "0.25", "--resolution", "256"]
    if with_norm:
        nrm = pts - pts.mean(0)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        pc_io.write_ply(tmp_path / "n.ply", np.hstack([pts, nrm]),
                        ["x", "y", "z", "nx", "ny", "nz"])
        argv += ["--input_norm", str(tmp_path / "n.ply")]
    jax_mp.main([argv[0], str(tmp_path / "jax")] + argv[1:])
    mp_run.main([argv[0], str(tmp_path / "port")] + argv[1:])
    got, want = _reports(tmp_path / "port"), _reports(tmp_path / "jax")
    assert list(got) == list(want) == [f"octree/r{s}/report.json"
                                       for s in ("0.25", "0.5", "0.75")]
    assert got == want
    for name in ("compressed.bin", "decoded.ply", "enc.log", "dec.log"):
        for run in ("r0.5", "r0.25"):
            assert (tmp_path / "port/octree" / run / name).read_bytes() == \
                (tmp_path / "jax/octree" / run / name).read_bytes()
    rep = got["octree/r0.5/report.json"]
    assert rep["bpp"] > 0 and np.isfinite(rep["d1_psnr"])
    assert ("d2_psnr" in rep) == with_norm
    # the rerun finds every report
    before = (tmp_path / "port/octree/r0.5/report.json").stat().st_mtime_ns
    mp_run.main([argv[0], str(tmp_path / "port")] + argv[1:])
    assert (tmp_path / "port/octree/r0.5/report.json").stat().st_mtime_ns \
        == before


def test_mp_report_equals_jax(tmp_path, capsys):
    from pcc_geo_cnn_v2_tpu.cli import mp_report as jax_mr
    from pcc_geo_cnn_v2_tpu_torch.cli import mp_report, pc_error

    pts = _cloud(6, n=3000)
    in_pc = tmp_path / "in.ply"
    pc_io.write_ply(in_pc, pts)
    data = oa.anchor_encode(pts, 256, scale=0.5)
    dec, _ = oa.anchor_decode(data)
    pc_io.write_ply(tmp_path / "dec.ply", dec)
    oa.write_tmc3_style_log(tmp_path / "enc.log", in_pc, len(pts), len(data))
    capsys.readouterr()
    pc_error.main(["--fileA", str(in_pc), "--fileB", str(tmp_path / "dec.ply"),
                   "--resolution", "255"])
    (tmp_path / "pc_error.log").write_text(capsys.readouterr().out)
    logs = [str(in_pc), str(tmp_path / "enc.log"),
            str(tmp_path / "pc_error.log")]
    jax_mr.main(logs + [str(tmp_path / "jax.json")])
    mp_report.main(logs + [str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    rep = json.loads((tmp_path / "port.json").read_text())
    assert rep["pos_bitstream_size_in_bytes"] == len(data)
    assert rep["bpp"] == len(data) * 8 / len(pts)


@pytest.mark.parametrize("mode,rates", [("octree", ["0.5"]),
                                        ("trisoup", ["2", "3"])])
def test_mp_run_external_binaries_get_the_jax_argv(tmp_path, monkeypatch,
                                                   mode, rates):
    """The tmc3 / pc_error branch: the same command lines in both
    packages, recorded at ``subprocess.run``; the fake binaries write the
    logs that ``mp_report`` reads."""
    from pcc_geo_cnn_v2_tpu.cli import mp_run as jax_mp
    from pcc_geo_cnn_v2_tpu_torch.cli import mp_run, pc_error

    pts = _cloud(7, n=2000)
    in_pc = tmp_path / "in.ply"
    pc_io.write_ply(in_pc, pts)
    calls = []

    def fake_run(cmd, stdout=None, stderr=None, check=False):
        assert check
        calls.append([c.replace(str(tmp_path), "T") for c in cmd])
        args = dict(a[2:].split("=", 1) for a in cmd[1:] if "=" in a)
        if cmd[0] == "tmc3" and args["mode"] == "0":
            with open(args["compressedStreamPath"], "wb") as f:
                f.write(b"x" * 77)
            stdout.write(f'uncompressedDataPath  : "{in_pc}"\n'
                         "positions bitstream size 77 B (0.5 bpp)\n"
                         "colors bitstream size 0 B (0 bpp)\n")
        elif cmd[0] == "tmc3":
            pc_io.write_ply(args["reconstructedDataPath"], pts[::2])
        else:
            import contextlib

            with contextlib.redirect_stdout(stdout):
                pc_error.main([f"--{k}={v}" for k, v in args.items()])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    argv = [str(in_pc), "--tmc3", "tmc3", "--pc_error", "pc_error_d",
            "--mode", mode, "--rates", *rates, "--resolution", "256"]
    jax_mp.main([argv[0], str(tmp_path / "o")] + argv[1:])
    want, calls[:] = list(calls), []
    want_reports = _reports(tmp_path / "o")
    import shutil

    shutil.rmtree(tmp_path / "o")
    mp_run.main([argv[0], str(tmp_path / "o")] + argv[1:])
    monkeypatch.undo()
    assert calls == want and len(calls) == 3 * len(rates)
    assert _reports(tmp_path / "o") == want_reports
    assert len(want_reports) == len(rates)


def test_mp_run_module_runs_as_a_child(tmp_path):
    """``python -m pcc_geo_cnn_v2_tpu_torch.cli.mp_run`` from the repo root
    at a single rate."""
    from pathlib import Path

    pts = _cloud(8, n=1500)
    pc_io.write_ply(tmp_path / "in.ply", pts)
    subprocess.run(
        [sys.executable, "-m", "pcc_geo_cnn_v2_tpu_torch.cli.mp_run",
         str(tmp_path / "in.ply"), str(tmp_path / "a"), "--rates", "0.5",
         "--resolution", "256", "--tmc3", "builtin"],
        cwd=Path(__file__).resolve().parent.parent, check=True, timeout=120,
        capture_output=True)
    rep = json.loads((tmp_path / "a/octree/r0.5/report.json").read_text())
    assert rep["input_point_count"] == len(pts)
