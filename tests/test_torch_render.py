"""The port's rendering against the JAX package's, byte for byte, on the CPU.

Both packages render with the same numpy splat renderer and the same
matplotlib, so images, colours, camera JSON and PNG files are equal.
matplotlib's global ``rcParams`` are changed by other test files run in
the same worker, so every PNG comparison renders both sides inside one
``rc_context`` reset to matplotlib's defaults. Open3D is absent here: its
branches of ``pc_to_img`` and ``pc_to_camera_params`` are not exercised.
"""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.cli import pc_to_camera_params as jax_cam
from pcc_geo_cnn_v2_tpu.cli import pc_to_img as jax_img
from pcc_geo_cnn_v2_tpu.cli import ut_run_render as jax_urr
from pcc_geo_cnn_v2_tpu.utils import render as jax_render
from pcc_geo_cnn_v2_tpu_torch.cli import pc_to_camera_params as cam
from pcc_geo_cnn_v2_tpu_torch.cli import pc_to_img, ut_run_render
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io, render

IMG = 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file (test files run in parallel
    worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _default_style():
    """matplotlib's default rcParams for the duration, whatever other
    files set before; restored on exit."""
    import matplotlib

    with matplotlib.rc_context():
        matplotlib.rcdefaults()
        yield


def _cloud(seed, n=600, res=64):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, res, size=(n, 3)), axis=0).astype(
        np.float64)


def _decoded(points, seed):
    """A lossy copy: a few points dropped, a few moved by one voxel."""
    rng = np.random.default_rng(seed)
    keep = points[rng.random(len(points)) > 0.1].copy()
    keep[::7] += rng.integers(-1, 2, size=keep[::7].shape)
    return keep


def test_have_open3d_agrees():
    assert render.have_open3d() == jax_render.have_open3d()


@pytest.mark.parametrize("colors", ["none", "unit", "byte"])
@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ortho_render_matches_jax(axis, flip, colors):
    pts = _cloud(1)
    rng = np.random.default_rng(2)
    col = {"none": None, "unit": rng.random((len(pts), 3)),
           "byte": rng.integers(0, 256, (len(pts), 3)).astype(np.float64)
           }[colors]
    got = render.ortho_render(pts, col, axis=axis, img_size=IMG, flip=flip)
    want = jax_render.ortho_render(pts, col, axis=axis, img_size=IMG,
                                   flip=flip)
    assert got.shape == (IMG, IMG, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # flip changes nothing in either package
    np.testing.assert_array_equal(
        got, render.ortho_render(pts, col, axis=axis, img_size=IMG,
                                 flip=not flip))


@pytest.mark.parametrize("vmax", [None, 2.5])
def test_error_colormap_matches_jax(vmax):
    ori = _cloud(3)
    dec = _decoded(ori, 4)
    got = render.error_colormap(dec, ori, vmax=vmax)
    want = jax_render.error_colormap(dec, ori, vmax=vmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_auto_camera_params_match_jax(axis):
    pts = _cloud(5)
    got = cam.auto_camera_params(pts, IMG, axis)
    assert got == jax_cam.auto_camera_params(pts, IMG, axis)
    ext = np.asarray(got["extrinsic"]).reshape(4, 4).T
    # the camera looks along +z at the cloud's centre
    centre = (pts.min(0) + pts.max(0)) / 2.0
    c = ext[:3, :3] @ centre + ext[:3, 3]
    assert abs(c[0]) < 1e-9 and abs(c[1]) < 1e-9 and c[2] > 0


@pytest.mark.parametrize("auto", [True, False])
def test_pc_to_camera_params_json_matches_jax(tmp_path, auto, caplog):
    ply = tmp_path / "in.ply"
    pc_io.write_ply(ply, _cloud(6))
    flags = ["--auto"] if auto else []
    argv = ["--img_size", str(IMG), "--axis", "1"] + flags
    cam.main([str(ply), str(tmp_path / "t.json")] + argv)
    jax_cam.main([str(ply), str(tmp_path / "j.json")] + argv)
    got = (tmp_path / "t.json").read_bytes()
    assert got == (tmp_path / "j.json").read_bytes()
    assert b"PinholeCameraParameters" in got
    if not auto and not render.have_open3d():
        assert "falling back to --auto" in caplog.text


@pytest.mark.parametrize("rgb", [False, True])
def test_pc_to_img_png_matches_jax(tmp_path, rgb):
    pts = _cloud(7)
    ply = tmp_path / "in.ply"
    if rgb:
        rng = np.random.default_rng(8)
        cols = rng.integers(0, 256, (len(pts), 3))
        pc_io.write_ply(ply, np.hstack([pts, cols]),
                        names=("x", "y", "z", "red", "green", "blue"))
    else:
        pc_io.write_ply(ply, pts)
    argv = ["--img_size", str(IMG), "--axis", "0"]
    with _default_style():
        pc_to_img.main([str(ply), str(tmp_path / "t.png")] + argv)
        jax_img.main([str(ply), str(tmp_path / "j.png")] + argv)
    got = (tmp_path / "t.png").read_bytes()
    assert got[:8] == b"\x89PNG\r\n\x1a\n"
    assert got == (tmp_path / "j.png").read_bytes()


def test_render_comparison_pngs_match_jax(tmp_path):
    ori = _cloud(9)
    dec = _decoded(ori, 10)
    with _default_style():
        render.render_comparison(ori, dec, tmp_path / "t.png", axis=2,
                                 img_size=IMG)
        jax_render.render_comparison(ori, dec, tmp_path / "j.png", axis=2,
                                     img_size=IMG)
    for suffix in ("", ".colorbar.png"):
        got = (tmp_path / f"t.png{suffix}").read_bytes()
        assert got[:8] == b"\x89PNG\r\n\x1a\n"
        assert got == (tmp_path / f"j.png{suffix}").read_bytes()


def _experiment_tree(root):
    """An ``ev_run_experiment`` layout (``<pc>/<id>/<lambda>/*.dec.ply``):
    one decode to render, one of a cloud with no original, one empty
    decode and one already rendered."""
    ori = _cloud(11)
    pc_io.write_ply(root / "a.ply", ori)
    exp = root / "exp"
    for rel, pts in [("a/c3p/1e-04/a.d1.dec.ply", _decoded(ori, 12)),
                     ("b/c3p/1e-04/b.d1.dec.ply", _decoded(ori, 13)),
                     ("a/c3p/2e-04/a.d1.dec.ply", np.zeros((0, 3))),
                     ("a/c3p/4e-04/a.d1.dec.ply", _decoded(ori, 14))]:
        (exp / rel).parent.mkdir(parents=True, exist_ok=True)
        pc_io.write_ply(exp / rel, pts)
    (exp / "a/c3p/4e-04/a.d1.dec.render.png").write_bytes(b"kept")
    return exp


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_ut_run_render_matches_jax(tmp_path, caplog):
    src = tmp_path / "src"
    src.mkdir()
    exp = _experiment_tree(src)
    outs = {}
    for name, mod in [("torch", ut_run_render), ("jax", jax_urr)]:
        d = tmp_path / name
        shutil.copytree(exp, d)
        yml = tmp_path / f"{name}.yml"
        yml.write_text(f"experiment_dir: {d}\ndata:\n  - pc_name: a\n"
                       f"    input_pc: {src / 'a.ply'}\n")
        with _default_style():
            mod.main([str(yml), "--img_size", str(IMG)])
        outs[name] = _files(d)
    got, want = outs["torch"], outs["jax"]
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == want[k], k
    new = sorted(k for k in got if k.endswith(".png"))
    assert new == ["a/c3p/1e-04/a.d1.dec.render.png",
                   "a/c3p/1e-04/a.d1.dec.render.png.colorbar.png",
                   "a/c3p/4e-04/a.d1.dec.render.png"]
    assert got["a/c3p/4e-04/a.d1.dec.render.png"] == b"kept"
    assert "no original for b" in caplog.text
