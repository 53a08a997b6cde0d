"""The port's dataset CLIs against the JAX package's, on the CPU.

On synthetic OFF meshes (triangles and quads, the plain ``OFF`` header and
the glued ``OFF<n_v>`` one), through each package's ``main``:

- ``ds_select_largest``: the same links to the same targets;
- ``ds_mesh_to_pc``: ``read_off`` and ``sample_mesh`` equal, the PLY files
  equal byte for byte;
- ``ds_pc_octree_blocks``: the same block files, byte for byte;
- the ``--n_samples`` quirk, in both packages: the pool's worker samples
  ``mesh_to_pc``'s default 500,000 points whatever the flag says.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.cli import ds_mesh_to_pc as jax_m2p
from pcc_geo_cnn_v2_tpu.cli import ds_pc_octree_blocks as jax_blocks
from pcc_geo_cnn_v2_tpu.cli import ds_select_largest as jax_sel
from pcc_geo_cnn_v2_tpu_torch.cli import ds_mesh_to_pc as m2p
from pcc_geo_cnn_v2_tpu_torch.cli import ds_pc_octree_blocks as blocks
from pcc_geo_cnn_v2_tpu_torch.cli import ds_select_largest as sel

VG, LEVEL = 64, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file, as the other port files:
    test files run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_off(path, n=40, seed=0, glued=False, quads=True):
    """A triangle and quad soup around a unit sphere; ``glued`` writes the
    ModelNet header quirk ``OFF<n_v> <n_f> 0``."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    faces = []
    for _ in range(2 * n):
        k = 4 if quads and rng.random() < 0.3 else 3
        faces.append(rng.choice(n, k, replace=False))
    head = f"OFF{n} {len(faces)} 0\n" if glued else \
        f"OFF\n{n} {len(faces)} 0\n"
    with open(path, "w") as f:
        f.write(head)
        for p in v:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in faces:
            f.write(f"{len(t)} " + " ".join(map(str, t)) + "\n")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshes")
    for i in range(4):  # sizes differ: more vertices, larger files
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        _make_off(sub / f"m{i}.off", n=30 + 10 * i, seed=i, glued=i == 1)
    return root


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*")
                  if p.is_file() or p.is_symlink())


@pytest.mark.parametrize("glued", [False, True])
def test_read_off_and_sampling_equal_jax(tmp_path, glued):
    path = tmp_path / "m.off"
    _make_off(path, n=25, seed=7, glued=glued)
    v, f = m2p.read_off(path)
    jv, jf = jax_m2p.read_off(path)
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    assert f.shape[1] == 3 and len(f) > 50  # quads split into two
    got = m2p.sample_mesh(v, f, 5000, np.random.default_rng(3))
    want = jax_m2p.sample_mesh(jv, jf, 5000, np.random.default_rng(3))
    assert np.array_equal(got, want)


def test_select_largest_links_equal_jax(tmp_path, meshes):
    sel.main([str(meshes), "**/*.off", str(tmp_path / "port"), "2"])
    jax_sel.main([str(meshes), "**/*.off", str(tmp_path / "jax"), "2"])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) == 2
    for rel in got:
        assert (tmp_path / "port" / rel).is_symlink()
        assert os.readlink(tmp_path / "port" / rel) == \
            os.readlink(tmp_path / "jax" / rel)
    # the two largest files
    sizes = sorted((p.stat().st_size, p.relative_to(meshes))
                   for p in meshes.rglob("*.off"))
    assert set(got) == {r for _, r in sizes[-2:]}


def _mesh_to_pc(module, src, out, *extra):
    module.main([str(src), "**/*.off", str(out), "--vg_size", str(VG),
                 "--processes", "1", *extra])


def test_mesh_to_pc_and_blocks_bytes_equal_jax(tmp_path, meshes):
    _mesh_to_pc(m2p, meshes, tmp_path / "pc_port")
    _mesh_to_pc(jax_m2p, meshes, tmp_path / "pc_jax")
    clouds = _files(tmp_path / "pc_port")
    assert clouds == _files(tmp_path / "pc_jax") and len(clouds) == 4
    for rel in clouds:
        assert (tmp_path / "pc_port" / rel).read_bytes() == \
            (tmp_path / "pc_jax" / rel).read_bytes(), rel
    for module, out in ((blocks, "bl_port"), (jax_blocks, "bl_jax")):
        module.main([str(tmp_path / "pc_port"), "**/*.ply",
                     str(tmp_path / out), "--vg_size", str(VG),
                     "--level", str(LEVEL), "--processes", "1"])
    got = _files(tmp_path / "bl_port")
    assert got == _files(tmp_path / "bl_jax") and len(got) > len(clouds)
    for rel in got:
        assert (tmp_path / "bl_port" / rel).read_bytes() == \
            (tmp_path / "bl_jax" / rel).read_bytes(), rel


@pytest.mark.parametrize("package", ["port", "jax"])
def test_n_samples_is_ignored_by_the_worker(tmp_path, package):
    """``_work`` calls ``mesh_to_pc`` without ``n_samples``: the CLI's
    output is the default 500,000-sample cloud, not a 2,000-sample one."""
    module = m2p if package == "port" else jax_m2p
    src = tmp_path / "src"
    src.mkdir()
    _make_off(src / "m.off", n=30, seed=11)
    _mesh_to_pc(module, src, tmp_path / "cli", "--n_samples", "2000")
    got = (tmp_path / "cli" / "m.ply").read_bytes()
    module.mesh_to_pc(src / "m.off", tmp_path / "default.ply", VG)
    n_small = module.mesh_to_pc(src / "m.off", tmp_path / "small.ply", VG,
                                n_samples=2000)
    assert got == (tmp_path / "default.ply").read_bytes()
    assert got != (tmp_path / "small.ply").read_bytes()
    assert n_small < 2000
