"""Sample meshes into voxelized point clouds (port of
``pcc_geo_cnn_v2_tpu.cli.ds_mesh_to_pc``, the reference's
``ds_mesh_to_pc.py``: 500k surface samples per mesh, min-max normalize to
the voxel grid, round, dedup). A dependency-free OFF triangle-mesh reader
and area-weighted surface sampling, with the JAX tool's
``np.random.default_rng(seed)`` draws, so both write the same PLY bytes.

As in the JAX tool, the pool's worker samples ``mesh_to_pc``'s default
500,000 points whatever ``--n_samples`` says.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ds_mesh_to_pc \\
        ModelNet40_200 '**/*.off' ModelNet40_200_pc512 --vg_size 512
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
from pathlib import Path

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

logger = logging.getLogger(__name__)


def read_off(path):
    """ModelNet OFF reader (tolerates the 'OFF123 45 6' header quirk);
    polygons are fan-triangulated."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0].startswith("OFF"), f"{path}: not an OFF file"
    if tokens[0] == "OFF":
        pos = 1
    else:  # header glued to counts: "OFF123"
        tokens[0] = tokens[0][3:]
        pos = 0
    n_v, n_f = int(tokens[pos]), int(tokens[pos + 1])
    pos += 3
    verts = np.array(tokens[pos: pos + 3 * n_v], np.float64).reshape(n_v, 3)
    pos += 3 * n_v
    faces = []
    for _ in range(n_f):
        k = int(tokens[pos])
        poly = [int(t) for t in tokens[pos + 1: pos + 1 + k]]
        for i in range(1, k - 1):  # fan-triangulate
            faces.append((poly[0], poly[i], poly[i + 1]))
        pos += k + 1
    return verts, np.array(faces, np.int64)


def sample_mesh(verts, faces, n_samples, rng):
    """Area-weighted uniform surface sampling."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    assert total > 0, "degenerate mesh"
    idx = rng.choice(len(faces), n_samples, p=areas / total)
    u = rng.random((n_samples, 1))
    v = rng.random((n_samples, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[idx] + u * (b[idx] - a[idx]) + v * (c[idx] - a[idx])


def mesh_to_pc(in_path, out_path, vg_size, n_samples=500_000, seed=42):
    verts, faces = read_off(in_path)
    pts = sample_mesh(verts, faces, n_samples, np.random.default_rng(seed))
    # min-max normalize to [0, vg_size-1], round, dedup (reference :29-55)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    scale = (hi - lo).max()
    pts = (pts - lo) / scale * (vg_size - 1)
    pts = np.unique(np.round(pts), axis=0)
    pc_io.write_ply(out_path, pts)
    return len(pts)


def _work(args):
    # n_samples is not passed on: the JAX tool's worker does the same
    in_path, out_path, vg_size = args
    n = mesh_to_pc(in_path, out_path, vg_size)
    logger.info("%s -> %s (%d points)", in_path, out_path, n)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ds_mesh_to_pc")
    parser.add_argument("input_dir")
    parser.add_argument("input_pattern", help="e.g. '**/*.off'")
    parser.add_argument("output_dir")
    parser.add_argument("--vg_size", type=int, default=512)
    parser.add_argument("--n_samples", type=int, default=500_000)
    parser.add_argument("--processes", type=int, default=None)
    args = parser.parse_args(argv)

    files = sorted(Path(args.input_dir).glob(args.input_pattern))
    if not files:
        parser.error("no meshes matched")
    work = []
    for f in files:
        rel = f.relative_to(args.input_dir).with_suffix(".ply")
        out = Path(args.output_dir) / rel
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        work.append((str(f), str(out), args.vg_size))
    with multiprocessing.get_context("spawn").Pool(args.processes) as pool:
        pool.map(_work, work)
    logger.info("converted %d meshes", len(work))


if __name__ == "__main__":
    main()
