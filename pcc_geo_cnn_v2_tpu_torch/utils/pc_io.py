"""Point-cloud PLY IO — dependency-free numpy reader/writer.

Replaces the reference's pyntcloud/pandas stack
(``reference src/utils/pc_io.py``) with a minimal parser supporting
ascii and binary_little_endian vertex elements, which covers the MPEG CTC
clouds and ModelNet-derived training blocks.
"""

from __future__ import annotations

import multiprocessing
from glob import glob
from pathlib import Path

import numpy as np

__all__ = [
    "read_ply",
    "write_ply",
    "load_points",
    "get_files",
    "get_shape_data",
]

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
               "u2": "ushort", "i2": "short", "u4": "uint", "i1": "char"}


def read_ply(path, columns=None):
    """Read a PLY file's vertex element.

    :param path: file path.
    :param columns: optional list of property names to select (e.g.
        ``['x', 'y', 'z', 'nx', 'ny', 'nz']``); missing names raise.
    :return: (data, names) — float64 array [N, P] and the property names.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertices = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0]
            if key == b"format":
                fmt = tokens[1].decode()
            elif key == b"element":
                in_vertex = tokens[1] == b"vertex"
                if in_vertex:
                    n_vertices = int(tokens[2])
            elif key == b"property" and in_vertex:
                if tokens[1] == b"list":
                    raise ValueError(f"{path}: list property in vertex element")
                props.append((tokens[-1].decode(), _PLY_DTYPES[tokens[1].decode()]))
            elif key == b"end_header":
                break
        if fmt is None or n_vertices is None:
            raise ValueError(f"{path}: malformed header")

        names = [p[0] for p in props]
        if fmt == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_vertices, ndmin=2)
            data = raw[:, : len(names)]
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            rec = np.frombuffer(f.read(dtype.itemsize * n_vertices), dtype=dtype)
            data = np.stack([rec[n].astype(np.float64) for n in names], axis=1)
        elif fmt == "binary_big_endian":
            dtype = np.dtype([(n, ">" + t) for n, t in props])
            rec = np.frombuffer(f.read(dtype.itemsize * n_vertices), dtype=dtype)
            data = np.stack([rec[n].astype(np.float64) for n in names], axis=1)
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")

    if columns is not None:
        idx = [names.index(c) for c in columns]
        return np.ascontiguousarray(data[:, idx]), list(columns)
    return data, names


def write_ply(path, data, names=("x", "y", "z"), dtypes=None, binary=True):
    """Write a vertex-only PLY file.

    :param data: [N, P] array.
    :param names: property names per column.
    :param dtypes: numpy dtype strings per column ('f4', 'u1', ...);
        defaults to float32 for all columns.
    """
    data = np.asarray(data)
    n, p = data.shape
    assert p == len(names)
    if dtypes is None:
        dtypes = ["f4"] * p
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {n}")
    for name, dt in zip(names, dtypes):
        header.append(f"property {_INV_DTYPES[dt]} {name}")
    header.append("end_header\n")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        if binary:
            rec = np.rec.fromarrays(
                [data[:, i].astype("<" + dtypes[i]) for i in range(p)],
                names=list(names),
            )
            f.write(rec.tobytes())
        else:
            np.savetxt(f, data, fmt="%.8g")


def _load_one(args):
    path, columns = args
    data, _ = read_ply(path, columns=columns)
    return data


def load_points(paths, columns=("x", "y", "z"), processes=None):
    """Load many PLY files in parallel (reference: ``pc_io.py:72-79``)."""
    paths = list(paths)
    work = [(p, list(columns)) for p in paths]
    if len(paths) <= 1 or processes == 0:
        return [_load_one(w) for w in work]
    with multiprocessing.Pool(processes) as pool:
        return pool.map(_load_one, work)


def get_files(pattern):
    return sorted(glob(pattern, recursive=True))


def get_shape_data(resolution: int):
    """Dense occupancy-grid shape metadata for a given voxel resolution.

    NDHWC layout (TPU-native; the reference used NCDHW channels_first,
    ``pc_io.py:54-65``).
    """
    bbox_min = 0
    bbox_max = resolution
    dense_shape = (resolution, resolution, resolution, 1)
    return bbox_min, bbox_max, dense_shape
