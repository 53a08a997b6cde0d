"""What a cloud should code to, worked out without the program, and the
numbers that judge the program's answers against it.

Everything here is plain numpy / PyTorch / scipy: the octree partition
(blocks in Morton order), the container's framing, the decoded occupancy
probabilities (:mod:`reference.model`), the D1-optimal threshold of every
block on the threshold grid (an exhaustive search over the grid, the
selection rule of the paper's reference code), the reconstruction at given
thresholds, each y element's row of the scale table, and the full-cloud
D1 PSNR (scipy KD-trees, float64).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np
import torch

__all__ = ["octree_blocks", "parse_container", "CloudReference",
           "cloud_keys", "keys_points", "mismatch", "d1_psnr"]


def octree_blocks(points, resolution, level):
    """(block ids [n, 3], local int64 coords of each block) of a cloud of
    unique integer points, blocks in Morton order (z, y, x bits, z the
    most significant of each triple), points in input order within a
    block."""
    bs = resolution >> level
    pts = np.asarray(points, np.int64)
    ids = pts // bs
    code = np.zeros(len(pts), np.int64)
    for bit in range(level - 1, -1, -1):
        code = (code << 3) | (((ids[:, 2] >> bit) & 1) << 2) \
            | (((ids[:, 1] >> bit) & 1) << 1) | ((ids[:, 0] >> bit) & 1)
    order = np.argsort(code, kind="stable")
    _, first = np.unique(code[order], return_index=True)
    groups = np.split(order, first[1:])
    return (np.stack([ids[g[0]] for g in groups]),
            [pts[g] - ids[g[0]] * bs for g in groups])


def parse_container(raw):
    """A gzipped stream → (resolution, level, [threshold index] per
    block). Framing: u16 resolution, u8 level, u16 blocks, u8 strings per
    block, u16 binstr length, the binstr, then per block a u8 threshold
    index and its strings, each as u16 length + bytes (little endian)."""
    data = gzip.decompress(raw)
    resolution, level, n_blocks, n_strings, n_binstr = struct.unpack_from(
        "<HBHBH", data, 0)
    pos = 8 + n_binstr
    thr = []
    for _ in range(n_blocks):
        thr.append(data[pos])
        pos += 1
        for _ in range(n_strings):
            pos += 2 + struct.unpack_from("<H", data, pos)[0]
    if pos != len(data):
        raise ValueError(f"container: {len(data) - pos} bytes left over")
    return resolution, level, np.asarray(thr, np.int64)


def cloud_keys(points, resolution):
    """Sorted unique int64 keys of integer points [N, 3]."""
    p = np.asarray(points).astype(np.int64)
    return np.unique((p[:, 0] * resolution + p[:, 1]) * resolution
                     + p[:, 2])


def keys_points(keys, resolution):
    """Integer points [N, 3] of :func:`cloud_keys` keys."""
    k = np.asarray(keys, np.int64)
    return np.stack([k // (resolution * resolution),
                     (k // resolution) % resolution, k % resolution], 1)


def d1_psnr(points, recon, resolution):
    """Full-cloud D1 PSNR of ``recon`` against ``points`` (the paper's
    metric): per direction the mean squared distance to the nearest point
    of the other cloud, the peak 3 (resolution - 1)², the smaller of the
    two directions' PSNRs; float64, exact KD-tree neighbours."""
    from scipy.spatial import cKDTree

    a = np.asarray(points, np.float64)
    b = np.asarray(recon, np.float64)
    if len(a) == 0 or len(b) == 0:
        return -np.inf
    peak = 3.0 * (resolution - 1) ** 2
    out = []
    for q, t in ((a, b), (b, a)):
        d = cKDTree(t).query(q, workers=-1)[0]
        mse = float(np.sum(d * d)) / len(q)
        out.append(np.inf if mse == 0 else 10 * np.log10(peak / mse))
    return min(out)


def mismatch(keys, ref_keys):
    """(points in one set and not the other, points of the reference)."""
    return (int(np.setxor1d(keys, ref_keys, assume_unique=True).size),
            int(ref_keys.size))


def _d1_pick(orig, xh, thr):
    """The D1-optimal threshold index of one block: for every threshold the
    candidate set {x_hat > t}, the sums of squared distances original →
    nearest candidate (AB) and candidate → nearest original (BA), the mse
    max(AB / n, BA / |set|) in float32; the first minimum among thresholds
    before the first empty set, unless the block's centroid alone scores
    lower (then, as with no candidate, the last index)."""
    dev = xh.device
    T = len(thr)
    B = xh.shape[-1]
    flat = xh.reshape(-1)
    counts = (flat[None, :] > thr[:, None]).sum(1)
    cand_idx = torch.nonzero(flat > thr[0]).flatten()
    order = torch.argsort(-flat[cand_idx], stable=True)
    cand_idx = cand_idx[order]
    cand = torch.stack([cand_idx // (B * B), (cand_idx // B) % B,
                        cand_idx % B], 1).to(torch.int32)
    n = len(orig)
    K = len(cand)
    last = T - 1
    if K == 0 or n == 0:
        return last
    at = (counts - 1).clamp_min(0)
    ab = torch.zeros(T, dtype=torch.int64, device=dev)
    colmin = torch.full((K,), 1 << 30, dtype=torch.int32, device=dev)
    rows = max(1, (1 << 26) // K)
    for lo in range(0, n, rows):
        d = ((orig[lo:lo + rows, None, :] - cand[None, :, :]) ** 2).sum(
            -1, dtype=torch.int32)
        colmin = torch.minimum(colmin, d.min(0).values)
        ab += d.cummin(1).values[:, at].sum(0, dtype=torch.int64)
    ba = torch.cumsum(colmin.to(torch.int64), 0)[at]
    nf = torch.tensor(float(n), device=dev)
    cnt = counts.to(torch.float32)
    mse_ab = ab.to(torch.float32) / nf
    mse_ba = torch.where(counts > 0, ba.to(torch.float32)
                         / cnt.clamp_min(1), torch.tensor(float("inf"),
                                                          device=dev))
    mse = torch.maximum(mse_ab, mse_ba)
    empty = torch.nonzero(counts == 0).flatten()
    stop = int(empty[0]) if len(empty) else T
    if stop == 0:
        return last
    vals = mse[:stop]
    k = int(torch.nonzero(vals == vals.min()).flatten()[0])
    # the centroid guard, in the float32 order of the reference code
    o = orig.to(torch.int64)
    s1 = o.sum(0).to(torch.float32)
    s2 = (o * o).sum(0).to(torch.float32)
    c = torch.round(s1 / nf)
    guard_ab = s2.sum() - 2 * (c * s1).sum() + nf * (c * c).sum()
    ci = c.to(torch.int64).clamp(0, B - 1)
    guard_ba = ((o - ci) ** 2).sum(1).min().to(torch.float32)
    guard = torch.maximum(guard_ab / nf, guard_ba)
    return last if bool(vals[k] > guard) else k


class CloudReference:
    """The reference's coding of one cloud: its blocks, their y scale rows
    (NDHWC, on the host), their decoded probabilities and, on demand, its
    D1 picks and reconstructions."""

    def __init__(self, model, points, resolution, level, thresholds,
                 batch=32):
        self.points = np.asarray(points)
        self.resolution, self.level = resolution, level
        self.bs = resolution >> level
        self.ids, self.blocks = octree_blocks(points, resolution, level)
        dev = model.device
        self.thr = torch.tensor(np.asarray(thresholds, np.float32),
                                device=dev)
        B = self.bs
        x_hat, rows = [], []
        for lo in range(0, len(self.blocks), batch):
            part = self.blocks[lo:lo + batch]
            occ = torch.zeros(len(part), 1, B, B, B, device=dev)
            for i, b in enumerate(part):
                t = torch.as_tensor(b, device=dev)
                occ[i, 0, t[:, 0], t[:, 1], t[:, 2]] = 1.0
            y_sym, z_sym = model.symbols(occ)
            rows.append(model.scale_rows(z_sym).permute(0, 2, 3, 4, 1)
                        .to(torch.uint8).cpu())
            x_hat.append(model.x_hat(y_sym))
        self.x_hat = torch.cat(x_hat)
        self.rows = torch.cat(rows).numpy()
        self._picks = None

    def picks(self):
        """The reference's D1-optimal threshold index of every block."""
        if self._picks is None:
            dev = self.x_hat.device
            self._picks = np.array([
                _d1_pick(torch.as_tensor(b, device=dev).to(torch.int32),
                         self.x_hat[i], self.thr)
                for i, b in enumerate(self.blocks)], np.int64)
        return self._picks

    def recon_keys(self, thr_idx):
        """Keys (:func:`cloud_keys`) of the reconstruction at one threshold
        index a block."""
        thr = self.thr[torch.as_tensor(thr_idx, device=self.thr.device)]
        occ = self.x_hat > thr[:, None, None, None]
        nz = torch.nonzero(occ).cpu().numpy()
        pts = nz[:, 1:] + self.ids[nz[:, 0]] * self.bs
        return cloud_keys(pts, self.resolution)
