"""Process-group helpers: shards of a global batch, and the process group.

Port of ``pcc_geo_cnn_v2_tpu/parallel/mesh.py``. JAX lays its axes over a
device mesh inside one process; the port runs one process a rank in a
``torch.distributed`` group (:func:`process_group`). On the "dp" axis
each rank holds its rows of every global batch and
``training.Trainer(group=...)`` all-reduces over the group; on the "sp"
axis each rank holds a depth slab of an oversized block and
``parallel/spatial.py`` exchanges halos over it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["pad_to_multiple", "shard_rows", "backend_for", "process_group"]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis=0):
    """Pad ``arr`` along ``axis`` to a multiple (shardable batch): (padded,
    the original length); the port's copy of the JAX helper. Nothing in
    the port calls it: the data-parallel trainer pads nothing
    (:func:`shard_rows` refuses an indivisible batch), and the spatial
    axis refuses an indivisible depth, where JAX's asserts that it divides
    (``pcc_geo_cnn_v2_tpu/parallel/spatial.py:84``, ``:135``)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad), n


def shard_rows(arr, rank, world):
    """Rank ``rank``'s rows of a global batch: the ``rank``-th of ``world``
    equal contiguous slices along the first axis (numpy or torch). A batch
    that ``world`` does not divide raises: a padded row would enter the
    loss."""
    n = len(arr)
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not divide over "
                         f"{world} ranks")
    per = n // world
    return arr[rank * per:(rank + 1) * per]


def backend_for(device, world):
    """``gloo`` on the CPU; on cards ``nccl`` when every rank has a card of
    its own, and ``gloo`` (which takes CUDA tensors) where ranks share a
    card: NCCL refuses two ranks on one device."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


@contextlib.contextmanager
def process_group(rank, world, init_method, device="cpu"):
    """Join the process group of ``world`` ranks as ``rank``; yields
    (group, this rank's device) and leaves the group on exit.

    :param init_method: where the ranks meet (``tcp://host:port`` or
        ``file://path``, a file that does not exist yet); nothing on the
        machine names a cluster, so the caller gives it.
    :param device: ``"cpu"``, or ``"cuda"``: rank r takes card
        ``r mod cards``, made its current device.
    """
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, world),
                            init_method=init_method, rank=rank,
                            world_size=world)
    try:
        yield dist.group.WORLD, device
    finally:
        dist.destroy_process_group()
