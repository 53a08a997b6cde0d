"""Initial weights for a training cell, made on the device from the seed in
a few large draws: flax's initial distributions (conv kernels
``lecun_normal``: a normal truncated to ±2 standard deviations with
variance 1 / fan_in; biases 0; the factorized prior's matrices
log(expm1(1 / scale / rows)), its biases U(-0.5, 0.5), its factors 0 and
its quantiles (-10, 0, 10)), over the leaf shapes of the configuration's
weight file.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["init_tree"]

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2
_INIT_SCALE = 10.0


def _paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.shape(v)


def init_tree(shapes_tree, seed, device):
    """A tree shaped like ``shapes_tree`` (numpy leaves) of float32 tensors
    on ``device``, drawn from ``seed``."""
    import torch

    leaves = list(_paths(shapes_tree))
    kernels = [(p, s) for p, s in leaves if p[-1] == "kernel"]
    eb_bias = [(p, s) for p, s in leaves
               if p[0] == "entropy_bottleneck" and p[-1].startswith("bias_")]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_k = sum(math.prod(s) for _, s in kernels)
    n_b = sum(math.prod(s) for _, s in eb_bias)
    lo = 0.5 * math.erfc(2 / math.sqrt(2))  # Φ(-2)
    u = torch.rand(n_k, generator=g, device=device, dtype=torch.float64)
    normal = (math.sqrt(2) * torch.special.erfinv(
        2 * (lo + u * (1 - 2 * lo)) - 1)).float()
    uniform = torch.rand(n_b, generator=g, device=device) - 0.5
    out = {}

    def put(path, value):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    at = 0
    for p, s in kernels:
        n = math.prod(s)
        std = math.sqrt(1.0 / math.prod(s[:-1])) / _TRUNC_STD
        put(p, (normal[at:at + n] * std).view(s))
        at += n
    at = 0
    for p, s in eb_bias:
        n = math.prod(s)
        put(p, uniform[at:at + n].view(s).clone())
        at += n
    n_layers = sum(1 for p, _ in leaves if p[0] == "entropy_bottleneck"
                   and p[-1].startswith("matrix_"))
    scale = _INIT_SCALE ** (1.0 / n_layers)
    for p, s in leaves:
        if p[-1] == "bias" and p[0] != "entropy_bottleneck":
            put(p, torch.zeros(s, device=device))
        elif p[-1].startswith("matrix_"):
            put(p, torch.full(s, math.log(math.expm1(1.0 / scale / s[1])),
                              device=device))
        elif p[-1].startswith("factor_"):
            put(p, torch.zeros(s, device=device))
        elif p[-1] == "quantiles":
            put(p, torch.tensor([-_INIT_SCALE, 0.0, _INIT_SCALE],
                                device=device).expand(s).contiguous())
    return out
