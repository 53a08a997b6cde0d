"""The port's msgpack asset reader and JAX → torch parameter mapping."""

import gzip
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.weights import (
    load_asset_tree,
    msgpack_restore,
    params_from_jax,
)

ASSETS = Path(__file__).resolve().parent.parent / "pcc_geo_cnn_v2_tpu/assets"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("asset", ["bench_c3p.msgpack.gz",
                                   "rd/c3p-a0.75/3.00e-04.msgpack.gz",
                                   "rd/c1/1.00e-05.msgpack.gz"])
def test_reader_matches_flax_msgpack_restore(asset):
    raw = gzip.decompress((ASSETS / asset).read_bytes())
    ref = dict(_leaves(serialization.msgpack_restore(raw)))
    got = dict(_leaves(msgpack_restore(raw)))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


def test_params_from_jax_fills_c3p_exactly():
    model = build_model("c3p")
    state = params_from_jax(load_asset_tree(ASSETS / "bench_c3p.msgpack.gz"))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict: every shape matches too


def test_msgpack_scalars_and_containers():
    """Non-array msgpack types the reader must also decode."""
    import msgpack

    obj = {"a": [1, -3, 300, -70000, 2 ** 40, 1.5, None, True, False],
           "s": "x" * 40, "b": b"\x00\x01", "nested": {"m": {}}}
    assert msgpack_restore(msgpack.packb(obj, use_bin_type=True)) == obj
    scalar = serialization.msgpack_serialize({"v": np.float32(2.5)})
    assert msgpack_restore(scalar)["v"] == np.float32(2.5)
    with pytest.raises(ValueError):
        msgpack_restore(msgpack.packb(obj)[:-1])


def test_kernels_become_oidhw_unflipped():
    """Conv and ConvTranspose kernels map alike: DHWIO → OIDHW, no flip
    (the port computes flax's transposed conv as a correlation)."""
    k = np.arange(27 * 2 * 3, dtype=np.float32).reshape(3, 3, 3, 2, 3)
    st = params_from_jax({"ConvTranspose_0": {"kernel": k},
                          "Conv_0": {"kernel": k}})
    for w in (st["ConvTranspose_0.weight"], st["Conv_0.weight"]):
        assert tuple(w.shape) == (3, 2, 3, 3, 3)
        assert w.dtype == torch.float32
        assert w[2, 1, 0, 1, 2] == k[0, 1, 2, 1, 2]
