"""Spatial (sp) sharding (``parallel/spatial.py``) on the CPU, over gloo.

Four ranks in four processes hold the depth slabs of each input, in
groups of 1, 2 and 4 ranks; the test process gathers the slabs and holds
them against:

- JAX's sharded ops on a mesh of the same size over the conftest's
  virtual devices (``conv3d_spatial_sharded``,
  ``conv3d_transpose_spatial_sharded``; (kd, stride) of
  ``tests/test_spatial_sharding.py``, x ``[2, 32, 16, 16, 4]``) and the
  port's unsharded ``Conv`` / ``ConvTranspose``: within rtol = atol =
  1e-5, the bound of JAX's own tests;
- JAX's ``encode_syms_spatial`` at world 2 on the same weights (c3p from
  the committed ``bench_c3p``, 64 filters; c1 from ``assets/rd/c1``, whose
  k9 stride-2 conv takes halos of (3, 4)) and the port's unsharded
  ``encode_syms``: symbols differ in under 5e-4 of the places, JAX's bound
  (``tests/test_spatial_sharding.py:78``);
- JAX's ``decode_y_spatial`` on the port's symbols (c3p) and the port's
  unsharded decode (c3p, c1): x_hat within 1e-5.

The round trip codes the gathered symbols with the port's rANS coder,
decodes from the bytes alone (``decode_z`` unsharded) and decodes y
sharded: symbols equal, the decoder's x_hat bit-equal to the encoder's,
masks at 0.51 equal. At world 1 the sharded encode and decode equal the
unsharded ones bit for bit. Refusals: an indivisible depth, a ``concat``
model and a halo deeper than a slab raise on every rank; a model that
codes y in slices (c3p_cw) is refused by every entry point.
"""

import multiprocessing
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.parallel import spatial as jsp
from pcc_geo_cnn_v2_tpu.parallel.mesh import make_mesh
from pcc_geo_cnn_v2_tpu_torch.models.configs import MODEL_CONFIGS, build_model
from pcc_geo_cnn_v2_tpu_torch.models import transforms as tr
from pcc_geo_cnn_v2_tpu_torch.models.codec_models import CompressionModelV2
from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize
from pcc_geo_cnn_v2_tpu_torch.parallel import mesh, spatial
from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset, synthetic_blocks
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, params_from_jax

ASSETS = Path(__file__).resolve().parent.parent / "pcc_geo_cnn_v2_tpu/assets"
WEIGHTS = {"c3p": ASSETS / "bench_c3p.msgpack.gz",
           "c1": ASSETS / "rd/c1/2.00e-04.msgpack.gz"}
WORLD = 4
CASES = [(3, 1), (3, 2), (5, 2), (9, 2)]
X_SHAPE = (2, 32, 16, 16, 4)
RTOL = ATOL = 1e-5
SYM_MISMATCH = 5e-4
BLOCK, THR = 64, 0.51
JOIN_S = 600


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops_inputs():
    """x, and per case a cubic and a (kd, 3, 3) kernel (DHWIO), numpy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    kernels = {}
    for kd, s in CASES:
        for shape in ((kd, kd, kd), (kd, 3, 3)):
            kernels[kd, s, shape] = (
                rng.normal(size=shape + (4, 5)).astype(np.float32) * 0.1)
    bias = rng.normal(size=5).astype(np.float32)
    return x, kernels, bias


def _oidhw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


def _block():
    """A 64³ occupancy block (NDHWC f32), surface-like."""
    pts = BlockDataset(synthetic_blocks(1, BLOCK, seed=5, kind="mix"))._pack(
        np.arange(1))
    return voxelize(torch.from_numpy(pts), BLOCK).numpy()


def _model(name, **kw):
    model = build_model(name, **kw)
    if name in WEIGHTS:
        model.load_state_dict(params_from_jax(load_asset_tree(WEIGHTS[name])))
    return model.eval()


def _coding(model, x, group):
    """Sharded encode, the rANS round trip and the sharded decodes: the
    rank's slabs and the gathered symbols."""
    syms = spatial.encode_syms_spatial(model, spatial.depth_slab(
        torch.from_numpy(x), group), group)
    whole = {k: spatial.gather_depth(v, group) for k, v in syms.items()}
    strings = spatial.symbols_to_bytes(model, whole)
    x_hat = spatial.decode_y_spatial(model, syms["y_sym"], group)
    y_shape = tuple(whole["y_sym"].shape[1:])
    decoded = spatial.bytes_to_symbols(model, strings, y_shape)
    x_hat_dec = spatial.decode_y_spatial(
        model, spatial.depth_slab(decoded["y_sym"], group), group)
    return {"syms": {k: v.numpy() for k, v in whole.items()},
            "decoded": {k: v.numpy() for k, v in decoded.items()},
            "x_hat": x_hat.numpy(), "x_hat_dec": x_hat_dec.numpy(),
            "n_bytes": sum(len(s) for row in strings for s in row)}


def _unsharded(model, x):
    """The model's own encode and decode: symbols and x_hat, numpy."""
    with torch.no_grad():
        syms = model.encode_syms(torch.from_numpy(x))
        y = syms["y_sym"]
        x_hat = (model.decode_y(y) if isinstance(model, CompressionModelV2)
                 else model.decode(y))
    return {"syms": {k: v.numpy() for k, v in syms.items()},
            "x_hat": x_hat.numpy()}


def _concat_model():
    """An 8-filter V2 model with ``concat`` residual stacks."""
    model = build_model(dict(model="v2", num_filters=8,
                             analysis="AnalysisTransformV2",
                             synthesis="SynthesisTransformV2"))
    model.analysis_t = tr.AnalysisTransformV2(8, residual_mode="concat")
    model.synthesis_t = tr.SynthesisTransformV2(8, residual_mode="concat")
    return model


def _refusals(group):
    """What each refusal raises, by case (raised before any exchange)."""
    out = {}
    w = torch.zeros(5, 4, 9, 9, 9)
    cases = {
        "indivisible": lambda: spatial.conv3d_spatial_sharded(
            torch.zeros(1, 4, 3, 8, 8), w[..., :3, :3, :3], stride=2,
            group=group),
        "indivisible_block": lambda: spatial.encode_syms_spatial(
            build_model("c3"), torch.zeros(1, 8, 16, 16, 1), group),
        "slab": lambda: spatial.depth_slab(torch.zeros(1, 5, 4, 4, 1), group),
        "concat": lambda: spatial.encode_syms_spatial(
            _concat_model(), torch.zeros(1, 16, 16, 16, 1), group),
        "concat_decode": lambda: spatial.decode_y_spatial(
            _concat_model(), torch.zeros(1, 1, 2, 2, 8, dtype=torch.int32),
            group),
        "halo": lambda: spatial.conv3d_spatial_sharded(
            torch.zeros(1, 4, 2, 8, 8), w, stride=2, group=group),
        "halo_deconv": lambda: spatial.conv3d_transpose_spatial_sharded(
            torch.zeros(1, 4, 1, 8, 8), w, stride=2, group=group),
    }
    for name, fn in cases.items():
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _rank_main(rank, init_method, out_dir, x, kernels, bias, block):
    """One rank: the ops at world 2 and 4; the codings and the refusals at
    world 2 on ranks 0 and 1, the codings at world 1 on ranks 2 and 3."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))
    out = {"ops": {}}
    with mesh.process_group(rank, WORLD, init_method) as (world_group, _):
        # every rank takes part in making every group
        groups = {2: dist.new_group([0, 1]), 4: world_group}
        singles = {r: dist.new_group([r]) for r in (2, 3)}
        for world in (2, 4):
            group = groups[world]
            if rank >= world:
                continue
            x_l = spatial.depth_slab(_ncdhw(x), group, axis=2)
            for (kd, s, shape), k in kernels.items():
                b = torch.from_numpy(bias)
                out["ops"][world, "conv", kd, s, shape] = _ndhwc(
                    spatial.conv3d_spatial_sharded(x_l, _oidhw(k), b,
                                                   stride=s, group=group))
                if shape == (kd, kd, kd):
                    out["ops"][world, "deconv", kd, s, shape] = _ndhwc(
                        spatial.conv3d_transpose_spatial_sharded(
                            x_l, _oidhw(k), b, stride=s, group=group))
        if rank < 2:
            out["coding"] = {name: _coding(_model(name), block, groups[2])
                             for name in ("c3p", "c1")}
            out["refusals"] = _refusals(groups[2])
        if rank in singles:  # c3p on rank 2, c1 on rank 3, alone
            # beside the model's own encode and decode in this process:
            # oneDNN's sums depend on the thread count
            name = {2: "c3p", 3: "c1"}[rank]
            model = _model(name)
            out["world1"] = _coding(model, block, singles[rank])
            out["world1"]["unsharded"] = _unsharded(model, block)
        dist.barrier(world_group)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    x, kernels, bias = _ops_inputs()
    block = _block()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, f"file://{tmp}/rendezvous", str(tmp), x, kernels, bias, block))
        for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    assert not alive, "a rank did not finish"
    assert [p.exitcode for p in procs] == [0] * WORLD
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return dict(outs=outs, x=x, kernels=kernels, bias=bias, block=block)


def _gathered(outs, world, key):
    return np.concatenate([o["ops"][key] for o in outs[:world]], axis=1)


def _jax_params(name):
    return {"params": load_asset_tree(WEIGHTS[name])["params"]}


def _sp_mesh(world):
    return make_mesh(world, axes=("sp",))


def _jax_sharded(world, x, spec=("sp",)):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(x), NamedSharding(
        _sp_mesh(world), P(None, *spec)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kd, stride", CASES)
def test_sharded_conv_matches_jax_and_unsharded(ranks, world, kd, stride):
    x, bias = ranks["x"], ranks["bias"]
    for shape in ((kd, kd, kd), (kd, 3, 3)):
        k = ranks["kernels"][kd, stride, shape]
        got = _gathered(ranks["outs"], world,
                        (world, "conv", kd, stride, shape))
        want = np.asarray(jsp.conv3d_spatial_sharded(
            _sp_mesh(world), _jax_sharded(world, x), jnp.asarray(k),
            stride=stride)) + bias
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        if shape == (kd, kd, kd):
            layer = Conv(4, 5, kd, stride)
            layer.weight.data, layer.bias.data = _oidhw(k), torch.from_numpy(
                bias)
            with torch.no_grad():
                whole = _ndhwc(layer(_ncdhw(x)))
            np.testing.assert_allclose(got, whole, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kd, stride", CASES)
def test_sharded_deconv_matches_jax_and_unsharded(ranks, world, kd, stride):
    x, bias = ranks["x"], ranks["bias"]
    k = ranks["kernels"][kd, stride, (kd, kd, kd)]
    got = _gathered(ranks["outs"], world,
                    (world, "deconv", kd, stride, (kd, kd, kd)))
    want = np.asarray(jsp.conv3d_transpose_spatial_sharded(
        _sp_mesh(world), _jax_sharded(world, x), jnp.asarray(k),
        stride=stride)) + bias
    assert got.shape == want.shape == (2, 32 * stride, 16 * stride,
                                       16 * stride, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    layer = ConvTranspose(4, 5, kd, stride)
    layer.weight.data, layer.bias.data = _oidhw(k), torch.from_numpy(bias)
    with torch.no_grad():
        whole = _ndhwc(layer(_ncdhw(x)))
    np.testing.assert_allclose(got, whole, rtol=RTOL, atol=ATOL)


def _jax_encode(name, block):
    """JAX's sharded encode at world 2, jitted whole (eager, each layer
    builds and compiles its own ``shard_map``)."""
    model, mesh = jax_build(name), _sp_mesh(2)
    fn = jax.jit(lambda p, x: jsp.encode_syms_spatial(model, p, x, mesh))
    return {k: np.asarray(v) for k, v in fn(
        _jax_params(name), _jax_sharded(2, block)).items()}


@pytest.mark.parametrize("name", ["c3p", "c1"])
def test_encode_syms_spatial_matches_jax_and_unsharded(ranks, name):
    block = ranks["block"]
    a, b = (o["coding"][name]["syms"] for o in ranks["outs"][:2])
    for k in a:  # every rank gathered the same symbols
        assert np.array_equal(a[k], b[k]), k
    want_jax = _jax_encode(name, block)
    with torch.no_grad():
        want_port = {k: v.numpy() for k, v in _model(name).encode_syms(
            torch.from_numpy(block)).items()}
    assert sorted(a) == sorted(want_jax) == sorted(want_port)
    assert np.abs(a["y_sym"]).max() > 0  # the symbols carry the block
    for k in a:
        for want in (want_jax, want_port):
            assert a[k].shape == want[k].shape, k
            mismatch = np.mean(a[k] != want[k])
            assert mismatch < SYM_MISMATCH, (k, mismatch)


@pytest.mark.parametrize("name", ["c3p", "c1"])
def test_decode_y_spatial_matches_jax_and_unsharded(ranks, name):
    """c3p against JAX's sharded decode and the unsharded one; c1 (whose
    k9 stride-2 deconv XLA:CPU takes 20 s for as a dilated conv) against
    the unsharded one, its layers against JAX's in the op tests above."""
    got = np.concatenate([o["coding"][name]["x_hat"]
                          for o in ranks["outs"][:2]], axis=1)
    y_sym = ranks["outs"][0]["coding"][name]["syms"]["y_sym"]
    assert got.shape == (1, BLOCK, BLOCK, BLOCK, 1)
    if name == "c3p":
        model, mesh = jax_build(name), _sp_mesh(2)
        fn = jax.jit(lambda p, y: jsp.decode_y_spatial(model, p, y, mesh))
        want = np.asarray(fn(_jax_params(name), _jax_sharded(2, y_sym)))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    model = _model(name)
    with torch.no_grad():
        y = torch.from_numpy(y_sym)
        whole = (model.decode_y(y) if name == "c3p" else model.decode(y))
    np.testing.assert_allclose(got, whole.numpy(), rtol=0, atol=ATOL)
    assert (got > THR).sum() > 0


@pytest.mark.parametrize("name", ["c3p", "c1"])
def test_rans_round_trip_is_bit_exact(ranks, name):
    """Encoder: sharded encode → bytes, x_hat of the sharded decode.
    Decoder: the bytes alone → symbols (``decode_z`` unsharded) → the
    sharded decode."""
    for o in ranks["outs"][:2]:
        c = o["coding"][name]
        assert c["n_bytes"] > 0
        for k, v in c["syms"].items():
            assert np.array_equal(c["decoded"][k], v), k
        assert np.array_equal(c["x_hat_dec"], c["x_hat"])
        assert np.array_equal(c["x_hat_dec"] > THR, c["x_hat"] > THR)
    a, b = (o["coding"][name]["n_bytes"] for o in ranks["outs"][:2])
    assert a == b


@pytest.mark.parametrize("name", ["c3p", "c1"])
def test_world_one_is_the_unsharded_executable(ranks, name):
    """A group of one rank: zero halos, the very convs of the unsharded
    model, bit for bit."""
    c = ranks["outs"][{"c3p": 2, "c1": 3}[name]]["world1"]
    want = c["unsharded"]
    for k, v in want["syms"].items():
        assert np.array_equal(c["syms"][k], v), k
    assert np.array_equal(c["x_hat"], want["x_hat"])
    assert np.array_equal(c["x_hat_dec"], c["x_hat"])


@pytest.mark.parametrize("case, error, words", [
    ("indivisible", "ValueError", "does not divide"),
    ("indivisible_block", "ValueError", "not a multiple of 16"),
    ("slab", "ValueError", "does not divide"),
    ("concat", "NotImplementedError", "'concat'"),
    ("concat_decode", "NotImplementedError", "'concat'"),
    ("halo", "ValueError", "exceeds the slab's depth 2"),
    ("halo_deconv", "ValueError", "exceeds the slab's depth 1"),
])
def test_refusals_raise_on_every_rank(ranks, case, error, words):
    for o in ranks["outs"][:2]:
        got_error, msg = o["refusals"][case]
        assert got_error == error and words in msg, (case, got_error, msg)


@pytest.mark.parametrize("entry", ["encode_syms_spatial", "decode_y_spatial",
                                   "symbols_to_bytes", "bytes_to_symbols"])
def test_a_sliced_model_is_refused(entry):
    """c3p_cw's symbols are its slice chain's: the sp path, which would
    code them as c3p's, raises before any exchange (no group needed)."""
    model = build_model(dict(MODEL_CONFIGS["c3p_cw"], num_filters=8,
                             num_slices=2, slice_widths=(8, 8)))
    y = torch.zeros(1, 2, 2, 2, 8, dtype=torch.int32)
    args = {"encode_syms_spatial": (torch.zeros(1, 16, 16, 16, 1), None),
            "decode_y_spatial": (y, None),
            "symbols_to_bytes": ({"y_sym": y, "z_sym": y[:, :1, :1, :1]},),
            "bytes_to_symbols": ([(b"", b"")], (2, 2, 2, 8))}[entry]
    with pytest.raises(NotImplementedError, match="one slice, not 2"):
        getattr(spatial, entry)(model, *args)


def test_the_halo_widths_are_jax_s():
    """The (lo, hi) halos of the layers the models run: SAME pads for the
    convs (c1's k9 stride 2 on 64 planes: (3, 4)), JAX's input-space
    widths for the transposed convs, derived from the sub-pixel taps."""
    assert tr.same_pads(64, 9, 2) == jsp._same_pads(64, 9, 2) == (3, 4)
    for k, s in [(3, 1), (3, 2), (5, 2), (9, 2)]:
        pad_a, _ = tr.transpose_pads(k, s)
        assert (pad_a, _) == jsp._conv_transpose_padding(k, s)
        lo, hi = pad_a // s, max((k - 2 - pad_a) // s + 1, 0)
        # the taps of every parity class read inputs i + o0 .. i + o0 +
        # len(taps) - 1: exactly [i - lo, i + hi] over the classes
        reach = [(o0, o0 + len(taps) - 1) for taps, o0 in (
            tr._parity_taps(k, s, pad_a, r) for r in range(s)) if taps]
        assert min(a for a, _ in reach) == -lo
        assert max(b for _, b in reach) == hi
