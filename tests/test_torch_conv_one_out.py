"""``conv_one_out``: the synthesis transforms' last layer (one output
channel) on the card's hand-written kernel, tested here without a card.

- the route (``conv_one_out.routes``): every excluded case keeps
  ``ConvTranspose``'s own path;
- the geometry the wrapper packs the weights for (per parity class: first
  tap, tap count, input offset; the halo) against ``_parity_taps`` /
  ``transpose_pads``, and the shapes instantiated in the source;
- the plain version, which sums in the kernel's order, against
  ``F.conv_transpose3d`` with the flipped kernel (the benchmark reference's
  form), whole and on a depth slab extended by a halo;
- the ``KERNELS`` entry, its argtypes against the C signature, and the
  kernel's name in the benchmark's convolution family.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.models import transforms as ttr
from pcc_geo_cnn_v2_tpu_torch.ops import conv_one_out as coo
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
SOURCE = kernels.CSRC / "conv_one_out.cu"
LAYERS = [(9, 2, 32), (3, 1, 16)]  # c1 / c2 and c3 / c3p
OTHER = [(5, 2, 3), (3, 2, 4)]     # the same geometry at other shapes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file: test files run in parallel
    worker processes, and torch's default of a thread a core oversubscribes
    the CPU many times over on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class OnCard:
    """A CPU tensor that says it is on a card: the predicate reads only
    attributes, so each condition can be tested without one."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _operands(k, s, cin, n=2, size=(4, 4, 8), cout=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, cin, *size), generator=g)
    w = torch.randn((cout, cin, k, k, k), generator=g) / (cin * k) ** 0.5
    return x, w, torch.randn((cout,), generator=g)


@pytest.mark.parametrize("shape", LAYERS)
def test_route_taken_by_an_instantiated_layer_without_a_graph(shape):
    k, s, cin = shape
    x, w, _ = _operands(k, s, cin)
    with torch.no_grad():
        assert coo.routes(OnCard(x), w, s)
    assert not coo.routes(OnCard(x), w, s)  # a graph is being recorded


@pytest.mark.parametrize("case", ["grad", "bf16_x", "bf16_w", "cpu",
                                  "channels_last", "cout2", "odd_width",
                                  "unaligned"])
@pytest.mark.parametrize("shape", LAYERS)
def test_route_excludes(shape, case):
    """Each excluded case alone keeps the old path."""
    k, s, cin = shape
    x, w, _ = _operands(k, s, cin, cout=2 if case == "cout2" else 1,
                        size=(4, 4, 7) if case == "odd_width" else (4, 4, 8))
    if case == "bf16_x":
        x = x.bfloat16()
    elif case == "bf16_w":
        w = w.bfloat16()
    elif case == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    elif case == "unaligned":  # a contiguous view one float in
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16
    arg = x if case == "cpu" else OnCard(x)
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    with grad:
        assert not coo.routes(arg, w, s)


@pytest.mark.parametrize("shape", [(5, 2, 32), (9, 2, 16), (3, 1, 32),
                                   (3, 2, 16), (9, 1, 32)])
def test_route_excludes_shapes_not_instantiated(shape):
    k, s, cin = shape
    x, w, _ = _operands(k, s, cin)
    with torch.no_grad():
        assert not coo.routes(OnCard(x), w, s)


@pytest.fixture
def on_card(monkeypatch):
    """``routes`` reading CPU tensors as on a card, and the wrapper's calls
    recorded: the module then takes the wrapper, whose CPU version is the
    plain one."""
    calls = []
    routes, wrapper = coo.routes, coo.conv_transpose_one_out

    def spy(*args, **kw):
        calls.append(args)
        return wrapper(*args, **kw)

    monkeypatch.setattr(coo, "routes",
                        lambda x, w, s: routes(OnCard(x), w, s))
    monkeypatch.setattr(coo, "conv_transpose_one_out", spy)
    return calls


@pytest.mark.parametrize("shape", LAYERS)
def test_module_takes_the_kernel_only_where_routed(on_card, shape):
    k, s, cin = shape
    x, w, b = _operands(k, s, cin)
    layer = ttr.ConvTranspose(cin, 1, k, s)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        got = layer(x)
    assert len(on_card) == 1
    want = coo.conv_transpose_one_out_plain(x, coo.pack_weights(w, s), b, k,
                                            s)
    assert torch.equal(got, want)
    # recording a graph, or in bf16: the sub-pixel / cuDNN form
    old = layer(x)
    assert len(on_card) == 1 and old.requires_grad
    np.testing.assert_allclose(old.detach().numpy(), got.numpy(), rtol=0,
                               atol=1e-5 * float(got.abs().max()))
    with torch.no_grad():
        layer(x, dtype=torch.bfloat16)
    assert len(on_card) == 1


def test_module_packs_its_table_once_a_weight_version(on_card):
    x, w, b = _operands(3, 1, 16)
    layer = ttr.ConvTranspose(16, 1, 3, 1)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer(x)
        table = layer._one_out_table(layer.weight)
        layer(x)
        assert layer._one_out_table(layer.weight) is table
        layer.weight.mul_(2)  # a write: packed anew
        again = layer._one_out_table(layer.weight)
    assert again is not table
    assert torch.equal(again, 2 * table)


def parity_classes(k, s):
    """Per parity class r: (first tap, tap count, input offset of the first
    tap) as the kernel's table reads them — the form of ``_parity_taps`` —
    and the input halo (below, above)."""
    table = coo.tap_table(k, s)
    dmin, _, _ = coo.geometry(k, s)
    out = []
    for r in range(s):
        dd = np.flatnonzero(table[:, r] >= 0)
        out.append((int(table[dd[0], r]), len(dd), int(dd[0]) + dmin))
    return out, (-dmin, len(table) - 1 + dmin)


@pytest.mark.parametrize("shape", LAYERS + OTHER)
def test_parity_classes_match_parity_taps(shape):
    """Per parity class r the table reads the taps ``_parity_taps`` gives,
    from the same input offset; the halo is the sp path's."""
    k, s, _ = shape
    pad_a, pad_b = ttr.transpose_pads(k, s)
    classes, halo = parity_classes(k, s)
    table = coo.tap_table(k, s)
    for r, (first, count, offset) in enumerate(classes):
        taps, o0 = ttr._parity_taps(k, s, pad_a, r)
        assert (first, count, offset) == (taps[0], len(taps), o0)
        assert [int(m) for m in table[:, r] if m >= 0] == taps
    assert halo == (pad_a // s, max((k - 2 - pad_a) // s + 1, 0))
    dmin, nt, gw = coo.geometry(k, s)
    assert (dmin, nt) == (-halo[0], halo[0] + halo[1] + 1)
    assert gw % 4 == 0 and nt * s <= gw < nt * s + 4


def test_geometry_of_the_instantiated_layers():
    """k9 s2: offsets -2..2, classes of 4 and 5 taps (9 a dimension, 729
    products an input voxel and channel); k3 s1: offsets -1..1."""
    assert coo.geometry(9, 2) == (-2, 5, 12)
    assert parity_classes(9, 2) == ([(1, 4, -2), (0, 5, -2)], (2, 2))
    assert coo.geometry(3, 1) == (-1, 3, 4)
    assert parity_classes(3, 1) == ([(0, 3, -1)], (1, 1))


def test_source_instantiates_the_shapes():
    """``SHAPES`` are the source's ``PCC_ONE_OUT_SHAPES`` instances."""
    text = SOURCE.read_text()
    body = text[text.index("#define PCC_ONE_OUT_SHAPES"):]
    body = body[:body.index("\n\n")]
    got = {tuple(int(v) for v in m.split(",")[:3])
           for m in re.findall(r"X\(([^)]*)\)", body)}
    assert got == coo.SHAPES


@pytest.mark.parametrize("shape", LAYERS + OTHER)
def test_pack_weights(shape):
    k, s, cin = shape
    _, w, _ = _operands(k, s, cin, seed=3)
    dmin, nt, gw = coo.geometry(k, s)
    table = coo.pack_weights(w, s)
    assert table.shape == (cin, nt, nt, s, s, gw) and table.is_contiguous()
    assert not table[..., nt * s:].any()
    taps = coo.tap_table(k, s)
    for dd, dh, dw in np.ndindex(nt, nt, nt):
        for rd, rh, rw in np.ndindex(s, s, s):
            m = (taps[dd, rd], taps[dh, rh], taps[dw, rw])
            got = table[:, dd, dh, rd, rh, dw * s + rw]
            if min(m) < 0:
                assert not got.any()
            else:
                assert torch.equal(got, w[0, :, m[0], m[1], m[2]])


def _reference(x, w, b, k, s):
    """``F.conv_transpose3d`` of the flipped kernel, cropped to the flax
    length, in float64 (the benchmark reference's form), and the same of
    |x|, |w|: the size of the sum each output is."""
    pad_a, pad_b = ttr.transpose_pads(k, s)
    wt = w.double().flip(2, 3, 4).transpose(0, 1)
    outs = [(m - 1) * s + pad_a + pad_b - k + 2 for m in x.shape[2:]]

    def ct(a, wk, bias):
        y = F.conv_transpose3d(a, wk, bias, s, k - 1 - pad_a)
        return y[:, :, :outs[0], :outs[1], :outs[2]]

    return ct(x.double(), wt, b.double()), ct(x.double().abs(), wt.abs(),
                                              None) + b.double().abs()


@pytest.mark.parametrize("size", [(4, 4, 8), (5, 3, 6)])
@pytest.mark.parametrize("shape", LAYERS + OTHER)
def test_plain_version_matches_conv_transpose3d(shape, size):
    """The plain version (the kernel's loop order) is the layer: within f32
    rounding of the size of each output's sum."""
    k, s, cin = shape
    x, w, b = _operands(k, s, cin, size=size, seed=1)
    table = coo.pack_weights(w, s)
    got = coo.conv_transpose_one_out_plain(x, table, b, k, s)
    want, size_of_sum = _reference(x, w, b, k, s)
    assert got.shape == want.shape == (2, 1, *(s * m for m in size))
    assert ((got.double() - want).abs() <= 1e-5 * size_of_sum).all()


@pytest.mark.parametrize("shape", LAYERS)
def test_plain_version_on_a_slab_with_its_halo(shape):
    """A depth slab extended by halo planes, read with ``shift``: the slab's
    outputs of the whole layer, bit for bit (the sp path's call)."""
    k, s, cin = shape
    x, w, b = _operands(k, s, cin, size=(6, 4, 8), seed=2)
    table = coo.pack_weights(w, s)
    whole = coo.conv_transpose_one_out_plain(x, table, b, k, s)
    lo, hi = parity_classes(k, s)[1]
    for d0, d1 in ((0, 3), (3, 6)):
        ext = F.pad(x, (0, 0, 0, 0, lo, hi))[:, :, d0:d1 + lo + hi]
        part = coo.conv_transpose_one_out_plain(
            ext.contiguous(), table, b, k, s,
            outs=(s * (d1 - d0), s * 4, s * 8), shift=lo)
        assert torch.equal(part, whole[:, :, s * d0:s * d1])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, w, b = _operands(9, 2, 32)
    table = coo.pack_weights(w, 2)
    assert torch.equal(
        coo.conv_transpose_one_out(x, table, b, 9, 2),
        coo.conv_transpose_one_out_plain(x, table, b, 9, 2))


def test_kernels_entry_and_argtypes():
    """The registry entry and its argtypes against the C signatures: a
    pointer where the source has one, an int where it has an int."""
    src, fns = kernels.KERNELS["conv_one_out"]
    assert src == SOURCE.name
    p, i = kernels._P, kernels._I
    assert fns == {"pcc_conv_one_out": [p] * 4 + [i] * 11 + [p],
                   "pcc_conv_one_out_geometry": [i, i, i, p]}
    text = SOURCE.read_text()
    for fn, argtypes in fns.items():
        sig = re.search(rf"int {fn}\(([^)]*)\)", text).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == len(argtypes), fn
        for param, t in zip(params, argtypes):
            assert ("*" in param) == (t is p), (fn, param)
    assert "conv_one_out" in kernels.launches
    # one fixed summation order: no atomic operation
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", text)
    assert "Replaces no Pallas TPU kernel" in text
    assert "torch/" not in text and "ATen" not in text  # builds in seconds
    assert 'extern "C"' in text


def test_kernel_name_is_in_the_convolution_family():
    """The benchmark counts the kernel's device time as convolution time
    (``conv_roofline.*`` divides every layer's work by it)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from benchlib.tracing import family

    text = SOURCE.read_text()
    names = re.findall(r"^(\w+)\(const __grid_constant__", text, re.M)
    assert names == ["conv_one_out_convolve"]
    assert text.count("__global__") == 1
    assert family(names[0]) == "convolution"
    assert family(f"void (anonymous namespace)::{names[0]}<9, 2, 32, 8, "
                  f"32, 2, 2>(CUtensorMap, float const*)") == "convolution"
