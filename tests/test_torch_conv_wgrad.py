"""``conv_wgrad``: training's stride-1 k3 weight gradients on the card's
hand-written kernel, tested here without a card.

- the route (``conv_wgrad.routes``): every excluded case keeps the
  layer's own path;
- the plain version, which sums in the kernel's split and order, against
  ``torch.nn.grad.conv3d_weight`` (ragged volumes included), its split
  against a position-by-position map of the slots, and two calls
  bit-equal;
- the autograd function's input, weight and bias gradients against
  autograd of ``F.conv3d``, alone and inside ``Conv`` / ``ConvTranspose``;
- the ``KERNELS`` entry, its argtypes against the C signature, the shapes
  and constants of the source, and every kernel name in the benchmark's
  convolution family.
"""

import re
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.models import transforms as ttr
from pcc_geo_cnn_v2_tpu_torch.ops import conv_wgrad as cw
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
SOURCE = kernels.CSRC / "conv_wgrad.cu"
LAYERS = sorted(cw.SHAPES)  # (cin, cout)
SIZES = [((5, 6, 37), 2), ((8, 4, 32), 1), ((3, 3, 9), 3)]  # ragged first


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


def _operands(cin, cout, size=(4, 5, 8), n=2, seed=0):
    """x [n, cin, *size], its padded xp, dy [n, cout, *size], weight (which
    requires its gradient) and bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, cin, *size), generator=g)
    dy = torch.randn((n, cout, *size), generator=g)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g)
         / (27 * cin) ** 0.5).requires_grad_()
    return x, F.pad(x, (1, 1) * 3), dy, w, torch.randn((cout,), generator=g)


def _slot_of(cin, cout, n, size):
    """``[n, D, H, W]`` int64: the slot of partials each position's
    products go to (CTA × groups + group), position by position: the
    kernel's split written independently of ``_partials_plain``."""
    td, th, tw, groups = cw.geometry(cin, cout)
    d, h, w = size
    nd, nh, nw = -(-d // td), -(-h // th), -(-w // tw)
    total, ctas = n * nd * nh * nw, cw._ctas(cin, cout, n, size)
    ar = [torch.arange(m) for m in (n, d, h, w)]
    ni, di, hi, wi = torch.meshgrid(*ar, indexing="ij")
    t = ((ni * nd + di // td) * nh + hi // th) * nw + wi // tw
    # the CTA b with ⌊T·b / ctas⌋ <= t < ⌊T·(b + 1) / ctas⌋
    b = (ctas * (t + 1) - 1) // total
    seg = ((di % td) * th + hi % th) * (tw // cw.SEG) + (wi % tw) // cw.SEG
    return b * groups + seg % groups


@pytest.mark.parametrize("layout", ["ncdhw", "channels_last"])
@pytest.mark.parametrize("shape", LAYERS)
def test_route_taken_in_training_only(shape, layout):
    """Either contiguous layout: the analysis transforms run channels-last
    (cuDNN keeps the layout of their one-channel input)."""
    x, _, _, w, _ = _operands(*shape)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last_3d)
        assert not x.is_contiguous()
    assert cw.routes(OnCard(x), w, 3, 1)
    with torch.no_grad():
        assert not cw.routes(OnCard(x), w, 3, 1)


@pytest.mark.parametrize("case", ["no_grad", "frozen", "cpu", "bf16_x",
                                  "bf16_w", "f64", "k5", "s2",
                                  "non_contiguous"])
@pytest.mark.parametrize("shape", LAYERS)
def test_route_excludes(shape, case):
    """Each excluded case alone keeps the layer's own path."""
    x, _, _, w, _ = _operands(*shape)
    k, s = (5 if case == "k5" else 3), (2 if case == "s2" else 1)
    if case == "frozen":
        w = w.detach()
    elif case == "bf16_x":
        x = x.bfloat16()
    elif case == "bf16_w":
        w = w.detach().bfloat16().requires_grad_()
    elif case == "f64":
        x, w = x.double(), w.detach().double().requires_grad_()
    elif case == "non_contiguous":
        x = x.transpose(3, 4)
    arg = x if case == "cpu" else OnCard(x)
    grad = torch.no_grad() if case == "no_grad" else torch.enable_grad()
    with grad:
        assert not cw.routes(arg, w, k, s)


@pytest.mark.parametrize("shape", [(16, 32), (32, 16), (64, 64), (1, 16),
                                   (32, 1), (48, 32)])
def test_route_excludes_channels_not_instantiated(shape):
    x, _, _, w, _ = _operands(*shape, size=(2, 2, 4))
    assert not cw.routes(OnCard(x), w, 3, 1)


@pytest.mark.parametrize("size,n", SIZES)
@pytest.mark.parametrize("shape", LAYERS)
def test_plain_version_matches_conv3d_weight(shape, size, n):
    cin, cout = shape
    _, xp, dy, _, _ = _operands(cin, cout, size, n)
    got = cw.conv3d_wgrad_plain(xp, dy)
    want = torch.nn.grad.conv3d_weight(xp.double(), (cout, cin, 3, 3, 3),
                                       dy.double())
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 1e-6, err


@pytest.mark.parametrize("size,n", SIZES[:2])
@pytest.mark.parametrize("shape", LAYERS)
def test_plain_split_is_the_slot_map(shape, size, n):
    """Each slot of partials holds the products of the positions that
    ``_slot_of`` gives it (tiles to CTAs, segments to groups), summed here
    position by position in f64."""
    cin, cout = shape
    _, xp, dy, _, _ = _operands(cin, cout, size, n, seed=1)
    part = cw._partials_plain(xp, dy)
    slot = _slot_of(cin, cout, n, size).reshape(-1)
    td, th, tw, groups = cw.geometry(cin, cout)
    assert len(part) == min(cw.tiles(cin, cout, n, size), cw.CTAS) * groups
    assert int(slot.max()) < len(part)
    want = torch.zeros((len(part), cout * cin, 27), dtype=torch.float64)
    for tap in range(27):
        a, b, c = tap // 9, tap // 3 % 3, tap % 3
        xs = xp[:, :, a:a + size[0], b:b + size[1], c:c + size[2]]
        prod = torch.einsum("nkdhw,ncdhw->ndhwkc", dy.double(), xs.double())
        want[:, :, tap].index_add_(0, slot, prod.reshape(-1, cout * cin))
    want = want.reshape(len(part), -1)
    err = float((part.double() - want).abs().max() / want.abs().max())
    assert err < 1e-6, err


def test_slot_map_splits_tiles_into_contiguous_ranges():
    """CTA b takes tiles [T·b // ctas, T·(b + 1) // ctas): with more tiles
    than CTAs, every CTA gets ⌊T / ctas⌋ or one more, in order."""
    cin, cout, n, size = 16, 16, 4, (64, 64, 64)
    total = cw.tiles(cin, cout, n, size)
    assert total > cw.CTAS
    slot = _slot_of(cin, cout, n, size)
    groups = cw.geometry(cin, cout)[3]
    cta = (slot // groups).reshape(-1)
    counts = torch.bincount(cta, minlength=cw.CTAS)
    assert len(counts) == cw.CTAS
    per_tile = 4 * 2 * 32  # positions a tile
    assert set((counts // per_tile).tolist()) == {total // cw.CTAS,
                                                  total // cw.CTAS + 1}
    assert torch.equal(counts % per_tile, torch.zeros_like(counts))


@pytest.mark.parametrize("shape", LAYERS)
def test_plain_version_twice_is_bit_equal(shape):
    _, xp, dy, _, _ = _operands(*shape, size=(5, 6, 37))
    assert torch.equal(cw.conv3d_wgrad_plain(xp, dy),
                       cw.conv3d_wgrad_plain(xp, dy))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    _, xp, dy, _, _ = _operands(16, 16)
    assert torch.equal(cw.conv3d_wgrad(xp, dy),
                       cw.conv3d_wgrad_plain(xp, dy))


def test_wrapper_refuses_an_input_that_is_not_padded():
    x, _, dy, _, _ = _operands(16, 16)
    with pytest.raises(ValueError, match="padded"):
        cw.conv3d_wgrad(x, dy)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", LAYERS)
def test_function_gradients_match_autograd_of_conv3d(shape, bias):
    """Forward bit-equal; input and bias gradients bit-equal (the same
    ``convolution_backward`` computes them); the weight gradient within
    f32 rounding of the sums."""
    x, _, dy, w, b = _operands(*shape, size=(5, 6, 9))
    b = b.requires_grad_() if bias else None
    outs = []
    for fn in (cw.conv3d, F.conv3d):
        xg = x.clone().requires_grad_()
        wg = w.detach().clone().requires_grad_()
        bg = None if b is None else b.detach().clone().requires_grad_()
        y = fn(F.pad(xg, (1, 1) * 3), wg, bg)
        y.backward(dy)
        outs.append((y.detach(), xg.grad, wg.grad,
                     None if bg is None else bg.grad))
    (y, dx, dw, db), (y0, dx0, dw0, db0) = outs
    assert torch.equal(y, y0)
    assert torch.equal(dx, dx0)
    assert (db is None and db0 is None) or torch.equal(db, db0)
    err = float((dw - dw0).abs().max() / dw0.abs().max())
    assert err < 1e-5, err


def test_function_without_an_input_gradient():
    _, xp, dy, w, _ = _operands(16, 16)
    y = cw.conv3d(xp, w)
    y.backward(dy)
    want = torch.nn.grad.conv3d_weight(xp, w.shape, dy)
    assert xp.grad is None
    assert float((w.grad - want).abs().max() / want.abs().max()) < 1e-5


@pytest.fixture
def on_card(monkeypatch):
    """``routes`` reading CPU tensors as on a card, and the wrapper's calls
    recorded: the layers then take the autograd function, whose backward
    takes the plain version on the CPU."""
    calls = []
    routes, wrapper = cw.routes, cw.conv3d_wgrad

    def spy(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(cw, "routes",
                        lambda x, w, k, s: routes(OnCard(x), w, k, s))
    monkeypatch.setattr(cw, "conv3d_wgrad", spy)
    return calls


@pytest.mark.parametrize("layout", ["ncdhw", "channels_last"])
@pytest.mark.parametrize("layer_cls", [ttr.Conv, ttr.ConvTranspose])
@pytest.mark.parametrize("shape", LAYERS)
def test_layers_take_the_function_only_where_routed(on_card, layer_cls,
                                                    shape, layout):
    cin, cout = shape
    x, _, dy, w, b = _operands(cin, cout, size=(4, 6, 8))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last_3d)
        dy = dy.contiguous(memory_format=torch.channels_last_3d)
    grads = []
    for routed in (True, False):
        layer = layer_cls(cin, cout, 3, 1)
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.copy_(b)
        xg = x.clone().requires_grad_()
        if not routed:  # a frozen weight keeps cuDNN's path
            layer.weight.requires_grad_(False)
        y = layer(xg)
        y.backward(dy)
        grads.append((y.detach(), xg.grad, layer.bias.grad))
        assert len(on_card) == 1
        if routed:
            dw = layer.weight.grad
    (y, dx, db), (y0, dx0, db0) = grads
    assert torch.equal(y, y0) and torch.equal(dx, dx0)
    assert torch.equal(db, db0)
    want = torch.nn.grad.conv3d_weight(F.pad(x, (1, 1) * 3), w.shape, dy)
    assert float((dw - want).abs().max() / want.abs().max()) < 1e-5
    with torch.no_grad():  # the codec's passes record no graph
        layer_cls(cin, cout, 3, 1)(x)
    assert len(on_card) == 1


def test_kernels_entry_and_argtypes():
    """The registry entry and its argtypes against the C signatures: a
    pointer where the source has one, an int where it has an int."""
    src, fns = kernels.KERNELS["conv_wgrad"]
    assert src == SOURCE.name
    p, i = kernels._P, kernels._I
    assert fns == {"pcc_conv_wgrad": [p] * 4 + [i] * 7 + [p],
                   "pcc_conv_wgrad_geometry": [i, i, p]}
    text = SOURCE.read_text()
    for fn, argtypes in fns.items():
        sig = re.search(rf"int {fn}\(([^)]*)\)", text).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == len(argtypes), fn
        for param, t in zip(params, argtypes):
            assert ("*" in param) == (t is p), (fn, param)
    assert "conv_wgrad" in kernels.launches
    # one fixed summation order: no atomic operation
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", text)
    assert "Replaces no Pallas TPU kernel" in text
    assert "torch/" not in text and "ATen" not in text  # builds in seconds
    assert 'extern "C"' in text


def test_source_instantiates_the_shapes_and_constants():
    """``PCC_WGRAD_SHAPES`` and the split's constants are the wrapper's."""
    text = SOURCE.read_text()
    block = re.search(r"#define PCC_WGRAD_SHAPES\(X\)(.*?)\n\n", text,
                      re.S).group(1)
    shapes = {(int(a), int(b)): (int(c), int(d)) for a, b, c, d in
              re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", block)}
    assert shapes == cw._TILES
    for name, value in (("THREADS", cw.THREADS), ("V", cw.SEG),
                        ("TW", cw.TW), ("CTAS", cw.CTAS),
                        ("RED_WARPS", cw.SUM_RANGES)):
        assert re.search(rf"constexpr int {name} = {value};", text), name


@pytest.mark.parametrize("shape", LAYERS)
def test_geometry_fills_the_cta(shape):
    """Groups × threads a group is the CTA; every group takes as many
    segments of a tile."""
    cin, cout = shape
    td, th, tw, groups = cw.geometry(cin, cout)
    per_group = cout // min(cout, 4) * cin
    assert groups * per_group == cw.THREADS
    assert td * th * (tw // cw.SEG) % groups == 0


def test_kernel_names_are_in_the_convolution_family():
    """The benchmark counts the kernels' device time as convolution time
    (``conv_roofline.train`` divides every layer's work by it)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from benchlib.tracing import family

    text = SOURCE.read_text()
    names = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text)
    assert names == ["conv_wgrad_partials", "conv_wgrad_sum"]
    assert text.count("__global__") == len(names)
    for name in names:
        assert "wgrad" in name
        assert family(name) == "convolution"
        assert family(f"void (anonymous namespace)::{name}<16, 16, 4, 2, "
                      f"8, 16>(float const*, float const*, float*, int, "
                      f"int, int, int, int, int, long long)") == "convolution"
