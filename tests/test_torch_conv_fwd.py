"""``conv_fwd``: the codec's stride-1 k3 synthesis tails on the card's
hand-written kernel, tested here without a card (and on one, ``-m card``).

- the route (``conv_fwd.routes``): every excluded case keeps the layer's
  own path;
- the weight table against its index formula;
- the plain version, which sums in the kernel's order, against
  ``F.conv3d`` at every instantiated channel pair, with bias, with and
  without the fused ReLU, on ragged volumes;
- ``Conv`` / ``ConvTranspose`` at stride 1 and the residual blocks: the
  same values through the route (the plain version on the CPU) as through
  their cuDNN path, and the weight table packed once a weight version;
- the ``KERNELS`` entry, its argtypes against the C signature, the
  instantiated shapes, and the kernel's name in the benchmark's
  convolution family;
- on a card: the kernel bit-equal to ``F.conv3d`` under
  ``codec.deterministic_convs()`` at each routed shape, batch invariance,
  and the launches of a ``decode_y`` chunk.
"""

import re
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.models import transforms as ttr
from pcc_geo_cnn_v2_tpu_torch.ops import conv_fwd as cf
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
SOURCE = kernels.CSRC / "conv_fwd.cu"
PAIRS = sorted(cf.INSTANCES)  # (cin, cout)
ROUTED = sorted(cf.SHAPES)    # (cin, cout, volume)
SIZES = [(4, 4, 8), (5, 3, 12), (3, 7, 4)]  # ragged along d and h
PLAIN_SIZES = SIZES + [(5, 3, 6)]  # and along w (no tensor map there)


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


def _operands(cin, cout, size=(4, 4, 8), n=2, seed=0, k=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, cin, *size), generator=g)
    w = torch.randn((cout, cin, k, k, k), generator=g) / (27 * cin) ** 0.5
    return x, w, torch.randn((cout,), generator=g)


def _routed_input(shape):
    """An uninitialised input of a routed (cin, cout, volume), and the
    layer's weight."""
    cin, cout, volume = shape
    return torch.empty((1, cin, *volume)), torch.zeros((cout, cin, 3, 3, 3))


@pytest.mark.parametrize("shape", ROUTED)
def test_route_taken_by_a_routed_shape_without_a_graph(shape):
    x, w = _routed_input(shape)
    with torch.no_grad():
        assert cf.routes(OnCard(x), w, 3, 1)
    assert not cf.routes(OnCard(x), w, 3, 1)  # a graph is being recorded


@pytest.mark.parametrize("case", ["grad", "bf16_x", "bf16_w", "cpu",
                                  "channels_last", "k5", "stride2",
                                  "unaligned"])
@pytest.mark.parametrize("shape", ROUTED)
def test_route_excludes(shape, case):
    """Each excluded case alone keeps the layer's own path."""
    x, w = _routed_input(shape)
    k, s = {"k5": (5, 1), "stride2": (3, 2)}.get(case, (3, 1))
    if case == "k5":
        w = torch.zeros((*w.shape[:2], 5, 5, 5))
    elif case == "bf16_x":
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
        assert not cf.routes(arg, w, k, s)


@pytest.mark.parametrize("shape", [(32, 32, (16, 16, 16)),
                                   (64, 64, (16, 16, 16)),
                                   (64, 64, (8, 8, 8)),
                                   (16, 16, (64, 64, 60)),
                                   (16, 32, (64, 64, 64)),
                                   (48, 64, (8, 8, 8))])
def test_route_excludes_shapes_outside_the_table(shape):
    """Channels or volumes the table does not hold (the analysis tails'
    volumes, the 64-channel and hyper layers, c3p_cw's slice nets) keep
    cuDNN."""
    assert shape not in cf.SHAPES
    x, w = _routed_input(shape)
    with torch.no_grad():
        assert not cf.routes(OnCard(x), w, 3, 1)


def test_table_is_the_routed_synthesis_tails():
    """Every routed shape is instantiated, and the table holds c3p's
    synthesis tails at the cells' 64³ blocks."""
    assert {(cin, cout) for cin, cout, _ in cf.SHAPES} <= cf.INSTANCES
    assert {(16, 16, (64, 64, 64)), (32, 32, (32, 32, 32))} <= cf.SHAPES


@pytest.mark.parametrize("pair", PAIRS + [(3, 8)])
def test_pack_weights(pair):
    cin, cout = pair
    _, w, _ = _operands(cin, cout, seed=3)
    table = cf.pack_weights(w)
    assert table.shape == (cin, 27, cout) and table.is_contiguous()
    for c in range(cin):
        for a in range(3):
            for b in range(3):
                for e in range(3):
                    assert torch.equal(table[c, 9 * a + 3 * b + e],
                                       w[:, c, a, b, e])


def _reference(x, w, b):
    """``F.conv3d`` (SAME, stride 1) in float64, and the same of |x|, |w|:
    the size of the sum each output is."""
    def conv(a, wk, bias):
        return F.conv3d(F.pad(a, (1, 1) * 3), wk, bias)

    return (conv(x.double(), w.double(), b.double()),
            conv(x.double().abs(), w.double().abs(), None)
            + b.double().abs().view(1, -1, 1, 1, 1))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("size", PLAIN_SIZES)
@pytest.mark.parametrize("pair", PAIRS)
def test_plain_version_matches_conv3d(pair, size, relu):
    """The plain version (the kernel's loop order) is the layer: within f32
    rounding of the size of each output's sum, then the ReLU."""
    cin, cout = pair
    x, w, b = _operands(cin, cout, size=size, seed=1)
    got = cf.conv3d_plain(x, cf.pack_weights(w), b, relu)
    want, size_of_sum = _reference(x, w, b)
    if relu:
        want = F.relu(want)
    assert got.shape == want.shape == (2, cout, *size)
    assert got.dtype == torch.float32
    assert ((got.double() - want).abs() <= 1e-5 * size_of_sum).all()
    if relu:
        assert (got >= 0).all() and (got == 0).any()


def test_plain_version_without_bias():
    x, w, _ = _operands(16, 16, seed=2)
    got = cf.conv3d_plain(x, cf.pack_weights(w))
    want, size_of_sum = _reference(x, w, torch.zeros(16))
    assert ((got.double() - want).abs() <= 1e-5 * size_of_sum).all()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, w, b = _operands(32, 32)
    table = cf.pack_weights(w)
    for relu in (False, True):
        assert torch.equal(cf.conv3d(x, table, b, relu),
                           cf.conv3d_plain(x, table, b, relu))


@pytest.fixture
def on_card(monkeypatch):
    """``routes`` reading CPU tensors as on a card, the table widened to
    the tests' small volumes, and the wrapper's calls recorded: a layer
    then takes the wrapper, whose CPU version is the plain one."""
    calls = []
    routes, wrapper = cf.routes, cf.conv3d
    small = {(cin, cout, size) for cin, cout in PAIRS for size in SIZES}
    monkeypatch.setattr(cf, "SHAPES", cf.SHAPES | small)

    def spy(*args, **kw):
        calls.append(args)
        return wrapper(*args, **kw)

    monkeypatch.setattr(cf, "routes",
                        lambda x, w, k, s: routes(OnCard(x), w, k, s))
    monkeypatch.setattr(cf, "conv3d", spy)
    return calls


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layer_cls", [ttr.Conv, ttr.ConvTranspose])
@pytest.mark.parametrize("pair", PAIRS)
def test_layers_take_the_kernel_only_where_routed(on_card, pair, layer_cls,
                                                  relu):
    """A stride-1 k3 ``Conv`` / ``ConvTranspose`` routed without a graph
    gives the plain version's values, which are its cuDNN path's within
    f32 rounding; with a graph, in bf16 or at stride 2 it keeps its path."""
    cin, cout = pair
    size = SIZES[1]
    x, w, b = _operands(cin, cout, size=size, seed=4)
    layer = layer_cls(cin, cout, 3, 1)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        got = layer(x, relu=relu)
    assert len(on_card) == 1
    assert torch.equal(got, cf.conv3d_plain(x, cf.pack_weights(w), b, relu))
    old = layer(x, relu=relu)  # a graph: cuDNN's forward (oneDNN here)
    assert len(on_card) == 1 and old.requires_grad
    want, size_of_sum = _reference(x, w, b)
    if relu:
        want = F.relu(want)
    assert ((got.double() - want).abs() <= 1e-5 * size_of_sum).all()
    assert ((old.detach().double() - want).abs()
            <= 1e-5 * size_of_sum).all()
    with torch.no_grad():
        layer(x, dtype=torch.bfloat16, relu=relu)
        layer_cls(cin, cout, 3, 2)(x, relu=relu)
    assert len(on_card) == 1


@pytest.mark.parametrize("synthesis", [False, True])
def test_blocks_route_their_stride_1_layers(on_card, synthesis):
    """A residual block runs its two stride-1 layers on the route, with the
    ReLU inside; its output equals the block's own path's within f32
    rounding of the layers' sums."""
    cin, f = 8, 16
    block = (ttr.SynthesisBlock if synthesis else ttr.AnalysisBlock)(cin, f)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / 6)
    # the stride-2 layer makes the stride-1 layers' volume SIZES[0]
    x = torch.randn((2, cin, 2, 2, 4) if synthesis else (2, cin, 8, 8, 16),
                    generator=g)
    with torch.no_grad():
        got = block(x)
    assert len(on_card) == 2
    assert all(call[3] is True for call in on_card)  # the fused ReLU
    want = block(x)  # a graph: every layer on its own path
    assert len(on_card) == 2
    want = want.detach()
    assert (got - want).abs().max() <= 1e-5 * float(want.abs().max())


def test_layer_packs_its_table_once_a_weight_version(on_card):
    x, w, b = _operands(16, 16, size=SIZES[0])
    layer = ttr.Conv(16, 16)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer(x)
        table = layer._packed("_fwd", layer.weight, cf.pack_weights)
        layer(x)
        assert layer._packed("_fwd", layer.weight, cf.pack_weights) is table
        layer.weight.mul_(2)  # a write: packed anew
        again = layer._packed("_fwd", layer.weight, cf.pack_weights)
    assert again is not table
    assert torch.equal(again, 2 * table)


def test_source_instantiates_the_pairs():
    """``INSTANCES`` are the source's ``PCC_CONV_FWD_SHAPES`` instances."""
    text = SOURCE.read_text()
    body = text[text.index("#define PCC_CONV_FWD_SHAPES"):]
    body = body[:body.index("\n\n")]
    got = {tuple(int(v) for v in m.split(",")[:2])
           for m in re.findall(r"X\(([^)]*)\)", body)}
    assert got == cf.INSTANCES


def test_kernels_entry_and_argtypes():
    """The registry entry and its argtypes against the C signature: a
    pointer where the source has one, an int where it has an int."""
    src, fns = kernels.KERNELS["conv_fwd"]
    assert src == SOURCE.name
    p, i = kernels._P, kernels._I
    assert fns == {"pcc_conv_fwd": [p] * 4 + [i] * 7 + [p]}
    text = SOURCE.read_text()
    for fn, argtypes in fns.items():
        sig = re.search(rf"int {fn}\(([^)]*)\)", text).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == len(argtypes), fn
        for param, t in zip(params, argtypes):
            assert ("*" in param) == (t is p), (fn, param)
    assert "conv_fwd" in kernels.launches
    # one fixed summation order: no atomic operation
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", text)
    assert "Replaces no Pallas TPU kernel" in text
    assert "torch/" not in text and "ATen" not in text  # builds in seconds
    assert 'extern "C"' in text


def test_kernel_name_is_in_the_convolution_family():
    """The benchmark counts the kernel's device time as convolution time
    (``conv_roofline.*`` divides every layer's work by it): the name holds
    ``convolve`` and no other family's key."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from benchlib.tracing import family

    text = SOURCE.read_text()
    names = re.findall(r"^(\w+)\(const __grid_constant__", text, re.M)
    assert names == ["conv_fwd_convolve"]
    assert text.count("__global__") == 1
    assert not any(k in names[0] for k in ("tail_kernel", "copy", "fill",
                                           "sort"))
    assert family(names[0]) == "convolution"
    assert family(f"void (anonymous namespace)::{names[0]}<16, 16, 8, 4, "
                  f"32, 4, 2>(CUtensorMap, float const*)") == "convolution"


# -- on a card: python -m pytest tests/test_torch_conv_fwd.py -m card ------


@pytest.fixture
def card():
    """The card, under the codec's convolution flags; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs

    deterministic_convs()
    return torch.device("cuda")


def _card_operands(shape, n, device, seed):
    cin, cout, volume = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.relu(torch.randn((n, cin, *volume), generator=g,
                               device=device))
    w = torch.randn((cout, cin, 3, 3, 3), generator=g,
                    device=device) / (27 * cin) ** 0.5
    return x, w, torch.randn((cout,), generator=g, device=device)


@pytest.mark.card
@pytest.mark.parametrize("shape", ROUTED)
def test_card_kernel_is_cudnn_bit_for_bit(card, shape):
    """The kernel against ``F.conv3d`` of the padded input (the layer's
    cuDNN path), with the bias, and with the ReLU after it."""
    x, w, b = _card_operands(shape, 16, card, seed=25)
    table = cf.pack_weights(w)
    with torch.no_grad():
        assert cf.routes(x, w, 3, 1)
        want = F.conv3d(F.pad(x, (1, 1) * 3), w, b)
        got = cf.conv3d(x, table, b)
        assert torch.equal(got, want), float((got - want).abs().max())
        assert torch.equal(cf.conv3d(x, table, b, relu=True), F.relu(want))
        assert torch.equal(cf.conv3d(x, table), F.conv3d(
            F.pad(x, (1, 1) * 3), w))


@pytest.mark.card
@pytest.mark.parametrize("shape", ROUTED)
def test_card_kernel_is_batch_invariant(card, shape):
    """A block's output alone, and moved to another place in the batch,
    equals its output inside a 128-block call."""
    x, w, b = _card_operands(shape, 128, card, seed=26)
    table = cf.pack_weights(w)
    with torch.no_grad():
        whole = cf.conv3d(x, table, b, relu=True)
        for i in (0, 37, 127):
            assert torch.equal(cf.conv3d(x[i:i + 1], table, b, relu=True),
                               whole[i:i + 1]), i
        rolled = cf.conv3d(torch.roll(x, 5, 0).contiguous(), table, b,
                           relu=True)
        assert torch.equal(rolled, torch.roll(whole, 5, 0))


@pytest.mark.card
def test_card_decode_y_chunk_launches(card):
    """c3p's ``decode_y`` of a chunk launches the kernel once a routed
    layer: 16 → 16 at 64³ twice, 32 → 32 at 32³ twice; a training forward
    none, and the analysis none."""
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model

    model = build_model("c3p").to(card)
    routed = [m for m in model.synthesis_t.modules()
              if isinstance(m, ttr.ConvTranspose) and m.k == 3 and m.s == 1
              and m.weight.shape[0] > 1]
    assert len(routed) == 6  # 64 → 64 at 16³ stays on cuDNN
    kernels.reset_launches()
    model.decode_y(torch.zeros((4, 8, 8, 8, 64), dtype=torch.int32,
                               device=card))
    torch.cuda.synchronize()
    assert kernels.launches["conv_fwd"] == 4
    kernels.reset_launches()
    model.synthesis_t(torch.zeros((2, 64, 8, 8, 8), device=card))
    assert kernels.launches["conv_fwd"] == 0
    # the analysis tails run channels-last (cuDNN keeps the layout of the
    # one-channel input), so an encode launches the kernel only in the
    # decoder-canonical x_hat
    kernels.reset_launches()
    model.encode_syms(torch.zeros((4, 64, 64, 64, 1), device=card))
    assert kernels.launches["conv_fwd"] == 0
