"""The port's report modules against the JAX package's, on the CPU.

- ``utils/bd.py``: BD-PSNR and BD-rate, PCHIP and polynomial, equal to
  JAX's within 1e-12 on seeded RD curves, with duplicated pairs, unsorted
  rates and partial overlap; the same refusals.
- ``utils/mpeg_parsing.py``: equal dicts on tmc3 encoder / decoder logs and
  pc_error logs (D1 only, D1 + D2, with colour) written here.
- ``cli/pc_error.py``: standard output equal line for line to JAX
  ``cli/pc_error.py``'s on two small PLY files, with and without
  ``--inputNorm``, and read back by the port's ``parse_pcerror``.
"""

import numpy as np
import pytest

from pcc_geo_cnn_v2_tpu.cli import pc_error as jax_pc_error
from pcc_geo_cnn_v2_tpu.utils import bd as jax_bd
from pcc_geo_cnn_v2_tpu.utils import mpeg_parsing as jax_mp
from pcc_geo_cnn_v2_tpu_torch.cli import pc_error
from pcc_geo_cnn_v2_tpu_torch.utils import bd, mpeg_parsing, pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics

TOL = 1e-12


def _curve(rng, n, lo, hi, offset):
    """A concave, increasing RD curve of ``n`` points on rates about
    [lo, hi]."""
    rate = np.sort(np.geomspace(lo, hi, n) * rng.uniform(0.97, 1.03, n))
    psnr = 60 + offset + 8 * np.log(rate) + rng.normal(0, 0.05, n)
    return [(float(r), float(p)) for r, p in zip(rate, psnr)]


def _curves(seed, kind):
    rng = np.random.default_rng(seed)
    a = _curve(rng, 5, 0.1, 1.0, 0.0)
    b = _curve(rng, 5, 0.1, 1.0, 0.7)
    if kind == "duplicated":  # an exact pair twice: deduplicated
        a, b = a + a[1:3], b + [b[0]]
    elif kind == "unsorted":
        a, b = a[::-1], [b[i] for i in rng.permutation(len(b))]
    elif kind == "partial":  # the curves overlap on part of their ranges
        b = _curve(rng, 6, 0.3, 2.0, 0.7)
    return a, b


@pytest.mark.parametrize("pchip", [True, False])
@pytest.mark.parametrize("kind", ["plain", "duplicated", "unsorted",
                                  "partial"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bd_equals_jax(seed, kind, pchip):
    a, b = _curves(seed, kind)
    for fn in ("bdsnr", "bdrate"):
        for x, y in ((a, b), (b, a)):
            got = getattr(bd, fn)(x, y, pchip=pchip)
            want = getattr(jax_bd, fn)(x, y, pchip=pchip)
            assert np.isfinite(got) and abs(got - want) <= TOL, (fn, got,
                                                                  want)
    # b is better: positive BD-PSNR, negative BD-rate
    assert bd.bdsnr(a, b, pchip=pchip) > 0 > bd.bdrate(a, b, pchip=pchip)


@pytest.mark.parametrize("a, b, words", [
    ([(0.1, 60.0), (0.1, 60.0)], [(0.1, 61.0), (0.5, 65.0)], ">=2 distinct"),
    ([(0.1, 60.0), (0.2, 62.0)], [(0.5, 65.0), (0.9, 68.0)],
     "no overlapping"),
])
@pytest.mark.parametrize("pchip", [True, False])
def test_bd_refusals_equal_jax(a, b, words, pchip):
    for mod in (bd, jax_bd):
        with pytest.raises(ValueError, match=words):
            mod.bdsnr(a, b, pchip=pchip)


TMC3_ENC_LOG = """\
uncompressedDataPath  : "loot_vox10_1200.ply"
Slice origin: 0 0 0
positions bitstream size 1234 B (2.5 bpp)
colors bitstream size 55 B (0.11 bpp)
Processing time (user): 1.23 s
Total bitstream size 1289 B
"""

TMC3_DEC_LOG = """\
uncompressedDataPath  : "loot_vox10_1200_dec.ply"
positions bitstream size 1234 B
colors bitstream size 55.0 B
Processing time (user): 0.51 s
"""

PCERROR_D1 = """\
1. Use infile1 (A) as reference:
   mse1      (p2point): 0.5
   mse1,PSNR (p2point): 60.1
3. Final (symmetric).
   mseF      (p2point): 0.6
   mseF,PSNR (p2point): 59.5
"""

PCERROR_D2 = PCERROR_D1 + """\
   mseF      (p2plane): 0.25
   mseF,PSNR (p2plane): 63.25
"""

PCERROR_COLOR = PCERROR_D2 + """\
   c[0],    F         : 11.5
   c[1],    F         : 3.25
   c[2],    F         : 4.5
   c[0],PSNRF         : 37.5
   c[1],PSNRF         : 43.0
   c[2],PSNRF         : 41.75
"""


@pytest.mark.parametrize("parser, text, keys", [
    ("parse_bin_log", TMC3_ENC_LOG, 5),
    ("parse_decoded_log", TMC3_DEC_LOG, 3),
    ("parse_pcerror", PCERROR_D1, 2),
    ("parse_pcerror", PCERROR_D2, 4),
    ("parse_pcerror", PCERROR_COLOR, 10),
])
def test_mpeg_parsing_equals_jax(tmp_path, parser, text, keys):
    path = tmp_path / "log.txt"
    path.write_text(text)
    got = getattr(mpeg_parsing, parser)(path)
    want = getattr(jax_mp, parser)(path)
    assert got == want and len(got) == keys
    assert {type(v) for v in got.values()} == {type(v) for v in
                                               want.values()}


def test_mpeg_parsing_refuses_what_jax_refuses(tmp_path):
    path = tmp_path / "log.txt"
    path.write_text("nothing to see\n")
    for mod in (mpeg_parsing, jax_mp):
        with pytest.raises(ValueError, match="pattern not found"):
            mod.parse_pcerror(path)
        with pytest.raises(ValueError, match="pattern not found"):
            mod.parse_bin_log(path)


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    """Two small PLY clouds and the first's normals."""
    tmp = tmp_path_factory.mktemp("pc_error")
    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(0, 64, (400, 3)), axis=0).astype(np.float64)
    b = np.clip(a[::2] + rng.integers(-1, 2, (len(a[::2]), 3)), 0, 63)
    b = np.unique(b, axis=0)
    n = rng.normal(size=(len(a), 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    paths = {k: str(tmp / f"{k}.ply") for k in ("a", "b", "a_n")}
    pc_io.write_ply(paths["a"], a)
    pc_io.write_ply(paths["b"], b)
    pc_io.write_ply(paths["a_n"], np.hstack([a, n]),
                    names=("x", "y", "z", "nx", "ny", "nz"))
    return paths, a, b, n


@pytest.mark.parametrize("with_normals", [False, True])
def test_pc_error_prints_what_jax_prints(clouds, capsys, tmp_path,
                                         with_normals):
    paths, a, b, n = clouds
    argv = ["--fileA", paths["a"], "--fileB", paths["b"],
            "--resolution", "63"]
    if with_normals:
        argv += ["--inputNorm", paths["a_n"]]
    jax_pc_error.main(argv)
    want = capsys.readouterr().out
    pc_error.main(argv)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 7

    log = tmp_path / "pc_error.log"
    log.write_text(got)
    parsed = mpeg_parsing.parse_pcerror(log)
    # the files hold the normals in f32
    n = pc_io.read_ply(paths["a_n"], columns=["nx", "ny", "nz"])[0]
    m = compute_metrics(a, b, 63.0, p1_n=n if with_normals else None)
    assert parsed["d1_mse"] == float(m["d1_mse"])
    assert parsed["d1_psnr"] == float(m["d1_psnr"])
    if with_normals:
        assert parsed["d2_mse"] == float(m["d2_mse"])
        assert parsed["d2_psnr"] == float(m["d2_psnr"])
    else:
        assert parsed["d2_mse"] == parsed["d2_psnr"] == 0.0
