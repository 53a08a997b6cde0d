"""Parsers for external MPEG tool logs: tmc3 (G-PCC) and pc_error_d.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/mpeg_parsing.py``. The
formats are the external C++ binaries' (the ones the reference drives; see
its ``src/utils/mpeg_parsing.py``), and the keys are the reference's, so
report and compare tooling reads either package's output.
"""

from __future__ import annotations

import re

__all__ = ["parse_bin_log", "parse_decoded_log", "parse_pcerror"]


def _grab(pattern, s, cast=str):
    m = re.search(pattern, s, re.MULTILINE)
    if m is None:
        raise ValueError(f"pattern not found: {pattern}")
    return cast(m.group(1))


def parse_bin_log(path):
    """tmc3 encoder log → bitstream sizes and bpp."""
    with open(path) as f:
        s = f.read()
    return {
        "pos_bitstream_size_in_bytes": _grab(
            r"positions bitstream size (\d+) B", s, int),
        "pos_bits_per_output_point": _grab(
            r"positions bitstream size \d+ B \(([\d.]+) bpp\)", s, float),
        "color_bitstream_size_in_bytes": _grab(
            r"colors bitstream size (\d+) B", s, int),
        "color_bits_per_output_point": _grab(
            r"colors bitstream size \d+ B \(([\d.]+) bpp\)", s, float),
        "uncompressed_data_path": _grab(
            r'uncompressedDataPath  : "(.*)"', s),
    }


def parse_decoded_log(path):
    """tmc3 decoder log → bitstream sizes."""
    with open(path) as f:
        s = f.read()
    return {
        "pos_bitstream_size_in_bytes": _grab(
            r"positions bitstream.*?([\d.]+)", s, lambda x: int(float(x))),
        "color_bitstream_size_in_bytes": _grab(
            r"colors bitstream.*?([\d.]+)", s, lambda x: int(float(x))),
        "uncompressed_data_path": _grab(
            r'uncompressedDataPath  : "(.*)"', s),
    }


def parse_pcerror(path):
    """pc_error_d log → symmetric D1/D2 (and color, when present) metrics."""
    with open(path) as f:
        s = f.read()
    out = {
        "d1_mse": _grab(r"mseF      \(p2point\): (.+)", s, float),
        "d1_psnr": _grab(r"mseF,PSNR \(p2point\): (.+)", s, float),
    }
    try:
        out.update({
            "d2_mse": _grab(r"mseF      \(p2plane\): (.+)", s, float),
            "d2_psnr": _grab(r"mseF,PSNR \(p2plane\): (.+)", s, float),
        })
    except ValueError:
        pass  # no normals → geometry D1 only
    try:
        out.update({
            "y_mse": _grab(r"c\[0\],    F         : (.+)", s, float),
            "u_mse": _grab(r"c\[1\],    F         : (.+)", s, float),
            "v_mse": _grab(r"c\[2\],    F         : (.+)", s, float),
            "y_psnr": _grab(r"c\[0\],PSNRF         : (.+)", s, float),
            "u_psnr": _grab(r"c\[1\],PSNRF         : (.+)", s, float),
            "v_psnr": _grab(r"c\[2\],PSNRF         : (.+)", s, float),
        })
    except ValueError:
        pass  # geometry-only run
    return out
