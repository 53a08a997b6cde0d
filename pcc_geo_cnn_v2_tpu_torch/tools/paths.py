"""Where the RD tools read and write.

The JAX tools write their results into the committed ``results/`` and
their exported weights into ``pcc_geo_cnn_v2_tpu/assets/rd``. The port's
keep the JAX file names under ``results_torch/`` (gitignored) and export
to ``models/rd_assets/`` (gitignored); :func:`writable` refuses a path
inside either committed tree. The committed assets are read only.
"""

from __future__ import annotations

from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the committed RD weights, one directory a run id (read only)
ASSET_ROOT = REPO / "pcc_geo_cnn_v2_tpu/assets/rd"
# the port's results root, relative to the working directory as the JAX
# tools' ``results/``
RESULTS_ROOT = Path("results_torch")
EXPORT_ROOT = Path("models/rd_assets")
COMMITTED = (REPO / "results", REPO / "pcc_geo_cnn_v2_tpu")


def writable(path):
    """``path`` as a ``Path``; raises ``ValueError`` when it lies inside a
    committed tree of the JAX package (its results or its package)."""
    path = Path(path)
    full = path.resolve()
    for root in COMMITTED:
        if full == root or root in full.parents:
            raise ValueError(f"{path}: the port's tools do not write into "
                             f"{root.relative_to(REPO)}/ (committed)")
    return path

