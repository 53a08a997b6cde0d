"""The port's RD tools (``python -m pcc_geo_cnn_v2_tpu_torch.tools.<name>``):
the JAX package's ``tools/rd_*`` scripts and their helpers, with the JAX
argv plus ``--device``. They write under ``results_torch/`` and
``models/``, never into the committed ``results/`` or
``pcc_geo_cnn_v2_tpu/`` (``paths.writable``)."""
