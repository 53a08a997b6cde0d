"""Shared cases of the harness tests."""

# a CPU-sized cell: two small figures, 16³ blocks, 32 thresholds, training
# batches of 4
TINY = {"config": {"block_size": 16, "batch_blocks": 8, "n_thresholds": 32},
        "mix": {"clouds": {"generator": "figure_cloud",
                           "figure_seeds": [5, 6], "resolution": 64,
                           "density": 1.0, "normals": False, "level": 2},
                "clients": 2, "check": {"samples": 2}, "batch": 4}}
