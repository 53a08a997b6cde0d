"""Parallel execution over a ``torch.distributed`` process group
(:mod:`.mesh`): data-parallel training (the "dp" axis) and depth-sharded
oversized blocks with halo exchange (:mod:`.spatial`, the "sp" axis). The
chunk round-robin of inference is ``codec.BlockCodec(devices=...)``."""
